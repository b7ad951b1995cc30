"""The port's continuous-batching engine (ray_tpu_torch/serve/llm.py) on the
CPU, held against JAX's ``generate`` as tests/test_serve_llm.py holds the JAX
engine: interleaved greedy requests must produce EQUAL tokens (float32, the
same arithmetic)."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer


def _tiny_fp32():
    jcfg = dataclasses.replace(jtf.TransformerConfig.tiny(),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(ttf.TransformerConfig.tiny(),
                               dtype=torch.float32)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def _run_concurrently(eng, prompts, **kw):
    res = [None] * len(prompts)

    def run(i):
        res[i] = eng.generate(prompts[i], **kw)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return res


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_engine_matches_jax_generate(pipeline):
    jcfg, tcfg, jp, tp = _tiny_fp32()
    prompts = [
        np.arange(1, 9, dtype=np.int32),
        (np.arange(3, 15, dtype=np.int32) % jcfg.vocab_size).astype(np.int32),
        np.full(5, 7, np.int32),
    ]
    ref = [np.asarray(jgen.generate(jp, jnp.asarray(p[None]), jcfg,
                                    max_new_tokens=10, max_len=64))[0]
           for p in prompts]
    eng = LLMEngine(tp, tcfg, max_slots=2, max_len=64,
                    prefill_buckets=(16, 32), pipeline=pipeline,
                    device="cpu")
    try:
        res = _run_concurrently(eng, prompts, max_new_tokens=10)
        for i in range(len(prompts)):
            assert res[i] == ref[i].tolist(), (i, res[i], ref[i].tolist())
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()


def test_engine_mid_decode_admission():
    """A request arriving mid-decode gets its first token while the running
    request is still decoding (as tests/test_serve_llm.py:82)."""
    _, tcfg, _, tp = _tiny_fp32()
    eng = LLMEngine(tp, tcfg, max_slots=4, max_len=128,
                    prefill_buckets=(16,), device="cpu")
    try:
        a = eng.submit(np.arange(1, 9), max_new_tokens=100)
        for _ in range(500):
            if a.produced >= 5:
                break
            time.sleep(0.01)
        assert a.produced >= 5
        t0 = time.monotonic()
        first_b = next(eng.generate_stream(np.arange(2, 8), max_new_tokens=4))
        ttft_b = time.monotonic() - t0
        assert isinstance(first_b, int)
        assert a.produced < 100, "A finished before B started: no overlap"
        assert ttft_b < 5.0, ttft_b
    finally:
        eng.shutdown()


def test_engine_failure_unblocks_consumers():
    """A device error inside the engine loop must fail live streams, not
    hang them (as tests/test_serve_llm.py:231)."""
    _, tcfg, _, tp = _tiny_fp32()
    eng = LLMEngine(tp, tcfg, max_slots=2, max_len=64,
                    prefill_buckets=(16,), device="cpu")
    eng._dispatch_block = lambda: (_ for _ in ()).throw(
        RuntimeError("device fell over")
    )
    with pytest.raises(RuntimeError, match="device fell over|not running"):
        list(eng.generate_stream(np.arange(4), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="not running"):
        eng.submit(np.arange(4), max_new_tokens=2)


def test_engine_sampling_is_seeded_and_validates_requests():
    _, tcfg, _, tp = _tiny_fp32()
    eng = LLMEngine(tp, tcfg, max_slots=2, max_len=32,
                    prefill_buckets=(8,), device="cpu")
    try:
        kw = dict(max_new_tokens=6, temperature=1.0, seed=11)
        a = eng.generate(np.arange(1, 5), **kw)
        b = eng.generate(np.arange(1, 5), **kw)
        assert a == b and len(a) == 6
        assert all(0 <= t < tcfg.vocab_size for t in a)
        with pytest.raises(ValueError, match="exceeds engine max_len"):
            eng.submit(np.arange(30), max_new_tokens=8)
        with pytest.raises(ValueError, match="largest prefill bucket"):
            eng.submit(np.arange(12), max_new_tokens=2)
        assert eng.stats()["steps"] > 0
    finally:
        eng.shutdown()


def test_llm_server_streams_and_blocks_alike():
    _, tcfg, _, tp = _tiny_fp32()
    srv = LLMServer(lambda: (tp, tcfg), max_slots=2, max_len=64,
                    prefill_buckets=(16,), device="cpu")
    try:
        prompt = list(range(1, 9))
        toks = list(srv.stream(prompt, 8))
        assert len(toks) == 8
        assert srv(prompt, 8) == toks
    finally:
        srv.engine.shutdown()


def test_host_copy_event_is_recorded_on_the_tensors_device(monkeypatch):
    """``_to_host_async`` records its event on the current stream of the
    tensor's own device, not of the current device: with
    ``LLMEngine(device="cuda:1")`` the engine thread's current device stays
    cuda:0, and an event there would not cover the copy. The CPU has no
    second card, so torch.cuda is patched: the event must be recorded on
    cuda:1's stream."""
    from ray_tpu_torch.serve import llm

    recorded = []

    class FakeEvent:
        def record(self, stream=None):
            recorded.append(stream)

    class OnCuda1:
        device = torch.device("cuda", 1)

        def to(self, where, non_blocking=False):
            assert where == "cpu" and non_blocking
            return torch.zeros(2)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    host, done = llm._to_host_async(OnCuda1())
    assert isinstance(done, FakeEvent) and host.shape == (2,)
    assert recorded == [("stream of", torch.device("cuda", 1))]
