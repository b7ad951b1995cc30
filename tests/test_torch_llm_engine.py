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


def test_engine_serves_through_fixed_programs_on_device_state():
    """The engine's programs: one decode block per length, one prefill per
    bucket. Its slot state is device tensors (next token, position,
    temperature, seed, count), updated in place (the captured graphs hold
    those tensors); on the CPU nothing is replayed."""
    _, tcfg, _, tp = _tiny_fp32()
    eng = LLMEngine(tp, tcfg, max_slots=2, max_len=64,
                    prefill_buckets=(16, 32), device="cpu")
    try:
        assert set(eng._programs) == {("decode", 2), ("decode", 8),
                                      ("prefill", 16), ("prefill", 32)}
        state = (eng.tok, eng.pos, eng.temps, eng.seeds, eng.counts)
        assert [t.dtype for t in state] == [torch.long, torch.long,
                                            torch.float32, torch.long,
                                            torch.long]
        assert not any(t.any() for t in state)  # reset after the warm-up
        out = eng.generate(np.arange(1, 9), max_new_tokens=5,
                           temperature=0.5, seed=3)
        assert len(out) == 5
        assert all(a is b for a, b in zip(state, (eng.tok, eng.pos,
                                                  eng.temps, eng.seeds,
                                                  eng.counts)))
        assert eng.stats()["graph_replays"] == 0
        assert eng.stats()["steps"] > 0
    finally:
        eng.shutdown()


def test_prefill_program_writes_the_slot_state():
    """The prefill-insert program samples the first token on the device and
    writes token, position, temperature, seed and count at its slot only."""
    from ray_tpu_torch.models import generation as tgen
    from ray_tpu_torch.serve import llm

    _, tcfg, _, tp = _tiny_fp32()
    cache = tgen.init_kv_cache(tcfg, 3, 64, device="cpu")
    tok, pos, seeds, counts = (torch.full((3,), 9) for _ in range(4))
    temps = torch.full((3,), 0.25)
    prompt = np.arange(1, 7)
    args = torch.zeros(16 + 3, dtype=torch.long)
    args[:6] = torch.from_numpy(prompt)
    args[16:] = torch.tensor([6, 1, 42])  # length, slot, seed
    llm._prefill_program(tp, args, torch.zeros(1), cache, tok, pos, temps,
                         seeds, counts, tcfg)
    logits = ttf.forward(tp, torch.from_numpy(prompt)[None], tcfg)[0, -1]
    assert tok.tolist() == [9, int(torch.argmax(logits)), 9]
    assert pos.tolist() == [9, 6, 9] and counts.tolist() == [9, 1, 9]
    assert seeds.tolist() == [9, 42, 9] and temps.tolist() == [0.25, 0.0, 0.25]


def test_cpu_host_copy_is_a_snapshot():
    """A program's static output is overwritten by its next run: on the CPU
    the host copy must be a clone taken at once."""
    from ray_tpu_torch.serve import llm

    t = torch.arange(4)
    host, done = llm._to_host_async(t)
    t.add_(10)
    assert done is None and llm._host_values(host, done).tolist() == [0, 1,
                                                                      2, 3]


def test_cuda_engine_never_falls_back_to_eager_programs(monkeypatch):
    """On CUDA the programs only ever run as captured graphs: a capture
    that fails raises out of ``_warm_blocks`` (so out of the constructor)
    with no eager run in its place, and a program with no graph raises
    rather than running eagerly. The CPU has no card, so an engine built on
    the CPU is pointed at a CUDA device descriptor after construction."""
    _, tcfg, _, tp = _tiny_fp32()
    eng = LLMEngine(tp, tcfg, max_slots=2, max_len=64,
                    prefill_buckets=(16,), device="cpu")
    try:
        ran = []
        for key in eng._programs:
            eng._programs[key] = lambda key=key: ran.append(key)

        def failed_capture():
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

        monkeypatch.setattr(eng, "_capture_graphs", failed_capture)
        eng.device = torch.device("cuda", 0)
        with pytest.raises(RuntimeError, match="capturing"):
            eng._warm_blocks()
        with pytest.raises(KeyError):
            eng._run(("decode", 8))
        assert ran == []
    finally:
        eng.device = torch.device("cpu")
        eng.shutdown()
