"""Parity of the port's KV-cached generation (ray_tpu_torch/models/
generation.py) with the JAX reference, on the CPU.

The ``tiny`` config in float32; JAX initializes the weights, which cross as
numpy arrays. Greedy tokens must be EQUAL (the same arithmetic in fp32).
Logits: atol 1e-4; cache contents: atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import generation as tgen
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy


def _setup(max_seq_len=64, **kw):
    jcfg = dataclasses.replace(jtf.TransformerConfig.tiny(
        max_seq_len=max_seq_len), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(ttf.TransformerConfig.tiny(
        max_seq_len=max_seq_len), dtype=torch.float32, **kw)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_generate_greedy_matches_jax(n_kv_heads):
    jcfg, tcfg, jp, tp = _setup(n_kv_heads=n_kv_heads)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ref = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6)
    out = tgen.generate(tp, prompt, tcfg, max_new_tokens=6, device="cpu")
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_kv_cache_generation_matches_full_forward():
    """Greedy decode through the KV cache matches recomputing the full
    forward pass every step (as tests/test_model.py:233)."""
    _, tcfg, _, tp = _setup()
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)))
    out = tgen.generate(tp, prompt, tcfg, max_new_tokens=6, device="cpu")
    toks, ref = prompt, []
    for _ in range(6):
        nxt = torch.argmax(ttf.forward(tp, toks, tcfg)[:, -1], dim=-1)
        ref.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert torch.equal(out, torch.stack(ref, dim=1))


def _prefilled(gen, params, cfg, prompt, slot, to_dev):
    """prefill_into_slot of one prompt into a 2-slot cache, garbage in it
    first so the whole-row rewrite shows."""
    n = len(prompt)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :n] = prompt
    cache = gen.init_kv_cache(cfg, 2, 32, **to_dev["kw"])
    cache = {k: v + 3 for k, v in cache.items()}
    scalar = to_dev["scalar"]
    return gen.prefill_into_slot(params, to_dev["arr"](padded), scalar(n),
                                 scalar(slot), cache, cfg)


# prompt_len and slot as device scalars, as the engines pass them
JAX_DEV = {"kw": {}, "arr": jnp.asarray, "scalar": jnp.int32}
TORCH_DEV = {"kw": {"device": "cpu"}, "arr": torch.from_numpy,
             "scalar": torch.tensor}


def _slot_state(temps, seeds, counts):
    """Per-slot sampling state as the engine keeps it: device tensors."""
    return (torch.tensor(temps, dtype=torch.float32), torch.tensor(seeds),
            torch.tensor(counts))


def test_prefill_into_slot_matches_jax():
    jcfg, tcfg, jp, tp = _setup()
    prompt = np.arange(1, 9, dtype=np.int32)
    jlog, jcache = _prefilled(jgen, jp, jcfg, prompt, 1, JAX_DEV)
    tlog, tcache = _prefilled(tgen, tp, tcfg, prompt, 1, TORCH_DEV)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
        # the whole slot row is rewritten: zeros past the 16-token bucket,
        # the other slot untouched
        assert not tcache[key][:, 1, 16:].any()
        assert bool((tcache[key][:, 0] == 3).all())


def test_decode_block_matches_jax():
    jcfg, tcfg, jp, tp = _setup()
    prompt = np.arange(1, 9, dtype=np.int32)
    jlog, jcache = _prefilled(jgen, jp, jcfg, prompt, 0, JAX_DEV)
    tlog, tcache = _prefilled(tgen, tp, tcfg, prompt, 0, TORCH_DEV)
    first = int(jnp.argmax(jlog))
    assert int(torch.argmax(tlog)) == first
    zeros = np.zeros(2, np.float32)
    izeros = np.zeros(2, np.int32)
    jtoks, jcache, *_ = jgen.decode_block(
        jp, jcache, jnp.array([first, 0], jnp.int32),
        jnp.array([8, 0], jnp.int32), jnp.asarray(zeros),
        jnp.asarray(izeros), jnp.asarray(izeros), jcfg, 5)
    ttoks, tcache, tok, pos, counts = tgen.decode_block(
        tp, tcache, torch.tensor([first, 0]), torch.tensor([8, 0]),
        *_slot_state(zeros, izeros, izeros), tcfg, 5)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert pos.tolist() == [13, 5] and counts.tolist() == [5, 5]
    assert torch.equal(tok, ttoks[:, -1])
    # the active slot's cache rows match; (slot 1 decoded garbage rows)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, 0].numpy(),
                                   np.asarray(jcache[key])[:, 0], atol=1e-5)


def test_decode_step_multi_matches_block():
    """The single-step primitive and the block agree (greedy)."""
    _, tcfg, _, tp = _setup()
    prompt = np.arange(1, 9, dtype=np.int32)

    def state():
        logits, cache = _prefilled(tgen, tp, tcfg, prompt, 0, TORCH_DEV)
        return (torch.tensor([int(torch.argmax(logits)), 0]),
                torch.tensor([8, 0]), cache)

    tok, pos, cache = state()
    logits, _ = tgen.decode_step_multi(tp, tok, cache, pos, tcfg)
    tok, pos, cache = state()
    toks, *_ = tgen.decode_block(tp, cache, tok, pos,
                                 *_slot_state([0.0, 0.0], [0, 0], [0, 0]),
                                 tcfg, 1)
    assert int(toks[0, 0]) == int(torch.argmax(logits[0]))


def test_decode_past_the_cache_end_stays_in_its_slot():
    """A slot decoding on past its cache (a finished request inside a
    block) must not fail or touch another slot's rows."""
    _, tcfg, _, tp = _setup()
    cache = tgen.init_kv_cache(tcfg, 2, 8, device="cpu")
    before = cache["k"][:, 0].clone()
    tgen.decode_block(tp, cache, torch.tensor([1, 2]), torch.tensor([0, 7]),
                      *_slot_state([0.0, 0.0], [0, 0], [0, 0]), tcfg, 3)
    assert torch.equal(cache["k"][:, 0, 3:], before[:, 3:])


def test_sample_vec_greedy_and_deterministic():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 256),
                                                  dtype=np.float32))
    greedy = tgen._sample_vec(logits, *_slot_state([0.0] * 4, [0] * 4,
                                                   [0] * 4))
    assert torch.equal(greedy, torch.argmax(logits, dim=-1))
    flat = torch.zeros((4, 256))
    temps, seeds = [1.0, 1.0, 1.0, 0.0], [7, 7, 8, 7]
    a = tgen._sample_vec(flat, *_slot_state(temps, seeds, [3] * 4))
    b = tgen._sample_vec(flat, *_slot_state(temps, seeds, [3] * 4))
    assert torch.equal(a, b)  # deterministic per (seed, count)
    assert int(a[0]) == int(a[1])  # same (seed, count), same draw
    assert int(a[3]) == 0  # the greedy slot
    draws = {tuple(tgen._sample_vec(flat, *_slot_state(temps, seeds,
                                                       [c] * 4)).tolist())
             for c in range(8)}
    assert len(draws) > 1  # the count moves the stream
    assert ((a >= 0) & (a < 256)).all()


def test_generation_sampling_and_bounds():
    _, tcfg, _, tp = _setup(max_seq_len=32)
    prompt = np.ones((1, 4), np.int64)
    gen = torch.Generator().manual_seed(7)
    out = tgen.generate(tp, prompt, tcfg, max_new_tokens=5, temperature=1.0,
                        generator=gen, device="cpu")
    assert out.shape == (1, 5)
    assert ((out >= 0) & (out < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgen.generate(tp, prompt, tcfg, max_new_tokens=64, device="cpu")


def test_decode_block_in_place_equals_functional():
    """``decode_block_into`` (the engine's captured form: state advanced in
    place, tokens written into a given buffer) against ``decode_block``
    (functional, state left as it was), with one greedy and one sampled
    slot: the same tokens, state and cache."""
    _, tcfg, _, tp = _setup()
    prompt = np.arange(1, 9, dtype=np.int32)
    logits, cache_a = _prefilled(tgen, tp, tcfg, prompt, 0, TORCH_DEV)
    cache_b = {k: v.clone() for k, v in cache_a.items()}
    token = torch.tensor([int(torch.argmax(logits)), 3])
    pos = torch.tensor([8, 2])
    temps, seeds, counts = _slot_state([0.0, 0.9], [0, 11], [1, 4])
    want, cache_a, tok_a, pos_a, counts_a = tgen.decode_block(
        tp, cache_a, token, pos, temps, seeds, counts, tcfg, 4)
    assert pos.tolist() == [8, 2] and counts.tolist() == [1, 4]  # unchanged
    out = torch.full((2, 4), -1)
    got = tgen.decode_block_into(tp, cache_b, token, pos, temps, seeds,
                                 counts, tcfg, out)
    assert got is out and torch.equal(out, want)
    assert torch.equal(token, tok_a) and torch.equal(pos, pos_a)
    assert torch.equal(counts, counts_a) and pos.tolist() == [12, 6]
    for key in ("k", "v"):
        assert torch.equal(cache_a[key], cache_b[key])


def test_prefill_into_slot_reads_no_host_scalar():
    """prompt_len and slot are device tensors: a bucket's program is one
    function of them (the same call serves any length and slot)."""
    _, tcfg, _, tp = _setup()
    cache = tgen.init_kv_cache(tcfg, 3, 32, device="cpu")
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :5] = torch.arange(1, 6)
    logits, _ = tgen.prefill_into_slot(tp, padded, torch.tensor(5),
                                       torch.tensor(2), cache, tcfg)
    ref = ttf.forward(tp, padded[:, :5], tcfg)[0, -1]
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=0)
    assert cache["k"][:, 2, :16].any() and not cache["k"][:, :2].any()
    with pytest.raises((TypeError, AttributeError)):
        tgen.prefill_into_slot(tp, padded, 5, 2, cache, tcfg)


def test_decode_step_takes_a_device_position():
    """``decode_step`` at a 0-d position tensor (what the captured loop
    passes) equals the same step at a Python int, and JAX's step at that
    position: logits atol 1e-4, the written cache row atol 1e-5."""
    jcfg, tcfg, jp, tp = _setup()
    prompt = np.arange(1, 9, dtype=np.int32)[None]
    _, jcache = jgen.prefill(jp, jnp.asarray(prompt), jcfg, 32)
    outs = []
    for pos in (8, torch.tensor(8)):
        _, cache = tgen.prefill(tp, torch.from_numpy(prompt), tcfg, 32)
        outs.append(tgen.decode_step(tp, torch.tensor([5]), cache, pos, tcfg))
    (la, ca), (lb, cb) = outs
    assert torch.equal(la, lb)
    jl, jcache = jgen.decode_step(jp, jnp.asarray([5], jnp.int32), jcache,
                                  jnp.int32(8), jcfg)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        assert torch.equal(ca[key], cb[key])
        np.testing.assert_allclose(cb[key][:, :, :9].numpy(),
                                   np.asarray(jcache[key])[:, :, :9],
                                   atol=1e-5)


def test_decode_loop_from_a_position_tensor_matches_jax():
    """The public ``prefill`` then ``decode_loop`` (start position a 0-d
    tensor, greedy) as bench.py's inference leg calls them: the tokens
    equal JAX's ``decode_loop``'s."""
    jcfg, tcfg, jp, tp = _setup(n_kv_heads=2)
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jlog, jcache = jgen.prefill(jp, jnp.asarray(prompt), jcfg, 20)
    jfirst = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    want = jgen.decode_loop(jp, jfirst, jcache, jnp.array(8, jnp.int32),
                            jcfg, 9, 0.0, jax.random.key(2))
    tlog, tcache = tgen.prefill(tp, torch.from_numpy(prompt).long(), tcfg, 20)
    first = torch.argmax(tlog, dim=-1)
    assert first.tolist() == np.asarray(jfirst).tolist()
    got = tgen.decode_loop(tp, first, tcache, torch.tensor(8), tcfg, 9, 0.0,
                           torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_deferred_writes_decode_matches_jax(monkeypatch):
    """``RAYTPU_DECODE_DEFERRED_WRITES=1`` for both packages: the decode
    block's tokens equal JAX's deferred-writes block (a block length no
    other test compiles, so JAX traces the deferred structure), its cache
    rows JAX's within 1e-5; and the port's deferred block equals its
    default one bit for bit (the same rows attended and written)."""
    jcfg, tcfg, jp, tp = _setup(n_kv_heads=2)
    prompt = np.arange(1, 9, dtype=np.int32)
    state = (np.zeros(2, np.float32), np.zeros(2, np.int32),
             np.zeros(2, np.int32))

    def port_block():
        tlog, tcache = _prefilled(tgen, tp, tcfg, prompt, 0, TORCH_DEV)
        first = int(torch.argmax(tlog))
        toks, tcache, *_ = tgen.decode_block(
            tp, tcache, torch.tensor([first, 3]), torch.tensor([8, 30]),
            *_slot_state(*state), tcfg, 7)
        return first, toks, tcache

    _, carry_toks, carry_cache = port_block()
    monkeypatch.setenv("RAYTPU_DECODE_DEFERRED_WRITES", "1")
    first, toks, tcache = port_block()
    jlog, jcache = _prefilled(jgen, jp, jcfg, prompt, 0, JAX_DEV)
    assert int(jnp.argmax(jlog)) == first
    jtoks, jcache, *_ = jgen.decode_block(
        jp, jcache, jnp.array([first, 3], jnp.int32),
        jnp.array([8, 30], jnp.int32), *map(jnp.asarray, state), jcfg, 7)
    np.testing.assert_array_equal(toks[0].numpy(), np.asarray(jtoks)[0])
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, 0].numpy(),
                                   np.asarray(jcache[key])[:, 0], atol=1e-5)
        assert torch.equal(tcache[key], carry_cache[key])
    assert torch.equal(toks, carry_toks)


def test_decode_loop_sampling_is_deterministic_per_generator_seed():
    """Sampling runs on ``_sample_vec`` from one seed drawn per call: the
    same generator seed gives the same tokens, another seed others, and
    each row of a batch its own stream."""
    _, tcfg, _, tp = _setup(max_seq_len=32)
    prompt = np.ones((2, 4), np.int64)

    def run(seed):
        return tgen.generate(tp, prompt, tcfg, max_new_tokens=8,
                             temperature=1.0, device="cpu",
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # same prompt, its own stream
    g = torch.Generator().manual_seed(7)
    first = tgen.generate(tp, prompt, tcfg, max_new_tokens=8,
                          temperature=1.0, device="cpu", generator=g)
    again = tgen.generate(tp, prompt, tcfg, max_new_tokens=8,
                          temperature=1.0, device="cpu", generator=g)
    assert torch.equal(first, a) and not torch.equal(again, a)


class _Replayer:
    """Stands in for a captured graph on the CPU: capture recorded nothing,
    each replay reruns the body (over the same static buffers, as a replay
    of the graph does)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _fake_capture(monkeypatch, events):
    """``graphs.warm_up``/``graphs.capture`` as above, logging each warm-up
    and capture; the CUDA device context and pool handle made harmless, and
    CPU tensors routed through the captured programs."""
    from contextlib import nullcontext

    from ray_tpu_torch import graphs

    def warm_up(body, device, stream=None):
        events.append("warm")
        return body()

    def capture(body, pool=None):
        events.append("capture")
        return graphs.Captured(_Replayer(body), None,
                               {"decode_attention": 0})

    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(tgen, "_captured", lambda dev: True)
    tgen.release_programs()


@pytest.mark.parametrize("steps", [0, 1, 13, 32, 63, 64, 100])
def test_block_plan_meets_every_step_count(steps):
    plan = tgen._block_plan(steps)
    assert sum(plan) == steps and plan == sorted(plan, reverse=True)
    assert set(plan) <= {1 << i for i in range(6)}
    assert len(set(plan)) == len(plan) or plan.count(tgen.DECODE_BLOCK) > 1


def test_program_warms_up_then_captures_then_replays(monkeypatch):
    """A session's decode of 13 steps replays blocks of 8, 4 and 1, each
    captured at its first use after an eager warm-up; the warm-up's advance
    of the loop's state is undone, so the tokens and cache rows equal the
    loop run eagerly. A second call captures nothing more and replays the
    same three programs."""
    events = []
    _, tcfg, _, tp = _setup()
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 8)))
    want, want_cache = [], None
    for _ in range(2):
        logits, cache = tgen.prefill(tp, prompt, tcfg, 32)
        want_cache = cache
        want.append(tgen.decode_loop_into(
            tp, cache, torch.argmax(logits, -1), torch.tensor(8),
            torch.zeros(2), torch.zeros(2, dtype=torch.long),
            torch.ones(2, dtype=torch.long), tcfg,
            torch.empty((2, 13), dtype=torch.long)))
    _fake_capture(monkeypatch, events)
    session = tgen._session(tp, tcfg, 2, 32, torch.device("cpu"))
    session.prefill(tp, prompt)
    first = torch.argmax(session.logits, -1)
    zero = torch.zeros((), dtype=torch.long)
    got = session.decode(tp, first, 8, 0.0, zero, 13)
    assert torch.equal(got, want[0])
    assert events == ["warm", "capture"] * 4
    keys = [("prefill", 8), ("decode", 8), ("decode", 4), ("decode", 1)]
    assert list(session.programs) == keys
    session.prefill(tp, prompt)
    assert torch.equal(session.decode(tp, first, 8, 0.0, zero, 13), want[1])
    assert len(events) == 8  # nothing captured again
    assert [p.replays for p in session.programs.values()] == [2] * 4
    for key in ("k", "v"):
        assert torch.equal(session.cache[key], want_cache[key])
    assert [k for k, _, _ in tgen.programs()] == keys
    tgen.release_programs()


def test_captured_prefill_returns_a_cache_of_its_own(monkeypatch):
    """Through the captured programs, as on CUDA: each ``prefill`` returns a
    new cache equal to the eager one (rows past the prompt zero), which a
    later prefill of the same signature leaves alone; ``decode_loop`` on
    the first cache then continues the first prompt, writes its rows back
    into that cache, and equals the eager loop's tokens and rows."""
    events = []
    _, tcfg, _, tp = _setup()
    rng = np.random.default_rng(5)
    prompts = [torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 8)))
               for _ in range(2)]
    eager = [tgen.prefill(tp, p, tcfg, 32) for p in prompts]
    _fake_capture(monkeypatch, events)
    got = [tgen.prefill(tp, p, tcfg, 32) for p in prompts]
    assert events == ["warm", "capture"]  # one program, replayed twice
    for (want_logits, want_cache), (logits, cache) in zip(eager, got):
        assert torch.equal(logits, want_logits)
        for key in ("k", "v"):
            assert torch.equal(cache[key], want_cache[key])
            assert not cache[key][:, :, 8:].any()
    assert not torch.equal(got[0][1]["k"], got[1][1]["k"])
    want = tgen.decode_loop(tp, torch.argmax(eager[0][0], -1), eager[0][1],
                            8, tcfg, 9, 0.0, torch.Generator())
    logits, cache = got[0]
    toks = tgen.decode_loop(tp, torch.argmax(logits, -1), cache,
                            torch.tensor(8), tcfg, 9, 0.0, torch.Generator())
    assert torch.equal(toks, want)
    for key in ("k", "v"):
        assert torch.equal(cache[key], eager[0][1][key])
    tgen.release_programs()


def test_sessions_are_bounded(monkeypatch):
    """At most ``_MAX_SESSIONS`` signatures keep their programs and static
    cache; the least recently used goes first."""
    _fake_capture(monkeypatch, [])
    _, tcfg, _, tp = _setup()
    prompt = torch.ones((1, 4), dtype=torch.long)
    for max_len in (16, 24, 32, 16):
        tgen.generate(tp, prompt, tcfg, max_new_tokens=3, max_len=max_len,
                      device="cpu")
    assert [k[3] for k in tgen._sessions] == [32, 16]
    assert len(tgen._sessions) == tgen._MAX_SESSIONS
    tgen.release_programs()
    assert not tgen._sessions


def test_captured_generate_equals_eager_generate(monkeypatch):
    """``generate`` through one session's programs (greedy and sampled)
    gives the eager path's tokens."""
    _, tcfg, _, tp = _setup()
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 8))

    def run():
        return [tgen.generate(tp, prompt, tcfg, max_new_tokens=11,
                              temperature=t, device="cpu",
                              generator=torch.Generator().manual_seed(3))
                for t in (0.0, 1.0)]

    want = run()
    _fake_capture(monkeypatch, [])
    got = run()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [k for k, _, _ in tgen.programs()] == [
        ("prefill", 8), ("decode", 8), ("decode", 2)]
    tgen.release_programs()


def test_programs_are_keyed_on_where_the_params_lie():
    """The key of a captured program names each parameter's address, shape
    and dtype (int8 leaves by both their tensors): params moved or changed
    in shape get programs of their own; values changed in place do not."""
    from ray_tpu_torch.models import quant as tq

    _, tcfg, _, tp = _setup()
    key = tgen._params_key(tp)
    assert tgen._params_key(tp) == key
    tp["embed"].add_(1.0)  # in place: the graph reads the new values
    assert tgen._params_key(tp) == key
    moved = dict(tp, embed=tp["embed"].clone())
    assert tgen._params_key(moved) != key
    q = tq.quantize_params_int8(tp)
    qkey = tgen._params_key(q)
    assert len(qkey) > len(key)  # q and s of every int8 leaf
