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
    return gen.prefill_into_slot(params, to_dev["arr"](padded), n, slot,
                                 cache, cfg)


JAX_DEV = {"kw": {}, "arr": jnp.asarray}
TORCH_DEV = {"kw": {"device": "cpu"}, "arr": torch.from_numpy}


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
        tp, tcache, torch.tensor([first, 0]), torch.tensor([8, 0]), zeros,
        izeros, izeros, tcfg, 5)
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
    toks, *_ = tgen.decode_block(tp, cache, tok, pos, [0.0, 0.0], [0, 0],
                                 [0, 0], tcfg, 1)
    assert int(toks[0, 0]) == int(torch.argmax(logits[0]))


def test_decode_past_the_cache_end_stays_in_its_slot():
    """A slot decoding on past its cache (a finished request inside a
    block) must not fail or touch another slot's rows."""
    _, tcfg, _, tp = _setup()
    cache = tgen.init_kv_cache(tcfg, 2, 8, device="cpu")
    before = cache["k"][:, 0].clone()
    tgen.decode_block(tp, cache, torch.tensor([1, 2]), torch.tensor([0, 7]),
                      [0.0, 0.0], [0, 0], [0, 0], tcfg, 3)
    assert torch.equal(cache["k"][:, 0, 3:], before[:, 3:])


def test_sample_vec_greedy_and_deterministic():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 256),
                                                  dtype=np.float32))
    greedy = tgen._sample_vec(logits, [0.0] * 4, [0] * 4, [0] * 4)
    assert torch.equal(greedy, torch.argmax(logits, dim=-1))
    flat = torch.zeros((4, 256))
    temps, seeds = [1.0, 1.0, 1.0, 0.0], [7, 7, 8, 7]
    a = tgen._sample_vec(flat, temps, seeds, [3, 3, 3, 3])
    b = tgen._sample_vec(flat, temps, seeds, [3, 3, 3, 3])
    assert torch.equal(a, b)  # deterministic per (seed, count)
    assert int(a[0]) == int(a[1])  # same (seed, count), same draw
    assert int(a[3]) == 0  # the greedy slot
    draws = {tuple(tgen._sample_vec(flat, temps, seeds, [c] * 4).tolist())
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
