"""Parity of the port's dense attention (ray_tpu_torch/ops/attention.py) with
the JAX reference (ray_tpu/ops/attention.py), on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerance: atol
1e-5 in fp32 (the same math; only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

ATOL = 1e-5


def _qkv(rng, b, sq, sk, h, hkv, d):
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((2, 16, 16, 4, 4, 8), {}),
        ((2, 16, 16, 4, 2, 8), {}),  # GQA
        ((1, 8, 24, 4, 1, 16), {"q_offset": 16, "kv_offset": 0}),
        ((2, 8, 8, 2, 2, 8), {"q_offset": 8, "kv_offset": 4}),
        ((2, 12, 12, 4, 2, 8), {"causal": False}),
    ],
    ids=["mha", "gqa", "q_offset", "both_offsets", "non_causal"],
)
def test_causal_attention_matches_jax(shape, kw):
    q, k, v = _qkv(np.random.default_rng(0), *shape)
    ref = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    out = tattn.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_causal_attention_is_causal():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(1), 1, 8, 8, 2, 2, 4))
    out1 = tattn.causal_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] = 99.0
    v2[:, -1] = 99.0
    out2 = tattn.causal_attention(q, k2, v2)
    # Perturbing a future position must not change earlier outputs.
    np.testing.assert_allclose(out1[:, :-1], out2[:, :-1], atol=1e-6)
    assert not np.allclose(out1[:, -1], out2[:, -1])


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv_matches_jax(n_rep):
    k = np.random.default_rng(2).standard_normal((2, 5, 2, 4),
                                                 dtype=np.float32)
    ref = jattn.repeat_kv(jnp.asarray(k), n_rep)
    out = tattn.repeat_kv(torch.from_numpy(k), n_rep)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _masked_scores(q, k, q_off, k_off):
    """fp32 scores [B, H, Sq, Sk] with the causal mask on global positions."""
    scale = q.shape[-1] ** -0.5
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = (q_off + np.arange(q.shape[1]))[:, None] >= (
        k_off + np.arange(k.shape[1])
    )[None, :]
    return np.where(mask, s, tattn.NEG_INF).astype(np.float32)


def test_blockwise_update_and_finalize_match_jax():
    rng = np.random.default_rng(3)
    b, s, h, d, blk = 2, 16, 2, 8, 8
    q, k, v = _qkv(rng, b, s, s, h, h, d)
    j_state = (jnp.zeros((b, s, h, d)), jnp.full((b, h, s), tattn.NEG_INF),
               jnp.zeros((b, h, s)))
    t_state = (torch.zeros(b, s, h, d), torch.full((b, h, s), tattn.NEG_INF),
               torch.zeros(b, h, s))
    for j in range(s // blk):
        kb, vb = k[:, j * blk:(j + 1) * blk], v[:, j * blk:(j + 1) * blk]
        scores = _masked_scores(q, kb, 0, j * blk)
        j_state = jattn.blockwise_update(jnp.asarray(scores), jnp.asarray(vb),
                                         *j_state)
        t_state = tattn.blockwise_update(torch.from_numpy(scores),
                                         torch.from_numpy(vb), *t_state)
        for a, r in zip(t_state, j_state):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL)
    out = tattn.blockwise_finalize(t_state[0], t_state[2], torch.float32)
    ref = jattn.blockwise_finalize(j_state[0], j_state[2], jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # and the blockwise sweep equals one dense pass
    dense = tattn.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL)
