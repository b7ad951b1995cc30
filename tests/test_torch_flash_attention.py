"""The port's flash-attention forward (ray_tpu_torch/ops/flash_attention.py)
against the JAX Pallas kernel run in interpret mode, on the CPU.

On the CPU the port's wrapper runs its plain version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py. Inputs come
from a numpy seed. Tolerances: o at atol 2e-5 (as tests/test_model.py:155),
lse at atol 2e-5 (fp32 logsumexp, summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jflash
from ray_tpu.ops.attention import repeat_kv as jrepeat_kv
from ray_tpu_torch.ops import flash_attention as tflash

ATOL = 2e-5

CASES = [
    ((2, 128, 2, 2, 64), True),
    ((2, 128, 2, 2, 64), False),
    ((1, 128, 4, 2, 32), True),  # GQA
    ((1, 128, 4, 1, 32), False),  # GQA, non-causal
    ((2, 100, 2, 2, 32), True),  # S not a multiple of the 64 tile
]
IDS = ["causal", "non_causal", "gqa", "gqa_non_causal", "ragged_s"]


def _qkv(shape, seed=0):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32))


def _jax_lse(q, k, v, causal):
    """lse [B*H, S] from JAX's Pallas forward (`_fwd`, interpret mode)."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    k = jrepeat_kv(jnp.asarray(k), n_rep)
    v = jrepeat_kv(jnp.asarray(v), n_rep)
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)
                  for x in (q, k, v))
    block = jflash._fit_block(64, s)
    _o, lse = jflash._fwd(qt, kt, vt, scale=d ** -0.5, block_q=block,
                          block_kv=block, causal=causal, interpret=True)
    return np.asarray(lse)


@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_flash_forward_matches_jax(shape, causal):
    q, k, v = _qkv(shape)
    ref_o = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, block_q=64,
                                   block_kv=64, interpret=True)
    o, lse = tflash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL)
    b, s, h, _ = q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(),
                               _jax_lse(q, k, v, causal), atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 40, 2, 2, 16), seed=1))
    before = tflash.launches
    o = tflash.flash_attention(q, k, v, causal=True)
    ref_o, _ = tflash.flash_attention_fwd_reference(q, k, v, True)
    assert torch.equal(o, ref_o)
    assert o.dtype == q.dtype
    assert tflash.launches == before  # no kernel on the CPU


def test_bf16_inputs_keep_their_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv((1, 64, 2, 2, 16), seed=2))
    o, lse = tflash.flash_attention_fwd(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


def test_gradients_are_refused_until_the_training_slice():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 2, 16)))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tflash.flash_attention(q, k, v)
    with torch.no_grad():
        tflash.flash_attention(q, k, v)


@pytest.mark.parametrize(
    "q_shape,kv_shape",
    [((1, 16, 4, 16), (1, 16, 3, 16)), ((1, 16, 4, 16), (1, 8, 4, 16)),
     ((16, 4, 16), (16, 4, 16))],
    ids=["heads_not_dividing", "kv_len_differs", "rank3"],
)
def test_bad_shapes_raise(q_shape, kv_shape):
    with pytest.raises(ValueError):
        tflash.flash_attention(torch.zeros(q_shape), torch.zeros(kv_shape),
                               torch.zeros(kv_shape))


def test_non_cpu_non_cuda_tensors_raise_not_fall_back():
    q = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(torch.zeros(1, 16, 2, 16), q, q)
