"""The port's flash attention (ray_tpu_torch/ops/flash_attention.py),
forward and backward, against the JAX Pallas kernels run in interpret mode,
on the CPU.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py. Inputs come from a numpy seed. Tolerances: o at atol 2e-5 (as
tests/test_model.py:155), lse at atol 2e-5 (fp32 logsumexp, summation order
differs), dq/dk/dv at atol 5e-5 (as tests/test_model.py:185: fp32 sums over
S terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jflash
from ray_tpu.ops.attention import repeat_kv as jrepeat_kv
from ray_tpu_torch.ops import flash_attention as tflash

ATOL = 2e-5
GRAD_ATOL = 5e-5

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


def _jax_residuals(q, k, v, causal):
    """The reference's [B*H, S, D] operands (kv repeated) and its forward's
    (o, lse), from `_fwd` in interpret mode."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    k = jrepeat_kv(jnp.asarray(k), n_rep)
    v = jrepeat_kv(jnp.asarray(v), n_rep)
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)
                  for x in (q, k, v))
    block = jflash._fit_block(64, s)
    o, lse = jflash._fwd(qt, kt, vt, scale=d ** -0.5, block_q=block,
                         block_kv=block, causal=causal, interpret=True)
    return (qt, kt, vt, o, lse), block


def _from_bh(x, b, h):
    """[B*H, S, D] -> [B, S, H, D] as numpy."""
    x = np.asarray(x)
    return x.reshape(b, h, *x.shape[1:]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_flash_backward_matches_jax(shape, causal):
    """dq, dk, dv through the port's autograd path against jax.grad of the
    Pallas flash attention (interpret mode), for sum(o * w)."""
    q, k, v = _qkv(shape, seed=3)
    w = np.random.default_rng(4).standard_normal(q.shape, dtype=np.float32)

    def loss(q, k, v):
        return (jflash.flash_attention(q, k, v, causal=causal, block_q=64,
                                       block_kv=64, interpret=True)
                * w).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    (o * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_bwd_reference_matches_jax_bwd(shape, causal):
    """flash_attention_bwd_reference against the reference's `_bwd` (both
    backward Pallas kernels, interpret mode) on its own residuals; the
    reference works on repeated kv heads, so its dk/dv are summed over the
    n_rep heads of each kv head (what autograd of repeat_kv does)."""
    q, k, v = _qkv(shape, seed=5)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    do = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    res, block = _jax_residuals(q, k, v, causal)
    dot = jnp.asarray(do).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    jdq, jdk, jdv = jflash._bwd(d ** -0.5, block, block, causal, True, res,
                                dot)
    o = torch.from_numpy(_from_bh(res[3], b, h).copy())
    lse = torch.from_numpy(np.asarray(res[4]).reshape(b, h, s).copy())
    dq, dk, dv = tflash.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), o, lse,
        torch.from_numpy(do), causal)
    np.testing.assert_allclose(dq.numpy(), _from_bh(jdq, b, h),
                               atol=GRAD_ATOL)
    for got, want in ((dk, jdk), (dv, jdv)):
        want = _from_bh(want, b, h).reshape(b, s, hkv, h // hkv, d).sum(3)
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL)


def test_bwd_reference_rounds_like_the_kernels_in_bf16():
    """bf16 inputs: grads come back in bf16 and within bf16 rounding of the
    fp32 computation (p and ds rounded to bf16 before their products, the
    grads rounded once: 3e-2 relative to each grad's largest value)."""
    q, k, v = _qkv((1, 48, 2, 1, 16), seed=7)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    args32 = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = tflash.flash_attention_fwd_reference(*args32, True)
    ref = tflash.flash_attention_bwd_reference(*args32, o, lse,
                                               torch.from_numpy(do), True)
    args16 = [x.bfloat16() for x in args32]
    got = tflash.flash_attention_bwd_reference(
        *args16, o.bfloat16(), lse, torch.from_numpy(do).bfloat16(), True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r.numpy(),
                                   atol=3e-2 * r.abs().max().item())


def test_gradients_flow_and_no_graph_under_no_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 2, 16)))
    q.requires_grad_(True)
    o = tflash.flash_attention(q, k, v)
    assert o.requires_grad and o.grad_fn is not None
    o.sum().backward()  # dO of ones is an expanded (stride 0) tensor
    assert q.grad is not None and q.grad.shape == q.shape
    assert k.grad is None  # k, v did not require grad
    with torch.no_grad():
        o = tflash.flash_attention(q, k, v)
    assert o.grad_fn is None and not o.requires_grad
    o, lse = tflash.flash_attention_fwd(q, k, v)
    assert not lse.requires_grad  # lse carries no gradient


def test_bwd_kernel_wrappers_take_cuda_tensors_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 2, 16)))
    lse = torch.zeros((1, 2, 16))
    for fn in (tflash.flash_bwd_dq_kernel, tflash.flash_bwd_dkv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, lse, lse)


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
