"""The int8 weight-only matmul (ray_tpu_torch/ops/int8_matmul.py) on the CPU:
its plain version held against JAX's ``einsum(x, QTensor.astype(dtype))``
for every int8 weight layout of a layer, what ``_check`` refuses, that no
tensor off the CPU falls back to the plain version, that ``apply_layer``
on a quantized layer equals the dequantize-then-einsum route, and the bf16
kernel's launch plan (``launch_plan``): its K split, which fixes every
row's sum order, depends on K and N and never on M, and every shape that
``chip_smoke.py`` runs gets a plan the kernel accepts.

Tolerances. Both sides multiply the same dequantized weights (bit-identical,
tests/test_torch_quant.py) and sum in another order:
- fp32: each sum of K products is within K * 2^-24 * S of the exact sum,
  S = sum_k |x_k w_k|, so the two differ by at most 2 K 2^-24 S (checked
  element by element);
- bf16: those fp32 sums, each rounded once to bf16 (8 significant bits):
  2 K 2^-24 S + 2^-7 (1 + 2^-7) max(|got|, |want|).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import quant as jq
from ray_tpu_torch.models import quant as tq
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.ops import int8_matmul as im

TINY = ttf.TransformerConfig.tiny(n_kv_heads=2)
D, H, KV, DH, F = (TINY.d_model, TINY.n_heads, TINY.kv_heads, TINY.d_head,
                   TINY.d_ff)
# One layer's int8 weights: (weight shape, contracted axes, x's trailing
# shape, einsum of apply_layer)
LAYOUTS = {
    "wq": ((D, H, DH), (0,), (D,), "bsd,dhk->bshk"),
    "wk": ((D, KV, DH), (0,), (D,), "bsd,dhk->bshk"),
    "wv": ((D, KV, DH), (0,), (D,), "bsd,dhk->bshk"),
    "attn_wo": ((H, DH, D), (0, 1), (H, DH), "bshk,hkd->bsd"),
    "mlp_wi": ((D, F), (0,), (D,), "bsd,df->bsf"),
    "mlp_wo": ((F, D), (0,), (F,), "bsf,fd->bsd"),
}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _quantized(shape, axes, seed=0):
    """A seeded N(0, 1/fan_in) weight quantized by JAX: (JAX QTensor, the
    port's QTensor of the same q and s)."""
    fan_in = int(np.prod([shape[a] for a in axes]))
    w = (np.random.default_rng(seed).standard_normal(shape)
         * fan_in ** -0.5).astype(np.float32)
    ref = jq.quantize_tensor(jnp.asarray(w), axes)
    port = tq.QTensor(torch.from_numpy(np.array(ref.q)),
                      torch.from_numpy(np.array(ref.s)))
    return ref, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_within_sum_bound(got, want, x, w, k, bf16):
    """|got - want| within the bound of the module docstring; x and w as
    float64 arrays contracted over their last / first axis."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    terms = np.abs(x) @ np.abs(w)
    tol = 2 * k * 2.0 ** -24 * terms
    if bf16:
        tol = tol + 2.0 ** -7 * (1 + 2.0 ** -7) * np.maximum(np.abs(got),
                                                             np.abs(want))
    err = np.abs(got - want)
    assert (err <= tol).all(), (err.max(), (err / tol).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_version_matches_jax_einsum(name, dtype):
    """``QTensor.matmul`` (the plain version, on CPU tensors) against JAX's
    einsum over ``QTensor.astype`` for each weight layout of a layer."""
    shape, axes, x_tail, spec = LAYOUTS[name]
    jdt, tdt = DTYPES[dtype]
    ref_w, w = _quantized(shape, axes)
    x = _x((2, 5, *x_tail))
    want = jnp.einsum(spec, jnp.asarray(x).astype(jdt), ref_w.astype(jdt))
    got = w.matmul(torch.from_numpy(x).to(tdt), len(axes))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    k = int(np.prod([shape[a] for a in axes]))
    xw = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32),
                    np.float64).reshape(-1, k)
    ww = np.asarray(ref_w.astype(jdt).astype(jnp.float32),
                    np.float64).reshape(k, -1)
    _assert_within_sum_bound(got.reshape(xw.shape[0], -1),
                             want.reshape(xw.shape[0], -1), xw, ww, k,
                             dtype == "bf16")
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 3, 17])
def test_plain_version_at_ragged_m(m):
    """Rows that fill no 16-row tile: each row equals the same row computed
    alone and JAX's einsum."""
    ref_w, w = _quantized((D, F), (0,))
    x = _x((m, D))
    got = im.int8_matmul(torch.from_numpy(x), w.q, w.s.reshape(-1))
    want = np.asarray(jnp.asarray(x) @ ref_w.astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for r in range(m):
        row = im.int8_matmul(torch.from_numpy(x[r:r + 1]), w.q,
                             w.s.reshape(-1))
        np.testing.assert_allclose(row.numpy(), got.numpy()[r:r + 1],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_dequantize_then_product(dtype):
    _, w = _quantized((D, F), (0,))
    x = torch.from_numpy(_x((6, D))).to(dtype)
    got = im.int8_matmul_reference(x, w.q, w.s.reshape(-1))
    assert torch.equal(got, x @ w.to(dtype))


def _operands(m=8, k=64, n=64, x_dtype=torch.bfloat16):
    return (torch.zeros((m, k), dtype=x_dtype),
            torch.zeros((k, n), dtype=torch.int8),
            torch.zeros(n, dtype=torch.float32))


def _misaligned_x():
    """Contiguous, 4-byte aligned, not 16-byte aligned."""
    flat = torch.zeros(8 * 64 + 2, dtype=torch.bfloat16)
    x = flat[2:].view(8, 64)
    assert x.data_ptr() % 16 == 4
    return x


BAD_OPERANDS = {
    "fp16_x": (lambda: _operands(x_dtype=torch.float16), TypeError),
    "int32_q": (lambda: (_operands()[0], torch.zeros((64, 64),
                                                     dtype=torch.int32),
                         _operands()[2]), TypeError),
    "bf16_scales": (lambda: (*_operands()[:2],
                             torch.zeros(64, dtype=torch.bfloat16)),
                    TypeError),
    "k_not_64": (lambda: _operands(k=80), ValueError),
    "n_not_32": (lambda: _operands(n=48), ValueError),
    "k_mismatch": (lambda: (torch.zeros((8, 64), dtype=torch.bfloat16),
                            *_operands(k=128)[1:]), ValueError),
    "scale_count": (lambda: (*_operands()[:2], torch.zeros(32)), ValueError),
    "x_3d": (lambda: (torch.zeros((2, 4, 64), dtype=torch.bfloat16),
                      *_operands()[1:]), ValueError),
    "x_strided": (lambda: (torch.zeros((64, 8), dtype=torch.bfloat16).t(),
                           *_operands()[1:]), ValueError),
    "x_misaligned": (lambda: (_misaligned_x(), *_operands()[1:]), ValueError),
    "no_rows": (lambda: _operands(m=0), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_check_refuses_what_the_kernel_does_not_take(case):
    make, exc = BAD_OPERANDS[case]
    with pytest.raises(exc):
        im._check_operands(*make())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_takes_every_layer_weight_as_the_layer_flattens_it(dtype):
    for name, (shape, axes, _tail, _spec) in LAYOUTS.items():
        k = int(np.prod(shape[:len(axes)]))
        n = int(np.prod(shape[len(axes):]))
        _, w = _quantized(shape, axes)
        im._check_operands(torch.zeros((8, k), dtype=dtype),
                           w.q.reshape(k, n), w.s.reshape(n))


def test_check_needs_one_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        im._check(*_operands())


def test_tensors_off_the_cpu_raise_not_fall_back():
    x, q, s = (t.to("meta") for t in _operands())
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_matmul(x, q, s)
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_matmul(_operands()[0], q, s)  # CPU x, meta q and s


def test_a_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch):
    """Past ``_check``, a tensor off the CPU goes to the kernel: where the
    kernel cannot be had (no card, no nvcc), that raises; the plain version
    is never taken."""
    def no_kernel():
        raise RuntimeError("no kernel here")

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(im, "_check", lambda *a: None)
    monkeypatch.setattr(im, "_kernel", no_kernel)
    monkeypatch.setattr(im, "int8_matmul_reference", plain)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0}))
    x, q, s = (t.to("meta") for t in _operands())
    with pytest.raises(RuntimeError, match="no kernel here"):
        im.int8_matmul(x, q, s)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cpu_calls_count_no_launch():
    before = im.launches
    _, w = _quantized((D, F), (0,))
    im.int8_matmul(torch.zeros((2, D)), w.q, w.s.reshape(-1))
    assert im.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_apply_layer_on_int8_weights_equals_dequantize_then_einsum(
        dtype, monkeypatch):
    """One quantized layer through ``apply_layer``: the QTensor route (six
    ``int8_matmul`` products) against the same layer with every weight
    dequantized first (today's plain route, einsum over ``QTensor.to``).
    Both multiply the same weights; on the CPU an einsum over [B, S, ...]
    and a product over its [B*S, K] view run the same matmul, so the
    outputs are held EQUAL."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    params = tq.quantize_params_int8(ttf.init_params(cfg, 0, device="cpu"))
    layer = ttf.layer_params(params, 0)
    plain = ttf.tree_map(
        lambda w: w.to(dtype) if isinstance(w, tq.QTensor) else w, layer)
    calls = []
    real = tq.int8_matmul
    monkeypatch.setattr(tq, "int8_matmul",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    x = torch.from_numpy(_x((2, 7, D))).to(dtype)
    pos = torch.arange(7)
    attn = ttf.select_attn_fn(cfg)
    got, _ = ttf.apply_layer(x, layer, cfg, pos, attn)
    want, _ = ttf.apply_layer(x, plain, cfg, pos, attn)
    assert len(calls) == 6
    assert got.dtype == dtype and torch.equal(got, want)


# --- the bf16 kernel's launch plan (ops/int8_matmul.py launch_plan) -------

def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
SERVE_7B_SHAPES = sorted(set(CS.int8_weight_shapes(
    ttf.TransformerConfig.serve_7b()).values()))
TINY_SHAPES = sorted(set(CS.int8_weight_shapes(TINY).values()))
# chip_smoke's int8 cases: serve_7b's shapes at decode's and prefill's M,
# the first shape at ragged M, tiny's shapes at M 8 and 64
SMOKE_CASES = sorted(
    {(m, k, n) for (k, n) in SERVE_7B_SHAPES for m in CS.INT8_MS}
    | {(m, *SERVE_7B_SHAPES[0]) for m in CS.INT8_RAGGED_MS}
    | {(m, k, n) for (k, n) in TINY_SHAPES for m in (8, 64)})


@pytest.mark.parametrize("k,n", SERVE_7B_SHAPES + TINY_SHAPES + [(64, 32)],
                         ids=lambda v: str(v))
def test_k_split_depends_on_k_and_n_never_on_m(k, n):
    """The split fixes each row's sum order (K ranges added in rank order),
    so it must be the same for every M: a row computed alone or in a batch
    of any size gets the same bits."""
    splits = {im.launch_plan(m, k, n).split for m in range(1, 1025)}
    assert splits == {im.k_split(k, n)}


@pytest.mark.parametrize("m,k,n", SMOKE_CASES, ids=lambda v: str(v))
def test_every_smoke_shape_gets_a_valid_plan(m, k, n):
    """What ``launch_bf16`` in csrc/int8_matmul.cu accepts: a split that is a
    power of two up to 8 dividing K's 64-row stages, with a workspace for
    the partials when above 1; at least one ring stage and no more than a
    block streams; the shared memory within a block's limit and holding the
    staged partial; wgmma's N one the kernel is built for and covering
    min(M, 128) rows."""
    plan = im.launch_plan(m, k, n)
    block_stages = k // im.STAGE_ROWS // plan.split
    assert plan.split in (1, 2, 4, 8) and (k // im.STAGE_ROWS) % plan.split == 0
    assert plan.workspace_bytes == (4 * plan.split * m * n
                                    if plan.split > 1 else 0)
    assert 1 <= plan.stages <= block_stages
    assert plan.smem_bytes <= im.SMEM_LIMIT
    assert plan.smem_bytes >= 1024 + plan.wgmma_n * (im.TILE_COLS + 4) * 4
    assert plan.wgmma_n in im.WGMMA_NS and plan.wgmma_n >= min(m, im.MAX_ROWS)
    assert plan.m_tiles * im.MAX_ROWS >= m > (plan.m_tiles - 1) * im.MAX_ROWS
    assert plan.grid == (plan.split * -(-n // im.TILE_COLS), plan.m_tiles)
    assert plan.tile_cols == im.TILE_COLS


@pytest.mark.parametrize("k,n", SERVE_7B_SHAPES, ids=lambda v: str(v))
def test_serve_7b_decode_fills_the_card_with_q_in_flight(k, n):
    """At decode (M 8) every serve_7b shape runs one block per SM on at
    least 120 of the H100's 132 SMs, and each block's ring holds at least
    32 KB of q (four stages of 64 rows by 128 columns)."""
    plan = im.launch_plan(8, k, n)
    blocks = plan.grid[0] * plan.grid[1]
    assert 120 <= blocks <= im.H100_SMS
    assert plan.stages * im.STAGE_ROWS * im.TILE_COLS >= 32 * 1024
    assert plan.wgmma_n == 8


def test_rows_above_128_tile_m_and_keep_the_split():
    small, big = im.launch_plan(128, 4096, 4096), im.launch_plan(
        300, 4096, 4096)
    assert (small.m_tiles, big.m_tiles) == (1, 3)
    assert small.split == big.split and big.wgmma_n == 128
