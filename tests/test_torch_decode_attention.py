"""Decode attention (ray_tpu_torch/ops/decode_attention.py) on the CPU: its
plain version held against the JAX package's cached attention of one query
token, ``_attend_prefix_plus_self`` (the engine's per-slot step, with the
self column) and ``_attend_cached`` at S = 1 (``generate``'s loop, without
it); the CPU route; that a tensor off the CPU never reaches the plain
version; what ``_check_operands`` refuses; and the kernel's launch plan.

Inputs are made from a numpy seed and rounded to the dtype once, so both
packages read the same values. Tolerances:
- fp32: the same arithmetic with the sums taken in another order (D <= 64
  products per score, <= 41 terms per softmax and per output): 1e-5
  absolute and relative;
- bf16: the scores and the softmax are fp32 in both, so p differs in its
  last fp32 bits at most, which can move a p one bf16 step (2^-8 relative)
  when it rounds; the output is rounded to bf16 once on each side (2^-8
  relative). Allowed: 2e-2 absolute and relative, a few bf16 steps at the
  outputs' magnitude (|out| < 3 here).
"""

import ctypes
from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu_torch.ops import decode_attention as da

S_MAX = 40
# per slot: the self column alone (0), mid cache, the last row, past the end
POSITIONS = [0, 17, S_MAX - 1, S_MAX + 3]
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(n_rep, d, dtype, seed=0, b=len(POSITIONS), h=4):
    """q [B, 1, H, D], caches [B, S_MAX, H / n_rep, D], fresh k/v [B, 1,
    H / n_rep, D], N(0, 1) rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    hkv = h // n_rep

    def t(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(dtype)

    return (t(b, 1, h, d), t(b, S_MAX, hkv, d), t(b, S_MAX, hkv, d),
            t(b, 1, hkv, d), t(b, 1, hkv, d))


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(JDTYPE[x.dtype])


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


CASES = [(n_rep, d, dtype) for n_rep in (1, 2, 4) for d in (16, 64)
         for dtype in (torch.float32, torch.bfloat16)]


def _case_id(case):
    n_rep, d, dtype = case
    return f"rep{n_rep}-d{d}-{str(dtype).removeprefix('torch.')}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefix_plus_self_matches_jax(case):
    """With the self column and lengths = pos: the reference's
    ``_attend_prefix_plus_self`` at every position of POSITIONS at once."""
    n_rep, d, dtype = case
    q, k, v, kn, vn = _operands(n_rep, d, dtype)
    pos = torch.tensor(POSITIONS)
    got = da.decode_attention_reference(q, k, v, pos, kn, vn)
    want = jgen._attend_prefix_plus_self(
        _jax(q), _jax(k), _jax(v), _jax(kn), _jax(vn),
        jnp.asarray(POSITIONS, jnp.int32))
    assert got.shape == q.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cached_one_query_matches_jax(case):
    """Without the self column and lengths = pos + 1: the reference's
    ``_attend_cached`` with one query at pos (its cache row written), slot
    by slot, since the reference takes one position for the batch."""
    n_rep, d, dtype = case
    q, k, v, _, _ = _operands(n_rep, d, dtype, seed=1)
    got = da.decode_attention_reference(q, k, v, torch.tensor(POSITIONS) + 1)
    for b, p in enumerate(POSITIONS):
        want = jgen._attend_cached(
            _jax(q[b:b + 1]), _jax(k[b:b + 1]), _jax(v[b:b + 1]),
            jnp.asarray([p]), jnp.arange(S_MAX) < p + 1)
        _assert_close(got[b:b + 1], want, dtype)


def test_self_alone_is_v_new_and_past_the_end_reads_every_row():
    """lengths 0 with the self column gives v_new itself; lengths past
    S_max is the whole cache (what S_max gives)."""
    q, k, v, kn, vn = _operands(2, 16, torch.float32, seed=2)
    zero = torch.zeros(4, dtype=torch.long)
    out = da.decode_attention_reference(q, k, v, zero, kn, vn)
    torch.testing.assert_close(out, vn.repeat_interleave(2, dim=2),
                               atol=0, rtol=0)
    far = da.decode_attention_reference(q, k, v, torch.full((4,), 99))
    full = da.decode_attention_reference(q, k, v, torch.full((4,), S_MAX))
    assert torch.equal(far, full)


def test_cpu_route_is_the_plain_version_and_counts_no_launch():
    q, k, v, kn, vn = _operands(2, 64, torch.bfloat16, seed=3)
    pos = torch.tensor(POSITIONS)
    before = da.launches
    for extra in ((), (kn, vn)):
        assert torch.equal(da.decode_attention(q, k, v, pos, *extra),
                           da.decode_attention_reference(q, k, v, pos,
                                                         *extra))
    assert da.launches == before


def test_tensors_off_the_cpu_raise_not_fall_back():
    q, k, v, kn, vn = _operands(1, 16, torch.bfloat16)
    pos = torch.tensor(POSITIONS)
    meta = [t.to("meta") for t in (q, k, v, pos)]
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, k, v, pos.to("meta"))  # one operand off
    with pytest.raises(ValueError, match="CUDA"):
        da._check(q, k, v, pos, kn, vn)


def test_a_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch):
    """Past ``_check``, a tensor off the CPU goes to the kernel: where the
    kernel cannot be had (no card, no nvcc), that raises; the plain version
    is never taken."""
    def no_kernel():
        raise RuntimeError("no kernel here")

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(da, "_check", lambda *a: None)
    monkeypatch.setattr(da, "_kernel", no_kernel)
    monkeypatch.setattr(da, "decode_attention_reference", plain)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    q, k, v, _, _ = _operands(1, 16, torch.bfloat16)
    meta = [t.to("meta") for t in (q, k, v, torch.tensor(POSITIONS))]
    with pytest.raises(RuntimeError, match="no kernel here"):
        da.decode_attention(*meta)


def _bad(**kw):
    """Operands with one thing the kernel does not take."""
    q, k, v, kn, vn = _operands(kw.pop("n_rep", 1), kw.pop("d", 16),
                                kw.pop("dtype", torch.bfloat16))
    ops = {"q": q, "k_cache": k, "v_cache": v,
           "lengths": torch.tensor(POSITIONS), "k_new": kn, "v_new": vn}
    ops.update(kw)
    return ops


BAD_OPERANDS = {
    "fp16": (lambda: _bad(dtype=torch.float16), TypeError),
    "mixed_dtypes": (lambda: _bad(v_cache=_operands(
        1, 16, torch.float32)[2]), TypeError),
    "float_lengths": (lambda: _bad(lengths=torch.zeros(4)), TypeError),
    "k_new_alone": (lambda: _bad(v_new=None), ValueError),
    "d_not_8": (lambda: _bad(d=20), ValueError),
    "d_above_256": (lambda: _bad(d=264), ValueError),
    "two_queries": (lambda: _bad(q=torch.zeros((4, 2, 4, 16),
                                               dtype=torch.bfloat16)),
                    ValueError),
    "heads_not_grouped": (lambda: _bad(q=torch.zeros((4, 1, 6, 16),
                                                     dtype=torch.bfloat16),
                                       k_cache=torch.zeros(
                                           (4, S_MAX, 4, 16),
                                           dtype=torch.bfloat16),
                                       v_cache=torch.zeros(
                                           (4, S_MAX, 4, 16),
                                           dtype=torch.bfloat16),
                                       k_new=None, v_new=None), ValueError),
    "lengths_per_slot": (lambda: _bad(lengths=torch.zeros(3, dtype=int)),
                         ValueError),
    "cache_strided_last": (lambda: _bad(
        k_cache=torch.zeros((4, S_MAX, 1, 32),
                            dtype=torch.bfloat16)[..., ::2]), ValueError),
    "cache_row_stride_not_8": (lambda: _bad(
        k_cache=torch.zeros((4, S_MAX, 1, 20),
                            dtype=torch.bfloat16)[..., :16]), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_check_refuses_what_the_kernel_does_not_take(case):
    make, exc = BAD_OPERANDS[case]
    ops = make()
    with pytest.raises(exc):
        da._check_operands(ops["q"], ops["k_cache"], ops["v_cache"],
                           ops["lengths"], ops["k_new"], ops["v_new"])


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 192, 256])
def test_check_takes_every_head_dim_and_a_layer_slice_of_the_cache(n_rep, d):
    """A layer's slice of the [L, B, S_max, Hkv, D] cache, as the model
    passes it, with int64 and int32 lengths."""
    q = torch.zeros((2, 1, 4, d), dtype=torch.bfloat16)
    cache = torch.zeros((3, 2, S_MAX, 4 // n_rep, d), dtype=torch.bfloat16)
    for lengths in (torch.tensor([1, 2]), torch.tensor([1, 2],
                                                       dtype=torch.int32)):
        da._check_operands(q, cache[1], cache[2], lengths, None, None)


def test_argtypes_pass_pointers_and_the_stream_as_pointers():
    got = da._ARGTYPES[("decode_attention", "decode_attention")]
    assert got[:8] == [ctypes.c_void_p] * 8  # q .. workspace
    assert got[8:14] == [ctypes.c_int] * 6  # dtype, B, H, Hkv, S_max, D
    assert got[14:20] == [ctypes.c_int64] * 6  # cache strides
    assert got[20:] == [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]


@pytest.mark.parametrize("shape", [
    (8, 8, 8, 1089, 128),  # bench_400m's inference leg
    (8, 32, 32, 512, 128),  # serve_7b's engine
    (10, 16, 4, 300, 64), (1, 4, 2, 40, 16), (64, 32, 32, 4096, 256),
    (3, 12, 4, 7, 8),
])
def test_plan_covers_the_cache_and_sizes_the_workspace(shape):
    b, h, hkv, s_max, d = shape
    plan = da.launch_plan(b, h, hkv, s_max, d)
    assert plan.chunk_rows % da.CHUNK_ALIGN == 0
    assert (plan.n_chunks - 1) * plan.chunk_rows < s_max <= (
        plan.n_chunks * plan.chunk_rows)
    assert plan.workspace_floats == b * h * (s_max + 1 + plan.n_chunks * d)


def test_plan_splits_the_sequence_only_when_kv_heads_leave_sms_idle():
    """bench_400m decoding 8 sequences has 64 kv heads for 132 SMs: 9
    chunks of 128 rows; on a card of 33 SMs, 3 of 384; 4 blocks per SM of
    kv heads alone take one chunk."""
    plan = da.launch_plan(8, 8, 8, 1089, 128)
    assert (plan.n_chunks, plan.chunk_rows) == (9, 128)
    small = da.launch_plan(8, 8, 8, 1089, 128, sms=33)
    assert (small.n_chunks, small.chunk_rows) == (3, 384)
    assert da.launch_plan(66, 8, 8, 1089, 128).n_chunks == 1
