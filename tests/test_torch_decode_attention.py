"""Decode attention (ray_tpu_torch/ops/decode_attention.py) on the CPU: its
plain version held against the JAX package's cached attention of one query
token, ``_attend_prefix_plus_self`` (the engine's per-slot step, with the
self column) and ``_attend_cached`` at S = 1 (``generate``'s loop, without
it); the CPU route; that a tensor off the CPU never reaches the plain
version; what ``_check_operands`` refuses; the kernel's launch plan, the
Python mirror of its on-device split of each slot's rows, and the arguments
of one launch.

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
    assert got[:7] == [ctypes.c_void_p] * 7  # q .. out: no workspace
    assert got[7:13] == [ctypes.c_int] * 6  # dtype, B, H, Hkv, S_max, D
    assert got[13:19] == [ctypes.c_int64] * 6  # cache strides
    # scale, then the plan: cluster, tile_rows, max_stages; the stream
    assert got[19:] == [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    ring = da._ARGTYPES[("decode_attention", "decode_attention_ring")]
    assert ring == [ctypes.c_int] * 9 + [ctypes.c_void_p]  # int[3] out


# (B, H, Hkv, S_max, D, SMs)
PLAN_SHAPES = [
    (8, 8, 8, 1089, 128, 132),  # bench_400m's inference leg
    (8, 32, 32, 512, 128, 132),  # serve_7b's engine
    (8, 8, 8, 1024, 128, 132),  # the 400M engine
    (10, 16, 4, 300, 64, 132), (1, 4, 2, 40, 16, 132),
    (64, 32, 32, 4096, 256, 132), (3, 12, 4, 7, 8, 132),
    (1, 32, 1, 2048, 256, 33),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_fits_the_card_and_covers_the_cache(shape):
    """A portable cluster no larger than the cache has tiles, tiles within a
    TMA box, scores for the largest share, a ring of at most a share's K and
    V tiles (the kernel takes as many of them as the card's occupancy
    allows, and checks a block's shared memory against its 227 KB on the
    card), and one cluster per (slot, kv head, group of heads)."""
    b, h, hkv, s_max, d, sms = shape
    plan = da.launch_plan(b, h, hkv, s_max, d, sms)
    tiles = -(-s_max // plan.tile_rows)
    assert plan.cluster in da.CLUSTERS and plan.cluster <= tiles
    assert 1 <= plan.tile_rows <= min(da.TILE_ROWS, s_max)
    share_tiles = plan.share_rows // plan.tile_rows
    assert share_tiles == -(-tiles // plan.cluster)
    assert plan.max_stages == 2 * share_tiles >= 2
    assert (h // hkv) % plan.heads == 0 and plan.heads in (1, 2, 4, 8)
    assert plan.grid == (plan.cluster, b * h // plan.heads)
    assert plan.cluster == 8 or plan.cluster * plan.grid[1] >= 2 * sms or (
        2 * plan.cluster > tiles)


def test_plan_clusters_follow_the_kv_heads_against_the_sms():
    """The smallest cluster that gives each of 132 SMs two blocks: serve_7b's
    256 kv heads take 2, bench_400m's 64 take 8; on a card of 33 SMs 1 and
    2; a cache of 40 rows (3 tiles) stops at 2; GQA's groups count as kv
    heads (n_rep 16 in groups of 8 doubles them)."""
    assert da.launch_plan(8, 32, 32, 512, 128).cluster == 2
    assert da.launch_plan(8, 8, 8, 1089, 128).cluster == 8
    assert da.launch_plan(8, 8, 8, 1024, 128).cluster == 8
    assert da.launch_plan(8, 32, 32, 512, 128, sms=33).cluster == 1
    assert da.launch_plan(8, 8, 8, 1089, 128, sms=33).cluster == 2
    assert da.launch_plan(8, 8, 8, 40, 128).cluster == 2
    assert da.launch_plan(8, 128, 8, 1089, 128).cluster == 4
    assert da.launch_plan(66, 8, 8, 1089, 128).cluster == 1


def test_plan_rings_hold_a_share_at_the_serve_7b_step():
    """At serve_7b's step (8 slots at 160 of 512, a cluster of 2) each block's
    share is 5 K and 5 V tiles of 16 rows, and a ring as deep as the plan
    allows holds all of them; at the inference leg (lengths up to 1088 of
    1089, a cluster of 8) a share is 9 tiles of each."""
    plan = da.launch_plan(8, 32, 32, 512, 128)
    shares = [da.share_of(160, plan.tile_rows, plan.cluster, r)
              for r in range(plan.cluster)]
    assert shares == [(0, 80), (80, 160)]
    assert plan.max_stages == 2 * 512 // 16 // 2 >= 2 * 5
    leg = da.launch_plan(8, 8, 8, 1089, 128)
    assert max(r1 - r0 for r0, r1 in (
        da.share_of(1088, leg.tile_rows, leg.cluster, r)
        for r in range(leg.cluster))) == 9 * 16
    assert leg.max_stages == 2 * 9


def test_a_refused_launch_raises_and_falls_back_to_nothing(monkeypatch):
    """A CUDA tensor whose launch the library refuses (a cache too long for
    a block's shared memory: cudaErrorInvalidValue) raises; the plain
    version is not called, and ``launches`` does not count it."""
    monkeypatch.setattr(da, "_check", lambda *a: None)
    monkeypatch.setattr(da, "_kernel", lambda: lambda *args: 1)
    monkeypatch.setattr(da, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())

    def plain(*a):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(da, "decode_attention_reference", plain)
    b, h, s_max, d = 1, 32, 1 << 20, 128
    q = torch.empty((b, 1, h, d), dtype=torch.float32, device="meta")
    k = torch.empty((b, s_max, 1, d), dtype=torch.float32, device="meta")
    before = da.launches
    with pytest.raises(RuntimeError, match="decode_attention"):
        da.decode_attention(q, k, k, torch.zeros((b,)).to("meta"))
    assert da.launches == before


@pytest.mark.parametrize("cluster", da.CLUSTERS)
@pytest.mark.parametrize("tile_rows", [16, 7])
def test_device_split_covers_the_valid_rows_once(cluster, tile_rows):
    """The Python mirror of the device's split: for every length from 0 to
    past S_max (clamped as the device clamps it), the cluster's shares, in
    rank order, are consecutive, start at tile edges, and cover [0, n)
    exactly once; a block past the slot's rows gets an empty share."""
    s_max = 300
    for length in range(0, s_max + 8):
        n = min(max(length, 0), s_max)
        shares = [da.share_of(n, tile_rows, cluster, r)
                  for r in range(cluster)]
        covered = [row for r0, r1 in shares for row in range(r0, r1)]
        assert covered == list(range(n)), (n, shares)
        for r0, r1 in shares:
            assert r0 % tile_rows == 0 and r0 <= r1
        # shares differ by one tile at most
        tiles = [-(-(r1 - r0) // tile_rows) for r0, r1 in shares]
        assert max(tiles) - min(tiles) <= 1


def test_a_launch_passes_the_plan_and_no_workspace(monkeypatch):
    """Past ``_check``, one kernel call per ``decode_attention`` call, with
    the plan's cluster, tile rows and ring depth, and no workspace pointer;
    ``launches`` counts it."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(da, "_check", lambda *a: None)
    monkeypatch.setattr(da, "_kernel", lambda: kernel)
    monkeypatch.setattr(da, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    b, h, s_max, d = 8, 32, 512, 128
    q = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s_max, h, d), dtype=torch.bfloat16, device="meta")
    new = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device="meta")
    before = da.launches
    out = da.decode_attention(q, k, k, torch.full((b,), 160).to("meta"),
                              new, new)
    assert out.shape == q.shape and da.launches == before + 1
    (args,) = calls
    plan = da.launch_plan(b, h, h, s_max, d)
    assert len(args) == len(da._ARGTYPES[("decode_attention",
                                          "decode_attention")])
    assert args[7:13] == (1, b, h, h, s_max, d)
    assert args[-4:-1] == (plan.cluster, plan.tile_rows, plan.max_stages)


def test_ring_asks_the_library_for_the_launch_plans_ring(monkeypatch):
    """``ring`` passes the launch plan ``decode_attention`` would pass (the
    dtype's code, the shapes, cluster, tile rows and ring depth) and reads
    back the three ints the library writes: stages, shared memory and the
    clusters the card holds at once."""
    calls = []

    def query(*args):
        calls.append(args[:-1])
        out = ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))
        out[0], out[1], out[2] = 10, 45000, 330
        return 0

    monkeypatch.setattr(da, "_kernel", lambda name: query)
    monkeypatch.setattr(da, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    got = da.ring(torch.bfloat16, 8, 32, 32, 512, 128)
    assert got == {"stages": 10, "smem_bytes": 45000,
                   "clusters_at_once": 330}
    plan = da.launch_plan(8, 32, 32, 512, 128)
    assert calls == [(1, 8, 32, 32, 512, 128, plan.cluster, plan.tile_rows,
                      plan.max_stages)]
