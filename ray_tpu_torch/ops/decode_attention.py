"""Decode attention: one query token per sequence against its KV cache, a
hand-written CUDA C++ kernel for Hopper.

``decode_attention(q, k_cache, v_cache, lengths, k_new=None, v_new=None)``
attends q [B, 1, H, D] to the first ``lengths[b]`` rows (clamped to S_max)
of one layer's cache slices k_cache, v_cache [B, S_max, Hkv, D], and, when
k_new and v_new [B, 1, Hkv, D] are given, to that fresh row as one more
position (the "self" column). Scores are fp32 from the input dtype, the
softmax is fp32, and p is rounded to the dtype before the product with v;
the self term p_self * v_new is added in the dtype. With the self column and
``lengths = pos`` it is the reference's ``_attend_prefix_plus_self``
(``ray_tpu/models/generation.py:151-180``, the engine's per-slot step);
without it and with ``lengths = pos + 1`` its ``_attend_cached`` at one
query (``:61-76``, ``generate``'s loop). GQA (H a multiple of Hkv) reads
each kv head's rows once for all its q heads.

It replaces no Pallas kernel: the reference leaves the cached attention of
a decode step to XLA, which fuses it over the bf16 cache as it lies.
``csrc/decode_attention.cu`` does the same on the card, reading only each
slot's valid rows, once; the source says how.

``launch_plan`` is the kernels' launch: the sequence split into chunks so
that the card has blocks to run when B * Hkv is small. It depends on the
shapes and the card alone, so every sum's order is fixed.

Device rule: CPU tensors go to ``decode_attention_reference``, the dense
math the CPU tests hold against JAX. CUDA tensors launch the kernel, or
raise (``_check``); nothing falls back. ``launches`` counts kernel launches
(one per call; each call runs the source's three kernels).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, masked_attention, repeat_kv
from ray_tpu_torch.ops.flash_attention import _check_rc
from ray_tpu_torch.ops.int8_matmul import H100_SMS, _sms

# Kernel launches since import (or since a caller reset them).
launches = 0

_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256  # head dims: multiples of 8 up to this
BLOCKS_PER_SM = 4  # what the split of the sequence aims at
CHUNK_ALIGN = 64  # a chunk's rows: a multiple of this
MAX_Q_FLOATS = 48 * 1024 // 4  # a kv group's q in fp32 shared memory
MAX_GRID_ROWS = 65535  # B * H
_fns = {}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # q, k, v, lengths, k_new, v_new, out, workspace, dtype, B, H, Hkv,
    # S_max, D, k and v strides (batch, row, head), scale, n_chunks,
    # chunk_rows, stream
    ("decode_attention", "decode_attention"):
        [_P] * 8 + [_I] * 6 + [_I64] * 6 + [ctypes.c_float, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernels' launch: the cache's S_max rows in ``n_chunks`` chunks of
    ``chunk_rows`` (the scores and pv kernels run a block per chunk and kv
    head; a chunk at or past a slot's length exits); the workspace holds the
    fp32 scores [B, H, S_max + 1] and the partial sums [B, H, n_chunks, D].
    The source picks the threads per row and the heads per pv block from D
    and H / Hkv."""
    n_chunks: int
    chunk_rows: int
    workspace_floats: int


def launch_plan(b: int, h: int, hkv: int, s_max: int, d: int,
                sms: int = H100_SMS) -> Plan:
    """Chunks enough for ``BLOCKS_PER_SM`` scores blocks per SM (bench_400m
    decoding 8 sequences, 8 kv heads, 1089 rows: 9 chunks of 128), never
    below ``CHUNK_ALIGN`` rows each, and one when B * Hkv fills the card."""
    bh = b * hkv
    want = -(-BLOCKS_PER_SM * sms // bh)
    most = -(-s_max // CHUNK_ALIGN)
    n = max(1, min(want, most))
    rows = -(-s_max // n)
    rows = -(-rows // CHUNK_ALIGN) * CHUNK_ALIGN
    n = -(-s_max // rows)
    return Plan(n_chunks=n, chunk_rows=rows,
                workspace_floats=b * h * (s_max + 1) + b * h * n * d)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               k_new: Optional[torch.Tensor] = None,
                               v_new: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The plain version: dense fp32 scores over the whole cache, masked to
    each slot's first ``lengths[b]`` rows (NEG_INF elsewhere), softmax, p in
    q's dtype. Without the self column it is ``masked_attention``; with it,
    the self score joins the softmax as one more column, and its term
    p_self * v_new is added in the dtype (the reference's
    ``_attend_prefix_plus_self``, whose k_pos < pos is ``lengths = pos``)."""
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = k_pos[None, :] < lengths[:, None]  # [B, S_max]
    if k_new is None:
        return masked_attention(q, k_cache, v_cache, mask[:, None, None, :])
    n_rep = q.shape[2] // k_cache.shape[2]
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    self_score = torch.einsum(
        "bqhd,bqhd->bhq", q.float(), repeat_kv(k_new, n_rep).float()
    )[..., None] * scale  # [B,H,1,1]
    all_scores = torch.cat([scores, self_score], dim=-1)
    probs = torch.softmax(all_scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs[..., :-1], v)
    return out + probs[..., -1:].permute(0, 2, 1, 3) * repeat_kv(
        v_new, n_rep
    )


def _check(q, k_cache, v_cache, lengths, k_new, v_new) -> None:
    """What the kernel takes: every operand on one CUDA device, and
    operands that ``_check_operands`` passes."""
    ts = [q, k_cache, v_cache, lengths] + [t for t in (k_new, v_new)
                                           if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"decode_attention kernel needs every operand on one CUDA "
            f"device; got {sorted(str(d) for d in devs)}"
        )
    _check_operands(q, k_cache, v_cache, lengths, k_new, v_new)


def _check_operands(q, k_cache, v_cache, lengths, k_new, v_new) -> None:
    """q [B, 1, H, D] and the caches [B, S_max, Hkv, D] in one dtype (bf16
    or fp32), k_new and v_new [B, 1, Hkv, D] both or neither, lengths [B]
    integers; D a multiple of 8 up to 256, H a multiple of Hkv, the kv
    group's q within 48 KB as fp32, B * H within a grid's 65535 rows; the
    caches with a unit last stride, their other strides multiples of 8
    elements and a 16-byte aligned base (the kernels read 16 bytes a
    thread). Raises on anything else."""
    if q.dtype not in _SUPPORTED:
        raise TypeError(f"decode_attention kernel takes bf16 or fp32; got "
                        f"{q.dtype}")
    news = [t for t in (k_new, v_new) if t is not None]
    if len(news) == 1:
        raise ValueError("decode_attention takes k_new and v_new together")
    if any(t.dtype != q.dtype for t in [k_cache, v_cache, *news]):
        raise TypeError("decode_attention needs q, the caches, k_new and "
                        "v_new in one dtype")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention lengths must be integers; got "
                        f"{lengths.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention needs q [B, 1, H, D] and caches "
                         f"[B, S_max, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    b, _, h, d = q.shape
    _, s_max, hkv, dk = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b or dk != d
            or tuple(lengths.shape) != (b,)
            or any(tuple(t.shape) != (b, 1, hkv, d) for t in news)):
        raise ValueError(
            f"decode_attention shapes disagree: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}, lengths "
            f"{tuple(lengths.shape)}, new {[tuple(t.shape) for t in news]}")
    if d % 8 or not 8 <= d <= MAX_D or h % hkv or s_max < 1:
        raise ValueError(f"decode_attention kernel needs D a multiple of 8 "
                         f"up to {MAX_D} and H a multiple of Hkv; got D={d}, "
                         f"H={h}, Hkv={hkv}, S_max={s_max}")
    if (h // hkv) * d > MAX_Q_FLOATS or b * h > MAX_GRID_ROWS:
        raise ValueError(f"decode_attention kernel takes n_rep * D <= "
                         f"{MAX_Q_FLOATS} and B * H <= {MAX_GRID_ROWS}; got "
                         f"n_rep={h // hkv}, D={d}, B={b}, H={h}")
    for t in (k_cache, v_cache):
        strides = t.stride()
        if (strides[3] != 1 or any(st % 8 or st <= 0 for st in strides[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"decode_attention kernel needs caches with a unit last "
                f"stride, other strides multiples of 8 and a 16-byte aligned "
                f"base; got strides {t.stride()}")


def _kernel():
    fn = _fns.get("decode_attention")
    if fn is None:
        from ray_tpu_torch.ops.build import load

        fn = load("decode_attention").decode_attention
        fn.argtypes = _ARGTYPES[("decode_attention", "decode_attention")]
        fn.restype = ctypes.c_int
        _fns["decode_attention"] = fn
    return fn


def _dense_16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned base (a copy only if needed)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, 1, H, D] in q's dtype: the plain version for CPU tensors, else
    the kernel on the current stream. It neither synchronizes nor reads the
    host, and takes its workspace from the stream's allocator, so it can be
    captured in a CUDA graph."""
    global launches
    ts = [q, k_cache, v_cache, lengths] + [t for t in (k_new, v_new)
                                           if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          k_new, v_new)
    _check(q, k_cache, v_cache, lengths, k_new, v_new)
    b, _, h, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    kernel = _kernel()
    q = _dense_16(q)
    lengths = lengths.to(torch.int64).contiguous()
    if k_new is not None:
        k_new, v_new = _dense_16(k_new), _dense_16(v_new)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        plan = launch_plan(b, h, hkv, s_max, d, _sms(q.device))
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    lengths.data_ptr(),
                    None if k_new is None else k_new.data_ptr(),
                    None if v_new is None else v_new.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), _SUPPORTED[q.dtype], b, h,
                    hkv, s_max, d, *k_cache.stride()[:3],
                    *v_cache.stride()[:3], d ** -0.5, plan.n_chunks,
                    plan.chunk_rows, stream)
    _check_rc("decode_attention", rc)
    launches += 1
    return out
