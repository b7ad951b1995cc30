"""Flash attention forward: a hand-written CUDA C++ kernel for Hopper.

Port of the forward half of ``ray_tpu/ops/flash_attention.py``
(``flash_attention`` :322, ``_fwd`` :120). The kernel, ``csrc/flash_fwd.cu``,
replaces the Pallas TPU kernel ``_fwd_kernel`` (:72): causal (or full)
softmax attention over [B, S, H, D] that never writes the S x S scores, and
the row logsumexp ``lse`` that the backward kernels will need.

Device rule: tensors on the CPU go to the plain PyTorch version
(``flash_attention_fwd_reference``), which the CPU tests hold against JAX.
CUDA tensors launch the kernel, or raise; nothing falls back. ``launches``
counts kernel launches, so a run can show its path went through the kernel.

The backward kernels come with the training slice: with gradients enabled
and an input that requires grad, the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.attention import NEG_INF, repeat_kv

launches = 0  # kernel launches since import (or since a caller reset it)

_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_fn = None


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: dense fp32 scores, NEG_INF mask,
    softmax and logsumexp. Returns (o in q's dtype [B, S, H, D],
    lse fp32 [B, H, S])."""
    s, d = q.shape[1], q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep).float()
    v = repeat_kv(v, n_rep).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * d ** -0.5
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return o.to(q.dtype), lse


def _check(q, k, v) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward is not ported yet: it comes with the "
            "training slice; run the forward under torch.no_grad() or "
            "torch.inference_mode()"
        )
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"expected q [B,S,H,D] and k, v [B,S,Hkv,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or h % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: need the "
            "same B, S, D and kv heads dividing the q heads"
        )


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through its strides (unit last
    stride, 16-byte aligned rows), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in x.stride()[:3]))
    return x if ok else x.contiguous()


def _kernel():
    global _fn
    if _fn is None:
        from ray_tpu_torch.ops.build import load

        fn = load("flash_fwd").flash_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p] * 5 + [i] * 6 + [i64] * 12
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, causal: bool):
    global launches
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"flash attention kernel needs q, k, v on one CUDA device; got "
            f"{sorted(str(d) for d in devs)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUPPORTED:
        raise TypeError(
            f"flash attention kernel takes bfloat16 or float32 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if d % 16 or not 16 <= d <= _MAX_D:
        raise ValueError(
            f"flash attention kernel needs a head dim that is a multiple of 16 "
            f"up to {_MAX_D}; got {d}"
        )
    if b * h > 65535 or s == 0:
        raise ValueError(f"flash attention kernel cannot take B*H={b * h}, S={s}")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _SUPPORTED[q.dtype], b, s, h, hkv, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                o.stride(0), o.stride(1), o.stride(2),
                d ** -0.5, int(causal), stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D], k/v [B, S, Hkv, D] (Hkv divides H) -> (o [B, S, H, D]
    in q's dtype, lse fp32 [B, H, S])."""
    _check(q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_fwd_reference(q, k, v, causal)
    return _launch(q, k, v, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
) -> torch.Tensor:
    """Flash attention on one device: [B, S, H, D] in, [B, S, H, D] out."""
    return flash_attention_fwd(q, k, v, causal)[0]
