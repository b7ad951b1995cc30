"""Flash attention, forward and backward: hand-written CUDA C++ kernels for
Hopper.

Port of ``ray_tpu/ops/flash_attention.py`` (``flash_attention`` :322,
``_fwd`` :120, ``_bwd`` :244, the ``custom_vjp`` at :306-319). Three kernels
replace the three Pallas TPU kernels:

- ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel`` (:72): causal (or full)
  softmax attention over [B, S, H, D] that never writes the S x S scores, and
  the row logsumexp ``lse`` the backward needs;
- ``csrc/flash_bwd.cu`` replaces ``_bwd_dq_kernel`` (:158) with its dQ kernel
  and ``_bwd_dkv_kernel`` (:197) with its dK/dV kernel, which recompute p
  from ``lse`` blockwise. The dQ kernel also computes delta = rowsum(dO * O)
  (the reference's jnp preprocess, :247) in its prologue and writes it for
  the dK/dV kernel, which runs after it.

In bf16 all three kernels run on Hopper's wgmma, fed by TMA copies through
tensor maps that the C entry points build per call over the operands as
they lie (``csrc/hopper.cuh``); the fp32 kernels read through strides with
plain loads.

The launches may be captured into a CUDA graph (the train step is): the
entry points copy the strides and the tensor maps into the kernels'
by-value parameters, so a replay reads no host memory, only the operands'
device memory, which a graph's pool keeps at fixed addresses; and each
kernel's shared-memory limit is set once per device, at its first,
uncaptured launch (``flash_common.cuh``).

``flash_attention`` is differentiable: with gradients enabled and an input
that requires grad it goes through ``_FlashAttention``, the counterpart of
``custom_vjp``, which saves (q, k, v, o, lse) and runs both backward kernels.

Device rule: tensors on the CPU go to the plain PyTorch versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference``; per
kernel also ``flash_bwd_dq_reference`` and ``flash_attention_delta``), which
the CPU tests hold against JAX. CUDA tensors launch the kernels, or raise;
nothing falls back. ``launches``, ``launches_bwd_dq`` and
``launches_bwd_dkv`` count kernel launches, so a run can show its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ray_tpu_torch.ops.attention import NEG_INF, attention_per_shard, repeat_kv

# Kernel launches since import (or since a caller reset them).
launches = 0  # flash_fwd
launches_bwd_dq = 0  # flash_bwd_dq
launches_bwd_dkv = 0  # flash_bwd_dkv

_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_fns = {}


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: dense fp32 scores, NEG_INF
    mask, softmax and logsumexp. Returns (o in q's dtype [B, S, H, D],
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


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, laid out [B, H, S] as lse: the plain
    version of what the dQ kernel computes in its prologue."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_reference_terms(q, k, v, o, lse, do, causal):
    """What both plain backward versions share (``_bwd``, :244): dense fp32
    scores with the NEG_INF mask, delta = rowsum(dO * O), p = exp(s - lse),
    ds = p (dp - delta) scale, with ds rounded to the input dtype as the TPU
    kernels round it before its products. Returns fp32 (q, k, v, dO with kv
    heads repeated; delta [B, H, S]; p, ds [B, H, S, S])."""
    s, d = q.shape[1], q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    dt = q.dtype
    scale = d ** -0.5
    qf = q.float()
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    dof = do.to(dt).float()
    delta = flash_attention_delta(o, dof)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    return qf, kf, dof, delta, p, ds


def flash_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dQ kernel: (dq in q's dtype [B, S, H, D],
    delta fp32 [B, H, S]), rounded as ``flash_attention_bwd_reference``
    rounds them."""
    _qf, kf, _dof, delta, _p, ds = _bwd_reference_terms(q, k, v, o, lse, do,
                                                        causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype), delta


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of both backward kernels (``_bwd``, :244), from
    ``_bwd_reference_terms``; p is rounded to the input dtype before p^T dO,
    as the TPU kernel does. dK and dV sum over the n_rep q heads of each kv
    head (GQA). Returns (dq, dk, dv), each in its input's dtype."""
    qf, kf, dof, _delta, p, ds = _bwd_reference_terms(q, k, v, o, lse, do,
                                                      causal)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dk = dk.reshape(b, s, hkv, h // hkv, d).sum(3)
    dv = dv.reshape(b, s, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
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


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself when every kernel can read it through its strides, else a
    contiguous copy. The rules are TMA's, since the bf16 forward and dK/dV
    kernels copy tiles with TMA through a tensor map over x as it lies, and
    cuTensorMapEncodeTiled refuses anything else: a unit last stride, a
    16-byte aligned base, and batch, sequence and head strides that are
    positive multiples of 16 bytes. The kernels that load through strides
    (dQ, fp32) need less, so one rule serves all. The copy is a clone, not
    ``contiguous()``, which would hand back a contiguous tensor whose base
    is misaligned as it is."""
    nbytes = x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st > 0 and st * nbytes % 16 == 0 for st in x.stride()[:3]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


# Return codes of the entry points beside CUDA's own errors (csrc/hopper.cuh).
_ERR_NO_ENCODE_ENTRY_POINT = 10000
_ERR_ENCODE = 20000


def _check_rc(name: str, rc: int) -> None:
    if rc == 0:
        return
    if rc == _ERR_NO_ENCODE_ENTRY_POINT:
        raise RuntimeError(f"{name}: the CUDA driver has no "
                           "cuTensorMapEncodeTiled entry point")
    if rc >= _ERR_ENCODE:
        raise RuntimeError(f"{name}: tensor map encode failed: CUresult "
                           f"{rc - _ERR_ENCODE}")
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # q, k, v, o, lse, dtype, B, S, H, Hkv, D, 12 strides, scale, causal, stream
    ("flash_fwd", "flash_fwd"):
        [_P] * 5 + [_I] * 6 + [_I64] * 12 + [ctypes.c_float, _I, _P],
    # q, k, v, o, dout, lse, delta (written), dq, dtype, B, S, H, Hkv, D,
    # strides* (15), scale, causal, stream
    ("flash_bwd", "flash_bwd_dq"):
        [_P] * 8 + [_I] * 6 + [_P, ctypes.c_float, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, dtype, B, S, H, Hkv, D, strides*
    # (12), scale, causal, stream
    ("flash_bwd", "flash_bwd_dkv"):
        [_P] * 8 + [_I] * 6 + [_P, ctypes.c_float, _I, _P],
    # D: dynamic shared memory of the bf16 kernel for that head dim
    ("flash_fwd", "flash_fwd_smem_bytes"): [_I],
    ("flash_bwd", "flash_bwd_dq_smem_bytes"): [_I],
    ("flash_bwd", "flash_bwd_dkv_smem_bytes"): [_I],
}


def _kernel(lib: str, name: str):
    fn = _fns.get(name)
    if fn is None:
        from ray_tpu_torch.ops.build import load

        fn = getattr(load(lib), name)
        fn.argtypes = _ARGTYPES[(lib, name)]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def kernel_smem_bytes(d: int) -> dict:
    """Dynamic shared memory (bytes) of the bf16 forward, dQ and dK/dV
    kernels at head dim ``d``, as their entry points launch them (builds the
    libraries if needed)."""
    return {"flash_fwd": _kernel("flash_fwd", "flash_fwd_smem_bytes")(d),
            "flash_bwd_dq": _kernel("flash_bwd", "flash_bwd_dq_smem_bytes")(d),
            "flash_bwd_dkv": _kernel("flash_bwd",
                                     "flash_bwd_dkv_smem_bytes")(d)}


def _check_launch(q, k, v, *more) -> None:
    """What every kernel needs: one CUDA device, one supported dtype, a head
    dim the templates cover, and a grid that fits."""
    devs = {t.device for t in (q, k, v, *more)}
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
    if d % 16 or not 16 <= d <= _MAX_D:
        raise ValueError(
            f"flash attention kernel needs a head dim that is a multiple of 16 "
            f"up to {_MAX_D}; got {d}"
        )
    if b * h > 65535 or s == 0:
        raise ValueError(f"flash attention kernel cannot take B*H={b * h}, S={s}")


def _launch(q, k, v, causal: bool):
    global launches
    _check_launch(q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_fwd", "flash_fwd")
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
    _check_rc("flash_fwd", rc)
    return o, lse


def _bwd_args(q, k, v, do, causal: bool, o=None):
    """The operands of a backward kernel as it reads them, (q, k, v, do) and
    o when given (the dQ kernel's), and the ctypes arguments both kernels
    share: (dtype, B, S, H, Hkv, D), (strides, scale, causal), and the
    strides' buffer, which must live until the launch. The strides are the
    batch, sequence and head strides of each operand in that order."""
    b, s, h, d = q.shape
    if do.shape != q.shape or (o is not None and o.shape != q.shape):
        raise ValueError(f"do and o must have q's shape {tuple(q.shape)}")
    more = () if o is None else (o.to(q.dtype),)
    ops = tuple(_kernel_operand(t) for t in (q, k, v, do.to(q.dtype), *more))
    st = [x for t in ops for x in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(st))(*st)
    shape = (_SUPPORTED[q.dtype], b, s, h, k.shape[2], d)
    tail = (ctypes.cast(strides, ctypes.c_void_p), d ** -0.5, int(causal))
    return ops, shape, tail, strides


def _run(name: str, args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel("flash_bwd", name)(*args, stream)
    _check_rc(name, rc)


def flash_bwd_dq_kernel(q, k, v, o, do, lse, causal: bool = True):
    """(dQ [B, S, H, D] in q's dtype, delta fp32 [B, H, S]) from the dQ
    kernel (CUDA tensors only), which computes delta = rowsum(dO * O) in its
    prologue; lse is fp32 [B, H, S]."""
    global launches_bwd_dq
    _check_launch(q, k, v, o, do, lse)
    (q, k, v, do, o), shape, tail, _keep = _bwd_args(q, k, v, do, causal, o)
    lse = lse.contiguous()
    b, s, h, _d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _run("flash_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), *shape, *tail),
         q.device)
    launches_bwd_dq += 1
    return dq, delta


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV) [B, S, Hkv, D] in k's and v's dtypes from the dK/dV kernel
    (CUDA tensors only), summed over the q heads of each kv head; lse and
    delta (as the dQ kernel returns it) are fp32 [B, H, S]."""
    global launches_bwd_dkv
    _check_launch(q, k, v, do, lse, delta)
    (q, k, v, do), shape, tail, _keep = _bwd_args(q, k, v, do, causal)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _run("flash_bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), *shape, *tail),
         q.device)
    launches_bwd_dkv += 1
    return dk, dv


def _fwd(q, k, v, causal: bool):
    if _on_cpu(q, k, v):
        return flash_attention_fwd_reference(q, k, v, causal)
    return _launch(q, k, v, causal)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs and residuals (o, lse) and the
    output grad do: the plain version for CPU tensors, else two kernels, dQ
    (which writes delta) and then dK/dV on that delta."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    dq, delta = flash_bwd_dq_kernel(q, k, v, o, do, lse, causal)
    return (dq, *flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    """The counterpart of ``_flash``'s ``custom_vjp``: the forward kernel,
    saving (q, k, v, o, lse); the backward kernels. lse is an output for
    callers that want it, and carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D], k/v [B, S, Hkv, D] (Hkv divides H) -> (o [B, S, H, D]
    in q's dtype, lse fp32 [B, H, S]). Differentiable in q, k, v when
    gradients are enabled and one of them requires grad."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _fwd(q, k, v, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
) -> torch.Tensor:
    """Flash attention on one device: [B, S, H, D] in, [B, S, H, D] out."""
    return flash_attention_fwd(q, k, v, causal)[0]


def flash_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
    dp_axis=("dp", "ep"), tp_axis: str = "tp", **kw,
) -> torch.Tensor:
    """Flash attention over a mesh (``ray_tpu/ops/flash_attention.py:361``):
    each rank runs ``flash_attention`` (the kernels, or on the CPU their
    plain versions) on its own [B/dp, S, H/tp, D] shard, through
    ``local_map`` (``attention_per_shard``), as the reference runs it under
    ``shard_map``. q, k and v are DTensors on ``mesh`` (redistributed first
    when they lie otherwise: batch over ``dp_axis``, heads over
    ``tp_axis``); so is the output. Requires sp = 1 (sequence-parallel
    attention is ring attention's)."""
    from ray_tpu_torch.parallel.mesh import axis_size

    if axis_size(mesh, "sp") != 1:
        raise ValueError("flash attention requires sp=1; use attn_impl='ring'")
    return attention_per_shard(functools.partial(flash_attention, **kw),
                               q, k, v, mesh=mesh, dp_axis=dp_axis,
                               tp_axis=tp_axis)
