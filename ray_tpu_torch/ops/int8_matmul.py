"""Int8 weight-only matrix product: a hand-written CUDA C++ kernel for Hopper.

``int8_matmul(x, q, s)`` computes ``x @ (q.to(x.dtype) * s.to(x.dtype))``
for x [M, K] (bf16, the serving dtype, or fp32), q [K, N] int8 as stored and
s holding N fp32 scales, one per output column. Every int8 weight of
``models/quant.py`` (``_LAYER_RULES``: wq, wk, wv, attention wo, MLP wi and
wo) contracts its leading axes and scales its trailing ones, so each
flattens to [K, N] and its scale to [N] without a copy.

It replaces no Pallas kernel: the reference fuses the dequant
(``QTensor.astype``, ``ray_tpu/models/quant.py:43-44``) into the consuming
einsum (``ray_tpu/models/transformer.py:300-327``) through XLA, so decode
streams only the int8 bytes. ``csrc/int8_matmul.cu`` does the same on the
card: it streams q through shared memory once per 64 rows of x and
dequantizes in registers, as the plain version rounds (bf16(q) * bf16(s) rounded to bf16, exact in fp32
before the rounding), so only the order of the sums differs. Decoding 8
slots it is bound by q's bytes: a serve_7b decode step reads 6.44 GB of
them, 1.92 ms at 3.35 TB/s. The source says how its design meets that.

Device rule: CPU tensors go to ``int8_matmul_reference``, which the CPU tests
hold against JAX. CUDA tensors launch the kernel, or raise (``_check``);
nothing falls back. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since import (or since a caller reset them).
launches = 0

_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
K_MULTIPLE = 64  # one stage of a warp's ring: 4 mma k steps
N_MULTIPLE = 32  # one block's columns
_fns = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, q, s, y, dtype, M, K, N, stream
    ("int8_matmul", "int8_matmul"): [_P] * 4 + [_I] * 4 + [_P],
}


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """The plain version: dequantize as ``QTensor.to(dtype)`` does, then one
    matrix product. x [M, K], q [K, N] int8, s N scales -> [M, N]."""
    return x @ (q.to(x.dtype) * s.reshape(-1).to(x.dtype))


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """What the kernel takes: x, q, s on one CUDA device, and operands that
    ``_check_operands`` passes."""
    devs = {t.device for t in (x, q, s)}
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(
            f"int8_matmul kernel needs x, q, s on one CUDA device; got "
            f"{sorted(str(d) for d in devs)}"
        )
    _check_operands(x, q, s)


def _check_operands(x: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor) -> None:
    """x [M, K] bf16 or fp32; q [K, N] int8; s N fp32 values; all three
    contiguous; M >= 1, K a multiple of 64 (a stage of 64 k rows) and N of
    32 (one block's columns); x and q 16-byte aligned (the kernel copies
    16-byte chunks of both). Raises on anything else."""
    if x.dtype not in _SUPPORTED or q.dtype != torch.int8 or (
            s.dtype != torch.float32):
        raise TypeError(
            f"int8_matmul kernel takes bf16 or fp32 x, int8 q, fp32 s; got "
            f"{x.dtype}, {q.dtype}, {s.dtype}"
        )
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] or (
            s.numel() != q.shape[1]):
        raise ValueError(
            f"int8_matmul needs x [M, K], q [K, N], N scales; got "
            f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(s.shape)}"
        )
    m, k = x.shape
    n = q.shape[1]
    if m == 0 or k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(
            f"int8_matmul kernel needs M >= 1, K a multiple of {K_MULTIPLE} "
            f"and N of {N_MULTIPLE}; got M={m}, K={k}, N={n}"
        )
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul kernel needs contiguous x, q and s")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs x and q 16-byte aligned")


def _kernel():
    fn = _fns.get("int8_matmul")
    if fn is None:
        from ray_tpu_torch.ops.build import load

        fn = load("int8_matmul").int8_matmul
        fn.argtypes = _ARGTYPES[("int8_matmul", "int8_matmul")]
        fn.restype = ctypes.c_int
        _fns["int8_matmul"] = fn
    return fn


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (q [K, N] int8 scaled by s per column) -> [M, N] in x's
    dtype: the plain version for CPU tensors, else the kernel on the current
    stream (it neither allocates nor synchronizes, so it can be captured in
    a CUDA graph)."""
    global launches
    if all(t.device.type == "cpu" for t in (x, q, s)):
        return int8_matmul_reference(x, q, s)
    _check(x, q, s)
    m, k = x.shape
    n = q.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                       _SUPPORTED[x.dtype], m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
