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
card: swap-AB ``wgmma`` with the weight dequantized in registers as the
plain version rounds it (bf16(q) * bf16(s) rounded to bf16, exact in fp32
before the rounding), x read from shared memory, both fed by TMA through an
``mbarrier`` ring, and K split over the blocks of each column strip, whose
fp32 partials a second small kernel adds in order (in a workspace this
wrapper allocates); only the order of the sums differs from the plain
version. Decoding 8 slots
it is bound by q's bytes: a serve_7b decode step reads 6.44 GB of them,
1.92 ms at 3.35 TB/s. The source says how its design meets that.

``launch_plan`` is the launch of one bf16 product: its K split depends on
K and N alone, so a row's sum order never depends on M.

Device rule: CPU tensors go to ``int8_matmul_reference``, which the CPU tests
hold against JAX. CUDA tensors launch the kernel, or raise (``_check``);
nothing falls back. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ray_tpu_torch.ops.flash_attention import _check_rc

# Kernel launches since import (or since a caller reset them).
launches = 0

_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}
K_MULTIPLE = 64  # one ring stage: 4 wgmma k steps
N_MULTIPLE = 32  # the fp32 kernel's block columns; the bf16 kernel masks
_fns = {}

# The bf16 kernel's constants (csrc/int8_matmul.cu).
TILE_COLS = 128  # output columns per block: one 128-byte q box row
STAGE_ROWS = 64  # k rows per ring stage
MAX_ROWS = 128  # rows of x per block
WGMMA_NS = (8, 16, 32, 64, 128)  # wgmma N's the kernel is built for
MAX_SPLIT = 8  # blocks per strip
SMEM_LIMIT = 232448  # a block's dynamic shared memory on sm_90
H100_SMS = 132

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, q, s, y, dtype, M, K, N, stream, workspace, split, stages, wgmma_n
    ("int8_matmul", "int8_matmul"): [_P] * 4 + [_I] * 4 + [_P] * 2 + [_I] * 3,
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch of one bf16 product: ``grid`` blocks, ``tile_cols`` output
    columns by up to 128 rows of x each (``m_tiles`` tiles of rows); the
    ``split`` blocks of a column strip sum k rows [r K / split,
    (r + 1) K / split) each (r their rank) through a ring of ``stages``
    stages; ``wgmma_n`` is wgmma's N (rows of x per block, padded);
    ``smem_bytes`` a block's dynamic shared memory. With split > 1 each
    block writes its fp32 partial to a workspace of ``workspace_bytes``
    ([split, M, N]) and a second pass adds them in rank order."""
    tile_cols: int
    split: int
    stages: int
    wgmma_n: int
    m_tiles: int
    grid: tuple
    smem_bytes: int
    workspace_bytes: int


def k_split(k: int, n: int, sms: int = H100_SMS) -> int:
    """Blocks per column strip splitting K: doubled while K's stages divide
    evenly and the card has an SM for every block of the product (N 4096:
    32 strips by 4, 128 blocks). A function of K and N (and the card) only:
    it fixes the order of every row's sum."""
    strips, chunks = -(-n // TILE_COLS), k // STAGE_ROWS
    split = 1
    while (split * 2 <= MAX_SPLIT and chunks % (split * 2) == 0
           and strips * split * 2 <= sms):
        split *= 2
    return split


def launch_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> Plan:
    """The bf16 kernel's launch for x [m, k] @ q [k, n]: the K split of
    ``k_split``; wgmma's N, the smallest of ``WGMMA_NS`` that holds
    min(m, 128) rows; the ring as deep as a block's shared memory allows (at
    most the block's own stages of 64 k rows)."""
    split = k_split(k, n, sms)
    nw = next(w for w in WGMMA_NS if w >= min(m, MAX_ROWS))
    stage = STAGE_ROWS * TILE_COLS + nw * 128  # q box + x box
    red = nw * (TILE_COLS + 4) * 4  # the staged fp32 partial
    fit = (SMEM_LIMIT - 1024) // (stage + 16)
    stages = min(fit, k // split // STAGE_ROWS)
    smem = 1024 + max(stages * stage, red) + 16 * stages
    m_tiles = -(-m // MAX_ROWS)
    return Plan(tile_cols=TILE_COLS, split=split, stages=stages, wgmma_n=nw,
                m_tiles=m_tiles, grid=(split * -(-n // TILE_COLS), m_tiles),
                smem_bytes=smem,
                workspace_bytes=4 * split * m * n if split > 1 else 0)


_SMS = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
    contiguous; M >= 1, K a multiple of 64 (a ring stage of 64 k rows) and N
    of 32 (the fp32 kernel's block; the bf16 kernel masks its 128-column
    strips); x and q 16-byte aligned (TMA's rule for a tensor map's base).
    Raises on anything else."""
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
    kernel = _kernel()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        plan = launch_plan(m, k, n, _sms(x.device))
        # the bf16 kernel's partials; freed after the launch, which the
        # caching allocator orders after the kernels on this stream
        ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=x.device)
              if x.dtype == torch.bfloat16 and plan.workspace_bytes else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernel(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                    _SUPPORTED[x.dtype], m, k, n, stream,
                    None if ws is None else ws.data_ptr(), plan.split,
                    plan.stages, plan.wgmma_n)
    _check_rc("int8_matmul", rc)
    launches += 1
    return y
