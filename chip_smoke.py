"""On-card smoke of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase (what a check runs)
    timeout 300 python3 chip_smoke.py kernel   # the kernel phases only
    timeout 300 python3 chip_smoke.py decode_kernel  # the decode kernel only
    timeout 600 python3 chip_smoke.py serve_7b # the serve_7b phase only
    timeout 600 python3 chip_smoke.py train    # the train phase only
    timeout 600 python3 chip_smoke.py inference  # the inference phase only
    timeout 600 python3 chip_smoke.py mesh     # the mesh phase only
    timeout 700 python3 chip_smoke.py moe      # the moe phase only
    timeout 450 python3 chip_smoke.py seq      # the seq phase only
    timeout 450 python3 chip_smoke.py pipe     # the pipe phase only
    python3 chip_smoke.py multicard            # four cards; not in the default run

Run from the repo root on a machine with one CUDA card. Thirteen phases; any
failure raises and the script exits non-zero without a result line. With
the argument ``kernel`` (or ``decode_kernel``, ``serve_7b``, ``train``,
``inference``, ``mesh``, ``moe``, ``seq``, ``pipe``) it runs the kernel
phases (or that phase, ``decode_kernel`` building its kernel first) alone
and prints no result line: the first call after a kernel (or that path)
changes, under ``timeout``. ``multicard`` needs four cards (it raises with
fewer): it starts four NCCL ranks of this script, one per card
(``multicard-rank <rank> <world> <port>``), trains ``bench_400m`` at
[8, 2048] with ring attention over dp 2 x sp 2, Ulysses over sp 2 x tp 2,
4 experts over ep 2 x dp 2, and, with dense attention, as a pipeline: 1F1B
over pp 4 (8 microbatches), GPipe over dp 2 x pp 2 (4) and 1F1B over pp 2 x
tp 2 (4); 4 steps each (warm-up, capture, two replays), each step's loss
within ``MESH_LOSS_RTOL`` of the one-card run of the same seed and batches
(dense attention for ring, Ulysses and the pipelines, the same MoE model
for the experts), runs ``dryrun_multidevice(4)`` (parts 1, 2, 2c and 3),
and prints replay ms, the device ms in NCCL collectives and the peak memory
per layout.

1. kernel: builds every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (nvcc,
   sm_90a, one process per source, all at once) and prints ptxas's
   registers, shared memory and spills for each; holds the forward kernel
   and the two backward kernels (dQ with the delta it fuses, dK/dV on that
   delta) against their plain PyTorch versions on the card, at the 400M
   model's shapes and at others (ragged S, GQA, fp32, and the head dims the
   kernels pad: 16, 32, 64, 96, 192, 256), and times kernels, plain
   versions and the library yardsticks (SDPA forward and backward) at the
   400M model's shapes (CUDA events, after warm-up).
2. int8_kernel: ``int8_matmul`` against its plain version under a stated
   bound, at serve_7b's six weight shapes at M 8 (decode) and 128 (prefill)
   in bf16 and fp32, at ragged M (1, 3, 17, and the fp32 check's 2, 40, 64)
   and at ``tiny``'s widths; every case also bit-equal across two launches
   and with row 0 computed alone. Device times inside CUDA graphs (kernel,
   plain version, ``torch._weight_int8pack_mm``, a bf16 product over
   pre-dequantized weights) per shape, per decode step and per prefill;
   ptxas's registers and spills of the int8 kernels, and each shape's
   launch plan (K split, ring stages, wgmma N, workspace).
3. decode_kernel: ``decode_attention`` against its plain version under
   ``DECODE_RTOL``, in bf16 and fp32, at D 16, 64, 96, 128, 192 and 256,
   n_rep 1, 2, 3, 4 and 8, clusters of 1, 2, 4 and 8 blocks, with and
   without the self column, at lengths 0 (self alone), 1, below the
   cluster's size, around every tile edge (and so every edge of a
   cluster's shares), S_max - 1, S_max and past it; in every case the
   rows at or past a slot's length set to NaN, and to zeros, give the same
   output bit for bit, and so does a second launch. Then at the main
   paths' own shapes (serve_7b's engine step: 8 slots at position 160 of
   512, self column; bench.py's inference leg: lengths 1025..1088 of 1089;
   the 400M engine's step: 8 slots at 300 of 1024, self column), each with
   one more call at ragged
   per-slot lengths: the kernel against its plain version on the same
   operands in bf16 and fp32, and device times inside CUDA graphs (kernel,
   plain version, SDPA with a boolean mask, bound) per call and per step,
   with each shape's launch plan (cluster, tile rows, ring stages, shared
   memory, clusters the card holds at once: all of the grid's, checked),
   the host cost of an eager call, and ptxas's registers and spills.
4. forward: ``bench_400m`` (full width: 24 layers, d_model 1024, 8 heads x
   128) in bf16 from a seeded random init, ``forward`` and ``loss_fn`` on
   tokens [8, 2048]; the flash kernel must launch exactly once per layer and
   the logits must agree with the dense-attention forward.
5. train: ``bench_400m`` (remat "dots", flash) trained as the reference's
   loops train it: seeded numpy batches [8, 2048] (a cycle of 4) through
   the port's pump (``data.device_batches``) into ``make_train_step``,
   which runs step 1 eagerly (warm-up), captures step 2 as one CUDA graph
   and replays it from then on; a ``save_sharded`` checkpoint after step 8,
   written while steps 9-14 train. Checks: the flash wrappers count 48 /
   24 / 24 for the eager step and for the capture and nothing for the 13
   replays, and one profiled replay launches the kernels 48 / 24 / 24
   times by name; loss and grad norm finite, the loss of the last cycle
   below the first; eager steps from a state of the same seed equal the
   captured ones bit for bit; the checkpoint restored into a fresh state
   equals the saved state bit for bit, and its next step equals the
   original's, every tensor included. Printed: replay ms (CUDA events),
   tokens/s, MFU, host ms per call, wall ms per replay, device-busy share
   of a replay, peak memory eager and captured, eager step ms, the pump's
   prefetch and hidden host time, and the checkpoint's bytes, snapshot ms,
   write and restore seconds.
6. mesh: ``bench_400m`` as the train phase trains it, over a one-card mesh:
   a world-size-1 NCCL process group, ``build_mesh(MeshConfig(dp=1))``,
   ``make_sharded_state`` / ``make_train_step`` with ``mesh=`` fed by
   ``device_batches(..., sharding=batch_sharding(mesh))``, under
   ``DEFAULT_RULES`` and then ``FSDP_RULES``, 6 steps each (step 1 the
   warm-up, step 2 the capture, steps 3-6 replays), beside the one-device
   step from the same seed and batches. Checks: losses, grad norms and
   every parameter after step 6 equal the one-device step's (expected bit
   for bit: every placement is whole at world size 1 and no collective
   runs; a difference is printed and the loss must stay within
   ``MESH_LOSS_RTOL``); one profiled replay of each launches the flash
   kernels 48 / 24 / 24 times by name; the mesh state's checkpoint restores
   into a one-device state bit for bit, and that state's into a mesh state.
   Printed: replay ms (CUDA events) and peak memory of the one-device step
   and of each rules table.
7. moe: ``bench_400m`` with 4 experts, top-2, capacity factor 2 (971.6 M
   parameters) trained as the mesh phase trains ``bench_400m``: 6 steps at
   [8, 2048] through the pump (steps 3-6 replays), 48 / 24 / 24 flash
   launches per replay by name, losses finite and falling over the cycle,
   three eager steps equal to the captured ones bit for bit, the same
   training over a one-card mesh equal to one device bit for bit; layer 0's
   ``moe_ffn`` at full width against its one-hot plain version (bf16, one
   ulp) with the same picks dropped; picks dropped per layer; greedy
   ``generate`` (8 x 128 prompt, 16 new tokens) through its graphs equal
   to its bodies run uncaptured. Printed: replay ms, tokens/s, peak
   memory, device ms by kind of a profiled replay.
8. seq: over a one-card mesh, ``bench_400m``'s forward with ring and with
   Ulysses attention against the dense-attention forward (the forward
   phase's tolerance), ``ulysses_attention(..., attn_impl="flash")`` at
   [8, 2048, 8, 128] bf16 equal to ``flash_attention`` bit for bit, and 3
   train steps of each (warm-up, capture, replay): finite losses, replay
   ms and peak memory.
9. pipe: ``bench_400m`` with dense attention (the pipeline's stages run
   dense attention) through ``make_pipeline_train_step`` over a one-card
   mesh, 8 microbatches of one row, under GPipe and under 1F1B: 6 steps
   each through the pump (warm-up, capture, replays). At pp = 1 the
   schedule, its ring buffer and the scoring run, but no hop. Checks: no
   flash kernel in a profiled replay; the first loss within
   ``MESH_LOSS_RTOL`` of the non-pipelined dense loss on the same weights
   and batch; three eager steps from a fresh state equal the captured ones
   bit for bit; 1F1B's peak memory during an eager step at most 1.05 times
   GPipe's. Printed: replay ms, tokens/s, MFU, peaks, device ms and
   launches by kind.
10. grad: the flash grads of ``loss_fn`` against the dense-attention grads,
   at the 400M width with 2 layers in fp32 (TF32 off), and the full-depth
   bf16 train steps' losses and grad norms, flash against dense (step 1
   held to a tolerance, the rest reported).
11. inference: bench.py's inference leg (``measure_inference``) on the port:
   ``bench_400m`` with dense attention, no remat, bf16, 8 prompts of 1024
   tokens, 64 new tokens, max_len 1089. ``prefill`` (TTFT) and
   ``decode_loop`` (decode tokens/s) timed at the second call of each, the
   first having captured its programs; the timed loop runs no eager decode
   step and replays its captured blocks of steps, whose graphs and a
   profiled replay hold one decode attention call per layer per step (24).
   The first and second calls of a 256- and a 1023-step loop are timed
   (capture cost and memory). The captured ``generate`` must give the same
   greedy tokens as its bodies run uncaptured on the card; in float32 with
   TF32 off, the engine's decode program, captured with
   ``RAYTPU_DECODE_DEFERRED_WRITES`` unset and set, gives ``generate``'s
   tokens (the two structures bit for bit alike).
12. serve: ``LLMEngine`` over ``bench_400m`` in bf16 answers 8 concurrent
   greedy requests from client threads through its CUDA graphs (graph
   replays > 0, no decode step run eagerly during the traffic, one decode
   attention launch per layer per decode step); one
   temperature-1 request twice gives the same tokens; the sampler's hash
   bits equal on the CPU and the card; a decode block replayed from a graph
   and run eagerly, each profiled; then, in float32 with TF32 off, the
   engine's greedy tokens for 3 interleaved prompts must EQUAL
   ``generate``'s.
13. serve_7b: ``serve_7b`` (6.7B parameters, 32 layers, d_model 4096, 32
   heads x 128, full width and depth) from ``init_params_int8`` on the card
   (weight bytes and peak memory printed), served through ``LLMEngine``'s
   graphs at bench.py's shape (8 slots, max_len 512, prefill bucket 128,
   blocks of 8 steps): 8 concurrent greedy requests of 128-token prompts
   and 64 new tokens (TTFT median and max, decode tokens/s with 8 slots
   active), the same graph and sampling checks as serve, int8_matmul
   launches per decode step counted over the graphs' replays (6 per layer)
   and decode attention launches (1 per layer),
   and the profiled decode blocks (graph and eager; device time by kind;
   the graph's block also captured with ``RAYTPU_DECODE_DEFERRED_WRITES=1``
   and timed in turns with the default; the plain dequant's time per step,
   which the kernel took off the path);
   the same on bf16 weights of the same init (no int8 launch). Checks: 8
   valid 64-token streams each time; in float32 with TF32 off, the engine's
   greedy tokens EQUAL ``generate``'s on the int8 weights at full depth
   (through the graphs and the kernel); int8 against bf16 logits on one
   128-token prompt within ``INT8_LOGITS_RTOL`` at 2 layers (full depth
   reported). No flash kernel runs here (dense attention, as in JAX): the
   phase reports ``flash_launches`` 0.

Prints one JSON line per phase, the card's name and power limit (as
nvidia-smi reports them), a ``kernels`` JSON line (five kernels; the int8
and decode attention kernels' numbers are per serve_7b decode step, with
the int8 kernel's per-prefill time and the decode attention kernel's per
inference-leg step beside them; the flash kernels' launches per
``bench_400m`` train step, per mesh step and per ``bench_400m`` x4 experts
step), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# bench_400m's attention shape on the forward path: [B, S, H, D].
MAIN_SHAPE = (8, 2048, 8, 128)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Kinds of kernel in a decode step, matched in order on the full kernel
# name: the decode attention kernel (one launch per call); the int8
# weight-only matmul kernel; dtype conversions (the plain dequant's int8 ->
# bf16 among them), products by a broadcast scale and other elementwise
# multiplies, matrix products (cuBLAS's nvjet and gemv kernels).
DECODE_KINDS = {"decode_attention": "decode_attention_kernel",
                "int8_matmul": "int8_mm", "copy_convert": "direct_copy_kernel",
                "mul": "MulFunctor", "gemm": "gemm|gemv|nvjet|xmma|cutlass"}


def device_profile(fn, top: int = 10, kinds: dict = None) -> dict:
    """Runs ``fn()`` once under torch.profiler. Returns the host wall time,
    the time the host took to queue the work (until ``fn`` returned), the
    device's busy time (union of its kernel and copy intervals), the busy
    share of the wall, the kernels with the most device time and, with
    ``kinds`` (name -> regex), the device time and the launches of each
    kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    by_kind = dict.fromkeys([*kinds, "other"], 0.0) if kinds else {}
    count_by_kind = dict.fromkeys(by_kind, 0)
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        if kinds:
            kind = next((k for k, rx in kinds.items() if re.search(rx, name)),
                        "other")
            by_kind[kind] += (stop - start) / 1e3
            count_by_kind[kind] += 1
        name = name[:80]
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    busy_ms = busy_us / 1e3 if spans else None  # None: profiler saw none
    out = {"wall_ms": wall * 1e3, "host_queue_ms": queued * 1e3,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3) if spans else None,
           "top_kernels_ms": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:top]}
    if kinds:
        out["device_ms_by_kind"] = by_kind
        out["launches_by_kind"] = count_by_kind
    return out


def attention_bound_ms(b, s, h, d, dtype, causal) -> tuple:
    """The least time the card could take for one forward: the larger of
    the operations of the unmasked (q, k) pairs (2D for q.k, 2D for p.v)
    over the peak rate for the type, and q, k, v and o read or written once
    plus lse written once, over the memory rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * b * h * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * s * h * d * elem + 4 * b * h * s
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def attention_bwd_bound_ms(b, s, h, hkv, d, dtype, causal, kernel) -> tuple:
    """The least time the card could take for one backward kernel
    (``kernel`` "dq" or "dkv"): the larger of the operations of the unmasked
    (q, k) pairs (dq: q.k, dO.v, ds.k, 6D; dkv: q.k, dO.v, p.dO, ds.q, 8D)
    over the peak rate for the type, and the bytes it must move over the
    memory rate (dq: q, k, v, dO, O read, dQ written, lse read and the delta
    it fuses written; dkv: q, k, v, dO read, dK and dV written, lse and
    delta read; lse and delta fp32 [B, H, S]). The D products of delta are
    left out of the operations: D per row against 6D per (q, k) pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (6 if kernel == "dq" else 8) * d * b * h * pairs
    elem = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes = b * s * h * d * elem, b * s * hkv * d * elem
    nbytes = (4 * q_bytes + 2 * kv_bytes if kernel == "dq"
              else 2 * q_bytes + 4 * kv_bytes) + 2 * 4 * b * h * s
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def check_bwd_bounds() -> dict:
    """The backward bounds at bench_400m's shape, held to the figures
    worked out by hand: 134,283,264 unmasked pairs; dQ (delta fused)
    1.031e11 FLOP, >= 0.104 ms, ~202 MB (0.060 ms: q, dO, O, dQ and k, v
    33.5 MB each, lse and delta 0.5 MB each); dK/dV 1.375e11 FLOP,
    >= 0.139 ms, ~202 MB (0.060 ms); operations bound both."""
    b, s, h, d = MAIN_SHAPE
    out = {}
    for kernel, flops_want, ms_want in (("dq", 1.031e11, 0.104),
                                        ("dkv", 1.375e11, 0.139)):
        ms, by, flops = attention_bwd_bound_ms(b, s, h, h, d, torch.bfloat16,
                                               True, kernel)
        check(abs(flops / flops_want - 1) < 1e-3 and abs(ms - ms_want) < 1e-3
              and by == "operations",
              f"{kernel} bound {flops} FLOP, {ms} ms, {by}")
        out[kernel] = (ms, by, flops)
    return out


# Tolerances of the kernel against its plain version (dense fp32 scores,
# exact softmax, o rounded once to the input type):
# - bf16: the kernel rounds p to bf16 before p.v (as the TPU kernel does,
#   2^-9 relative per weight) and sums in another order; o itself is rounded
#   to bf16 (2^-8 relative per ulp). Allowed: 1e-2 + 1e-2 * |o|, about two
#   bf16 ulps at the outputs' magnitude.
# - fp32: only the summation order and expf differ: 1e-5 + 1e-5 * |o|.
# - lse is fp32 in both: 1e-4 absolute (values ~ log S + max score).
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
LSE_ATOL = 1e-4
# Tolerances of the backward kernels against their plain version, which
# rounds p and ds to the input type at the same places (dense fp32 scores,
# fp32 sums):
# - bf16: dQ, dK, dV are rounded to bf16 once (2^-8 relative), and p and ds
#   are rounded to bf16 from fp32 values that differ in their last bits
#   (summation order, expf), so a few terms of each sum land one bf16 ulp
#   apart (2^-9 relative each) before sums over up to S * n_rep terms.
#   Allowed: 2e-2 + 2e-2 * |ref|, a few bf16 ulps at the grads' magnitude.
# - fp32: only the summation order and expf differ: 1e-4 + 1e-4 * |ref|.
BWD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# delta = rowsum(dO * O) from the dQ kernel against flash_attention_delta:
# both sum the same D fp32 products (exact for bf16 inputs) in another
# order, and a sum of D terms in fp32 is off by at most about
# D * 2^-24 * sum|dO * O| whatever its order, so the two may differ by
# twice that: |err| <= DELTA_TERM_RTOL * D * sum_d |dO * O| per row.
DELTA_TERM_RTOL = 2 * 2.0 ** -24
# Head dims that the kernels pad (any multiple of 16 up to 256 is taken):
# D 16, ``TransformerConfig.tiny``'s (one 64-column block, 48 columns
# zero-filled by TMA); D 96 (padded to 128: the second 64-column block half
# filled); D 192 (padded to 256: the dK/dV kernel's second 128-column chunk
# half filled). Causal and not, one GQA case, one fp32 case; [B, S, H, D],
# kv heads, dtype, causal.
HEAD_DIM_CASES = [
    ((2, 256, 4, 16), 4, torch.bfloat16, True),
    ((2, 300, 4, 16), 2, torch.bfloat16, False),
    ((2, 384, 8, 96), 8, torch.bfloat16, True),
    ((2, 300, 8, 96), 8, torch.bfloat16, False),
    ((1, 320, 4, 192), 4, torch.bfloat16, True),
    ((1, 257, 4, 192), 4, torch.bfloat16, False),
    ((1, 200, 4, 96), 4, torch.float32, True),
]


def compare_kernel(fa, gen, shape, hkv, dtype, causal) -> tuple:
    b, s, h, d = shape
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    atol, rtol = TOL[dtype]
    err = (o.float() - ref_o.float()).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    case = {"shape": [b, s, h, d], "kv_heads": hkv,
            "dtype": str(dtype).removeprefix("torch."), "causal": causal,
            "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
            "atol": atol, "rtol": rtol, "lse_atol": LSE_ATOL}
    check(bool(torch.isfinite(o.float()).all()), f"non-finite o in {case}")
    check(bool((err <= atol + rtol * ref_o.float().abs()).all())
          and lse_err <= LSE_ATOL, f"kernel disagrees with plain: {case}")
    return case, (q, k, v, o, lse)


def compare_bwd(fa, gen, q, k, v, o, lse, causal, strided_do=False) -> tuple:
    """The dQ and dK/dV kernels (through ``flash_attention_bwd``) against
    ``flash_attention_bwd_reference`` on the forward kernel's o and lse and
    a random dO (with ``strided_do``, a [B, H, S, D] tensor seen as
    [B, S, H, D], read through its strides); the delta the dQ kernel fuses
    against ``flash_attention_delta``; and a second dQ launch, which must
    give the same dQ bit for bit (each block owns its rows, no atomics)."""
    b, s, h, d = q.shape
    if strided_do:
        do = torch.randn((b, h, s, d), generator=gen,
                         device="cuda").to(q.dtype).transpose(1, 2)
    else:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    atol, rtol = BWD_TOL[q.dtype]
    case = {"shape": [b, s, h, d], "kv_heads": k.shape[2],
            "dtype": str(q.dtype).removeprefix("torch."), "causal": causal,
            "strided_do": strided_do, "atol": atol, "rtol": rtol}
    ok = True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype
              and bool(torch.isfinite(g.float()).all()),
              f"{name} of the wrong shape, dtype or not finite: {case}")
        err = (g.float() - w.float()).abs()
        case[f"{name}_max_abs_err"] = err.max().item()
        case[f"{name}_ref_max_abs"] = w.float().abs().max().item()
        ok &= bool((err <= atol + rtol * w.float().abs()).all())
    check(ok, f"backward kernels disagree with plain: {case}")
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    want_delta = fa.flash_attention_delta(o, do)
    terms = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    derr = (delta - want_delta).abs()
    case["delta_max_abs_err"] = derr.max().item()
    case["delta_term_rtol"] = DELTA_TERM_RTOL
    check(delta.shape == want_delta.shape and delta.dtype == torch.float32
          and bool((derr <= DELTA_TERM_RTOL * d * terms).all()),
          f"dQ kernel's delta disagrees with flash_attention_delta: {case}")
    check(torch.equal(dq, got[0]), f"dQ differs between two launches: {case}")
    return case, do


def ptxas_report(logs: dict) -> list:
    """Registers, static shared memory and spills of every kernel in
    nvcc's ``-Xptxas -v`` output, with any ptxas warning about a kernel
    (an ignored setmaxnreg, serialized wgmma)."""
    out, cur = [], None
    for lib, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"library": lib, "kernel": m.group(1), "warnings": []}
                out.append(cur)
                continue
            if cur is None:
                continue
            if "warning" in line.lower():
                cur["warnings"].append(line.strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def phase_kernel() -> dict:
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    libs = build.build(verbose=True)  # prints ptxas's register report
    build_s = time.perf_counter() - t0
    report = ptxas_report(build.BUILD_LOGS)
    dyn_smem = {d: fa.kernel_smem_bytes(d) for d in (64, 128, 256)}
    emit({"phase": "kernel_build", "build_s": build_s, "ptxas": report,
          "dynamic_smem_bytes_by_head_dim": dyn_smem})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, s, h, d = MAIN_SHAPE
    shapes = [
        ((2, 512, 8, 128), 8, torch.bfloat16, False),
        ((2, 512, 8, 128), 2, torch.bfloat16, True),  # GQA
        ((2, 1000, 8, 128), 8, torch.bfloat16, True),  # ragged S
        ((2, 1000, 8, 128), 2, torch.bfloat16, False),
        ((1, 384, 4, 256), 4, torch.bfloat16, True),  # gptj_6b's D
        ((2, 300, 8, 128), 2, torch.float32, True),
        ((1, 333, 4, 64), 4, torch.float32, False),
        # cases the wgmma/TMA kernels make risky: S below one tile, D 64
        # (one 64-column block), GQA with n_rep 4 through the dK/dV ring,
        # a head dim below one TMA box (zero-filled columns)
        ((2, 40, 8, 128), 8, torch.bfloat16, True),
        ((2, 512, 8, 64), 8, torch.bfloat16, True),
        ((2, 1000, 8, 64), 8, torch.bfloat16, False),
        ((2, 1024, 8, 128), 2, torch.bfloat16, True),
        ((1, 200, 4, 32), 2, torch.bfloat16, True),
        # D 64 (two dK/dV consumer warpgroups) with n_rep 4 and S mod 128 in
        # 1..64: one ring item per q head on the last kv block, which the
        # second warpgroup skips under the causal mask, over more items than
        # ring stages
        ((2, 40, 8, 64), 2, torch.bfloat16, True),
        ((2, 192, 8, 64), 2, torch.bfloat16, True),
        # cases the dQ kernel's 128-row q tiles over 64-row kv tiles make
        # risky: causal at D 128 with n_rep 4 and S mod 128 in 1..64 (the
        # last q tile's second warpgroup has no live row, the first none on
        # the diagonal's last kv tile); S 130: as many kv tiles as ring
        # stages in the first q tile, more in the second, whose second
        # warpgroup has no live row (S 40 above has fewer tiles than
        # stages); D 256 (one consumer, two ds.k wgmmas per k step)
        # non-causal with GQA
        ((2, 1040, 8, 128), 2, torch.bfloat16, True),
        ((2, 130, 8, 128), 2, torch.bfloat16, True),
        ((1, 320, 8, 256), 2, torch.bfloat16, False),
    ] + HEAD_DIM_CASES
    with torch.inference_mode():
        main, (q, k, v, o, lse) = compare_kernel(fa, gen, MAIN_SHAPE, h,
                                                 torch.bfloat16, True)
        main_bwd, do = compare_bwd(fa, gen, q, k, v, o, lse, True)
        cases, bwd_cases = [main], [main_bwd]
        for shape, hkv, dtype, causal in shapes:
            case, ins = compare_kernel(fa, gen, shape, hkv, dtype, causal)
            cases.append(case)
            bwd_cases.append(compare_bwd(fa, gen, *ins, causal)[0])
        # dO as autograd may hand it over: not contiguous
        bwd_cases.append(compare_bwd(fa, gen, q, k, v, o, lse, True,
                                     strided_do=True)[0])
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_reference(q, k, v, True), 5)
        # dQ with delta fused; dK/dV on the dQ kernel's delta; both, as
        # flash_attention_bwd runs them; the plain delta expression that the
        # fusion took off the path
        dq_ms = cuda_ms(lambda: fa.flash_bwd_dq_kernel(q, k, v, o, do, lse,
                                                       True), 20)
        _, delta = fa.flash_bwd_dq_kernel(q, k, v, o, do, lse, True)
        dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse,
                                                         delta, True), 20)
        bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                        True), 20)
        delta_plain_ms = cuda_ms(lambda: fa.flash_attention_delta(o, do), 20)
        dq_plain_ms = cuda_ms(lambda: fa.flash_bwd_dq_reference(
            q, k, v, o, lse, do, True), 3)
        bwd_plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, True), 3)
        # yardsticks only: the port never calls SDPA
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True), 20)
    qt, kt, vt = (x.transpose(1, 2).clone().requires_grad_(True)
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2).clone()
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    del out, qt, kt, vt, dot
    bound_ms, bound_by, flops = attention_bound_ms(b, s, h, d,
                                                   torch.bfloat16, True)
    bwd_bounds = check_bwd_bounds()
    out = {"phase": "kernel", "build_s": build_s,
           "libraries": {n: str(p.name) for n, p in libs.items()},
           "ptxas": report, "dynamic_smem_bytes_by_head_dim": dyn_smem,
           "cases": cases, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / ms,
           "tflops": flops / ms / 1e9,
           "bwd_cases": bwd_cases, "bwd_dq_ms": dq_ms, "bwd_dkv_ms": dkv_ms,
           "bwd_ms": bwd_ms, "bwd_delta_plain_ms": delta_plain_ms,
           "bwd_dq_plain_ms": dq_plain_ms, "bwd_plain_ms": bwd_plain_ms,
           "bwd_library_ms": library_bwd_ms}
    for kernel, kms in (("dq", dq_ms), ("dkv", dkv_ms)):
        kbound, kby, kflops = bwd_bounds[kernel]
        out[f"bwd_{kernel}_bound_ms"] = kbound
        out[f"bwd_{kernel}_bound_by"] = kby
        out[f"bwd_{kernel}_roofline_share"] = kbound / kms
        out[f"bwd_{kernel}_tflops"] = kflops / kms / 1e9
    emit(out)
    torch.cuda.empty_cache()
    return out


# The int8 weight-only matmul kernel against its plain version, which
# multiplies the same dequantized weights (the kernel rounds them as
# ``QTensor.to`` does, bit for bit) and sums in another order:
# - fp32: two fp32 sums of the same K exact products, each within
#   K * 2^-24 * sum_k |x_k w_k| of the exact sum, so they may differ by twice
#   that: |y - ref| <= 2 K 2^-24 S, S = |x| @ |w| per element;
# - bf16: the same fp32 sums, each rounded once to bf16 (8 significant bits,
#   so within 2^-8 of the value): |y - ref| <= 2 K 2^-24 S
#   + 2^-7 (1 + 2^-7) max(|y|, |ref|).
# The plain version's product runs with cuBLAS's reduced-precision bf16
# reductions off, so its sums are fp32 as the bound assumes.
INT8_BF16_ROUND = 2.0 ** -7 * (1 + 2.0 ** -7)
INT8_MS = (8, 128)  # serve_7b's decode (8 slots) and prefill (bucket 128) M
# Ragged M, and the M of the fp32 engine check (2 slots, buckets 64 and 128).
INT8_RAGGED_MS = (1, 3, 17, 2, 40, 64)


def int8_weight_shapes(cfg) -> dict:
    """(K, N) of the six int8 weights of a layer, as ``QTensor.matmul``
    flattens them."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.kv_heads * cfg.d_head
    return {"wq": (d, hd), "wk": (d, kvd), "wv": (d, kvd), "attn_wo": (hd, d),
            "mlp_wi": (d, cfg.d_ff), "mlp_wo": (cfg.d_ff, d)}


def int8_operands(gen, m, k, n, dtype, copies=1) -> tuple:
    """x [m, k] ~ N(0, 1) and ``copies`` int8 weights [k, n] with their
    scales (uniform int8, scales near those of a N(0, 1/k) init)."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                         dtype=torch.int8),
           (torch.rand(n, generator=gen, device="cuda") + 0.5)
           * (4.0 / 127.0 / k ** 0.5)) for _ in range(copies)]
    return x, ws


def int8_bound_ms(m, k, n, dtype) -> tuple:
    """The least time the card could take for one product: x, q, s read and
    y written once over the memory rate, against 2 M K N operations over the
    peak rate for x's type (bf16 tensor cores, fp32 CUDA cores)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = m * k * elem + k * n + 4 * n + m * n * elem
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_int8(im, gen, m, k, n, dtype) -> dict:
    """One product of the kernel against the plain version under the bound
    above; a second launch must agree bit for bit, and so must the first
    row computed alone (a row's sum order depends on K alone)."""
    x, [(q, s)] = int8_operands(gen, m, k, n, dtype)
    y = im.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = im.int8_matmul_reference(x, q, s)
    w = (q.to(dtype) * s.to(dtype)).float()
    terms = x.float().abs() @ w.abs()
    yf, rf = y.float(), ref.float()
    tol = 2 * k * 2.0 ** -24 * terms
    if dtype == torch.bfloat16:
        tol = tol + INT8_BF16_ROUND * torch.maximum(yf.abs(), rf.abs())
    err = (yf - rf).abs()
    case = {"m": m, "k": k, "n": n,
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err.max().item(),
            "ref_max_abs": rf.abs().max().item(),
            "max_err_over_tol": (err / tol.clamp_min(1e-30)).max().item()}
    check(y.shape == (m, n) and y.dtype == dtype
          and bool(torch.isfinite(yf).all()),
          f"int8_matmul output of the wrong shape, dtype or not finite: "
          f"{case}")
    check(bool((err <= tol).all()),
          f"int8_matmul disagrees with its plain version: {case}")
    check(torch.equal(im.int8_matmul(x, q, s), y),
          f"int8_matmul differs between two launches: {case}")
    check(torch.equal(im.int8_matmul(x[:1].contiguous(), q, s), y[:1]),
          f"int8_matmul's row 0 differs when computed alone: {case}")
    return case


def graph_ms(fn, args, reps: int = 10) -> float:
    """Device ms per call of ``fn(*a)`` for a in ``args``: one pass over
    ``args`` captured in a CUDA graph (``ray_tpu_torch.graphs``: a warm-up
    pass on a side stream, then the capture) and replayed ``reps`` times,
    by CUDA events. No host time is in it, as none is in a served decode
    step."""
    from ray_tpu_torch import graphs

    def one_pass():
        for a in args:
            fn(*a)

    graphs.warm_up(one_pass, torch.device("cuda", torch.cuda.current_device()))
    cap = graphs.capture(one_pass)
    ms = cuda_ms(cap.graph.replay, reps, warmup=1) / len(args)
    del cap
    return ms


def int8_times(im, gen, m, k, n, dtype) -> dict:
    """Device times of one product at (m, k, n) (``graph_ms``) on weights
    that rotate through copies larger than L2 together (each call finds its
    weight in device memory, as a decode step does): the kernel, its plain
    version, ``torch._weight_int8pack_mm`` (q transposed to [N, K] and the
    scales cast to x's dtype beforehand, as it takes them; None with the
    reason where this torch has none on CUDA) and, as a second yardstick, a
    bf16 product over weights dequantized beforehand."""
    copies = max(2, -(-240_000_000 // (k * n)))
    x, ws = int8_operands(gen, m, k, n, dtype, copies)
    out = {"m": m, "k": k, "n": n,
           "dtype": str(dtype).removeprefix("torch."), "weight_copies": copies,
           "kernel_ms": graph_ms(lambda q, s: im.int8_matmul(x, q, s), ws),
           "plain_ms": graph_ms(
               lambda q, s: im.int8_matmul_reference(x, q, s), ws[:2])}
    out["bound_ms"], out["bound_by"] = int8_bound_ms(m, k, n, dtype)
    try:
        packed = [(q.t().contiguous(), s.to(dtype)) for q, s in ws[:2]]
        out["library_ms"] = graph_ms(
            lambda qt, s: torch._weight_int8pack_mm(x, qt, s), packed)
        del packed
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        out["library_ms"] = None
        out["library_none_reason"] = f"torch._weight_int8pack_mm: {e}"[:300]
    dq = [(q.to(dtype) * s.to(dtype),) for q, s in ws[:2]]
    out["dequantized_matmul_ms"] = graph_ms(lambda w: x @ w, dq)
    del dq, ws
    torch.cuda.empty_cache()
    return out


def phase_int8_kernel() -> dict:
    """``int8_matmul`` (built by the kernel phase) against its plain version
    at every int8 weight shape of serve_7b, at decode's and prefill's M, in
    bf16 and fp32; at ragged M; at ``tiny``'s widths. Device times inside
    CUDA graphs at serve_7b's shapes, bf16, per decode step and per
    prefill (a layer's six products at M 8 and at M 128, times its 32
    layers); ptxas's report of the int8 kernels and each shape's launch
    plan."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg = TransformerConfig.serve_7b()
    shapes = int8_weight_shapes(cfg)
    distinct = sorted(set(shapes.values()))
    cases = []
    with torch.inference_mode():
        for (k, n), m, dtype in itertools.product(
                distinct, INT8_MS, (torch.bfloat16, torch.float32)):
            cases.append(compare_int8(im, gen, m, k, n, dtype))
        serve_7b_err = max(c["max_abs_err"] for c in cases)
        k, n = distinct[0]
        for m, dtype in itertools.product(INT8_RAGGED_MS,
                                          (torch.bfloat16, torch.float32)):
            cases.append(compare_int8(im, gen, m, k, n, dtype))
        for name, (k, n) in int8_weight_shapes(TransformerConfig.tiny(
                n_kv_heads=2)).items():
            for m in (8, 64):
                cases.append({"tiny": name,
                              **compare_int8(im, gen, m, k, n,
                                             torch.bfloat16)})
        times = {(k, n, m): int8_times(im, gen, m, k, n, torch.bfloat16)
                 for (k, n), m in itertools.product(distinct, INT8_MS)}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True

    def per_step(m) -> dict:
        """A layer's six products at M ``m``, times its layers: the
        kernel's share of a decode step (M 8) or of a prefill (M 128)."""
        out = {"m": m, "layers": cfg.n_layers, "launches": 6 * cfg.n_layers}
        for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                    "dequantized_matmul_ms"):
            vals = [times[(k, n, m)][key] for k, n in shapes.values()]
            out[key] = (None if None in vals
                        else cfg.n_layers * float(sum(vals)))
        out["bound_share"] = out["bound_ms"] / out["kernel_ms"]
        return out

    # each serve_7b shape's bf16 launch: K split, ring, wgmma N, workspace
    plans = [{"m": m, "k": k, "n": n, **dataclasses.asdict(im.launch_plan(
        m, k, n, im._sms(torch.device("cuda"))))}
        for (k, n), m in itertools.product(distinct, INT8_MS)]
    out = {"phase": "int8_kernel", "cases": cases,
           "serve_7b_max_abs_err": serve_7b_err,
           "bf16_round_rtol": INT8_BF16_ROUND,
           "ptxas": [r for r in ptxas_report(build.BUILD_LOGS)
                     if r["library"] == "int8_matmul"],
           "plans": plans,
           "times": list(times.values()),
           "decode_step": {**per_step(INT8_MS[0]), "bound_by": "bytes"},
           "prefill_step": per_step(INT8_MS[1])}
    check(all(times[(k, n, INT8_MS[0])]["bound_by"] == "bytes"
              for k, n in distinct), "decode products are bound by bytes")
    emit(out)
    return out


# The decode attention kernel against its plain version (dense fp32 scores
# over the whole cache, fp32 softmax, p rounded to the dtype, the output
# rounded once, the self term added in the dtype), per element, with
# T = sum_j p_j |v_j| + p_self |v_new| (the plain version's fp32
# probabilities applied to |v|):
# - bf16: both take the same fp32 scores and softmax up to the order of
#   their sums and expf, so a p may round to the neighbouring bf16 value
#   (2^-7 relative at most), which moves the prefix sum by 2^-7 T at most;
#   the prefix, the self product and their sum are each rounded to bf16
#   (2^-8 relative on each side). Derived: about 2^-6 (T + max(|got|,
#   |ref|)); allowed twice that.
# - fp32: only the order of the sums (up to S_max + 1 = 1090 terms, D = 256
#   products) and expf differ, each sum within n 2^-24 of its terms' sum:
#   under 2^-13 (T + max(|got|, |ref|)); allowed 2^-12.
DECODE_RTOL = {torch.bfloat16: 2.0 ** -5, torch.float32: 2.0 ** -12}
DECODE_HEAD_DIMS = (16, 64, 96, 128, 192, 256)
DECODE_S_MAX = 300
# serve_7b's engine step (8 slots at position 160 of 512, 32 heads of 128,
# the self column) and bench.py's inference leg on bench_400m (8 sequences
# at positions 1024..1087 of a 1089-row cache, 8 heads of 128, no self
# column: lengths 1025..1088).
# ``ragged``: one more call with the slots at different lengths, as the
# engine's slots are (serve_7b's traffic decodes positions 128..191; the
# 400M engine's prompts are 64..500 tokens long, and it decodes 32 more).
DECODE_SERVE_7B = {"b": 8, "h": 32, "s_max": 512, "d": 128, "layers": 32,
                   "lengths": [160], "self": True,
                   "ragged": [128, 137, 146, 155, 164, 173, 182, 191]}
DECODE_INFERENCE = {"b": 8, "h": 8, "s_max": 1089, "d": 128, "layers": 24,
                    "lengths": list(range(1025, 1089)), "self": False,
                    "ragged": [1025, 1034, 1043, 1052, 1061, 1070, 1079,
                               1088]}
# the 400M engine's step (serve phase: 8 slots, a 1024-row cache, the self
# column; ``graph_decode_profile`` decodes at position 300)
DECODE_ENGINE_400M = {"b": 8, "h": 8, "s_max": 1024, "d": 128, "layers": 24,
                      "lengths": [300], "self": True,
                      "ragged": [64, 131, 198, 265, 332, 399, 466, 532]}


def decode_lengths(s_max: int, self_col: bool, tile_rows: int = 16) -> list:
    """Per-slot lengths at the edges the kernel cuts at: none (the self
    column alone), one row, fewer rows than a cluster has blocks (2, 3, 5,
    7: blocks with no share), around every multiple of the kernel's
    ``tile_rows`` (tiles end there, and a cluster of C blocks splits a slot
    evenly at multiples of C tiles) and so of 64 (the chunks of the earlier
    design), the last rows, and past the cache (clamped)."""
    edges = {1, 2, 3, 5, 7, s_max - 1, s_max, s_max + 7}
    for c in range(tile_rows, s_max, tile_rows):
        edges |= {c - 1, c, c + 1}
    return ([0] if self_col else []) + sorted(edges)


def decode_operands(gen, b, h, hkv, s_max, d, dtype) -> tuple:
    """q, the caches, k_new and v_new ~ N(0, 1) in ``dtype`` on the card."""
    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (t(b, 1, h, d), t(b, s_max, hkv, d), t(b, s_max, hkv, d),
            t(b, 1, hkv, d), t(b, 1, hkv, d))


def decode_error(da, q, k, v, lengths, new) -> tuple:
    """The kernel's output at these operands, its error against the plain
    version, and the error's bound (``DECODE_RTOL`` of the sum of the
    terms' magnitudes plus the larger output)."""
    got = da.decode_attention(q, k, v, lengths, *new)
    torch.cuda.synchronize()
    ref = da.decode_attention_reference(q, k, v, lengths, *new)
    terms = da.decode_attention_reference(
        q.float(), k.float(), v.float().abs(), lengths,
        *((new[0].float(), new[1].float().abs()) if new else ()))
    gf, rf = got.float(), ref.float()
    bound = DECODE_RTOL[q.dtype] * (terms + torch.maximum(gf.abs(),
                                                          rf.abs()))
    return got, (gf - rf).abs(), bound


def compare_decode(da, gen, b_extra, h, n_rep, d, dtype) -> dict:
    """The kernel against its plain version with and without the self
    column, at every length of ``decode_lengths`` (one slot each, plus
    ``b_extra`` slots at S_max / 2); then stale rows: the rows at or past
    each slot's length set to NaN, and to zeros, give the kernel's output
    bit for bit; a second launch too."""
    hkv = h // n_rep
    case = {"h": h, "kv_heads": hkv, "d": d, "s_max": DECODE_S_MAX,
            "dtype": str(dtype).removeprefix("torch."),
            "rtol": DECODE_RTOL[dtype]}
    for self_col in (True, False):
        lens = decode_lengths(DECODE_S_MAX, self_col, da.TILE_ROWS)
        lens += [DECODE_S_MAX // 2] * b_extra
        b = len(lens)
        q, k, v, kn, vn = decode_operands(gen, b, h, hkv, DECODE_S_MAX, d,
                                          dtype)
        lengths = torch.tensor(lens, device="cuda")
        new = (kn, vn) if self_col else ()
        got, err, bound = decode_error(da, q, k, v, lengths, new)
        gf = got.float()
        key = "self" if self_col else "no_self"
        plan = {**dataclasses.asdict(da.launch_plan(
            b, h, hkv, DECODE_S_MAX, d, da._sms(q.device))),
            **da.ring(dtype, b, h, hkv, DECODE_S_MAX, d)}
        case[key] = {"batch": b, "kv_rows": b * hkv, "plan": plan,
                     "max_abs_err": err.max().item(),
                     "max_err_over_bound":
                         (err / bound.clamp_min(1e-30)).max().item()}
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(gf).all()),
              f"decode_attention output of the wrong shape, dtype or not "
              f"finite: {case}")
        check(bool((err <= bound).all()),
              f"decode_attention disagrees with its plain version: {case}")
        rows = torch.arange(DECODE_S_MAX, device="cuda")
        stale = (rows[None, :] >= lengths.clamp(max=DECODE_S_MAX)[:, None])
        stale = stale[:, :, None, None]
        outs = [da.decode_attention(q, k.masked_fill(stale, fill),
                                    v.masked_fill(stale, fill), lengths,
                                    *new)
                for fill in (float("nan"), 0.0)]
        outs.append(da.decode_attention(q, k, v, lengths, *new))
        check(all(torch.equal(o, got) for o in outs),
              f"decode_attention read a stale row or differs between "
              f"launches: {case}")
    return case


def decode_bound_ms(shape: dict, dtype=torch.bfloat16) -> tuple:
    """The least time the card could take for one call at ``shape``, per
    call averaged over its lengths: q, the valid K and V rows, k_new and
    v_new read once and the output written once over the memory rate,
    against the products (q.k and p.v, 2 D each per head and row, the self
    column included) over the peak rate for the type."""
    b, h, d, s_max = shape["b"], shape["h"], shape["d"], shape["s_max"]
    elem = torch.finfo(dtype).bits // 8
    rows = np.mean([min(n, s_max) for n in shape["lengths"]])
    cols = rows + (1 if shape["self"] else 0)
    nbytes = (2 * b * h * d * elem + 2 * b * rows * h * d * elem + 8 * b
              + (2 * b * h * d * elem if shape["self"] else 0))
    flops = 4 * d * b * h * cols
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), nbytes


def check_at_main_shape(da, q, calls, new, ragged) -> dict:
    """The kernel against its plain version at a main path's own operands:
    every call of ``calls`` (each length of the shape, each on a layer of
    its own) and one with the slots at the ``ragged`` lengths, in bf16 as
    the path runs and in fp32 (the same operands, widened; what the fp32
    engine = ``generate`` checks run), within ``DECODE_RTOL``."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst, max_err = 0.0, 0.0
        for k, v, n in calls + [(calls[0][0], calls[0][1], ragged)]:
            ops = [t.to(dtype) for t in (q, k, v, *new)]
            got, err, bound = decode_error(da, *ops[:3], n, tuple(ops[3:]))
            check(bool(torch.isfinite(got.float()).all())
                  and bool((err <= bound).all()),
                  f"decode_attention disagrees with its plain version at a "
                  f"main path's shape ({dtype}, lengths {n.tolist()})")
            worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
            max_err = max(max_err, err.max().item())
        out[str(dtype).removeprefix("torch.")] = {
            "calls": len(calls) + 1, "max_abs_err": max_err,
            "max_err_over_bound": worst}
    return out


def decode_times(da, gen, shape: dict) -> dict:
    """At ``shape``, the kernel held against its plain version on the same
    operands (``check_at_main_shape``), then device times per call
    (``graph_ms``: a pass over every layer's own cache, at each of the
    shape's lengths in turn, so each call finds its rows in device memory
    as a decode step does) of the kernel, its plain version and
    ``scaled_dot_product_attention`` with a boolean mask over the same rows
    (the self column as a written row; None with the reason where this
    torch cannot take it in a graph), beside the bound; and the same per
    decode step (one call per layer)."""
    b, h, d, s_max = shape["b"], shape["h"], shape["d"], shape["s_max"]
    layers = shape["layers"]

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cache = randn(2, layers, b, s_max, h, d)
    q, kn, vn = randn(b, 1, h, d), randn(b, 1, h, d), randn(b, 1, h, d)
    new = (kn, vn) if shape["self"] else ()
    pos = torch.arange(s_max, device="cuda")
    extra = 1 if shape["self"] else 0
    lens = [torch.full((b,), n, device="cuda") for n in shape["lengths"]]
    masks = [(pos[None, :] < n[:, None] + extra)[:, None, None] for n in lens]
    n_calls = max(layers, len(lens))
    calls = [(cache[0, i % layers], cache[1, i % layers], lens[i % len(lens)])
             for i in range(n_calls)]
    ragged = torch.tensor(shape["ragged"], device="cuda")
    plan = da.launch_plan(b, h, h, s_max, d, da._sms(q.device))
    ring = da.ring(torch.bfloat16, b, h, h, s_max, d)
    check(ring["smem_bytes"] <= 227 * 1024
          and ring["clusters_at_once"] >= plan.grid[1],
          f"decode_attention at a main path's shape: a ring beyond a block's "
          f"227 KB, or a grid the card cannot hold at once: {plan}, {ring}")
    out = {"shape": {k: v for k, v in shape.items() if k != "lengths"},
           "lengths": [shape["lengths"][0], shape["lengths"][-1]],
           "plan": {**dataclasses.asdict(plan), **ring},
           "vs_plain": check_at_main_shape(da, q, calls, new, ragged),
           "kernel_ms_per_call": graph_ms(
               lambda k, v, n: da.decode_attention(q, k, v, n, *new), calls),
           "plain_ms_per_call": graph_ms(
               lambda k, v, n: da.decode_attention_reference(q, k, v, n,
                                                             *new),
               calls[:2], reps=3)}
    qt = q.transpose(1, 2)
    lib = [(k.transpose(1, 2), v.transpose(1, 2), masks[i % len(masks)])
           for i, (k, v, _) in enumerate(calls[:4])]
    try:
        out["library_ms_per_call"] = graph_ms(
            lambda k, v, m: torch.nn.functional.scaled_dot_product_attention(
                qt, k, v, attn_mask=m), lib, reps=5)
    except RuntimeError as e:
        out["library_ms_per_call"] = None
        out["library_none_reason"] = f"scaled_dot_product_attention: {e}"[
            :300]
    # host cost of an eager call: the whole wrapper (checks, the tensor
    # maps' encode, launch), queued without a sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, v, n in calls[:20]:
        da.decode_attention(q, k, v, n, *new)
    out["eager_host_us_per_call"] = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    bound, by, nbytes = decode_bound_ms(shape)
    out.update({"bound_ms_per_call": bound, "bound_by": by,
                "bytes_per_call": nbytes,
                "bound_share": bound / out["kernel_ms_per_call"]})
    for key in ("kernel", "plain", "library", "bound"):
        per_call = out[f"{key}_ms_per_call"]
        out[f"{key}_ms_per_step"] = (None if per_call is None
                                     else layers * per_call)
    del cache, calls, lib
    torch.cuda.empty_cache()
    return out


def phase_decode_kernel() -> dict:
    """``decode_attention`` (built by the kernel phase) against its plain
    version on the card: bf16 and fp32, D 16 to 256, n_rep 1 to 8,
    clusters of 1 to 8 blocks, lengths at every edge, with and without the
    self column, stale rows and repeated launches (``compare_decode``);
    then, at serve_7b's engine step, bench.py's inference leg and the 400M
    engine's step, the kernel against its plain version on those shapes'
    own operands, and its times per call and per decode step beside its
    plain version, SDPA and its bound."""
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    cases = []
    with torch.inference_mode():
        for d, n_rep, dtype in itertools.product(
                DECODE_HEAD_DIMS, (1, 2, 4), (torch.bfloat16, torch.float32)):
            cases.append(compare_decode(da, gen, 0, 16, n_rep, d, dtype))
        # few kv heads: clusters of 4 (h 2) and 8 (h 1; 4 heads of one kv
        # head); n_rep 8 (8 heads per block) and 3 (3 groups of one head)
        for h, n_rep, dtype in ((2, 1, torch.bfloat16), (1, 1, torch.bfloat16),
                                (2, 1, torch.float32), (4, 4, torch.float32),
                                (16, 8, torch.bfloat16), (12, 3, torch.float32)):
            cases.append(compare_decode(da, gen, 0, h, n_rep, 128, dtype))
        # B * Hkv above 264: clusters of one block
        cases.append(compare_decode(da, gen, 20, 16, 1, 128, torch.bfloat16))
        times = {"serve_7b_step": decode_times(da, gen, DECODE_SERVE_7B),
                 "inference_step": decode_times(da, gen, DECODE_INFERENCE),
                 "engine_400m_step": decode_times(da, gen,
                                                  DECODE_ENGINE_400M)}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    errs = {dt: max([c[form]["max_abs_err"] for c in cases for form in
                     ("self", "no_self") if c["dtype"] == dt]
                    + [t["vs_plain"][dt]["max_abs_err"]
                       for t in times.values()])
            for dt in ("bfloat16", "float32")}
    out = {"phase": "decode_kernel", "cases": cases, "max_abs_err": errs,
           "rtol": {str(k).removeprefix("torch."): v
                    for k, v in DECODE_RTOL.items()},
           "ptxas": [r for r in ptxas_report(build.BUILD_LOGS)
                     if r["library"] == "decode_attention"],
           "times": times}
    check(all(t["bound_by"] == "bytes" for t in times.values()),
          "decode attention is bound by bytes")
    emit(out)
    return out


def phase_forward(params, cfg) -> dict:
    from ray_tpu_torch.models.generation import prepare_for_inference
    from ray_tpu_torch.models.transformer import forward, loss_fn
    from ray_tpu_torch.ops import flash_attention as fa

    ip, icfg = prepare_for_inference(params, cfg)
    check(icfg.attn_impl == "flash", "bench_400m must use flash attention")
    rng = np.random.default_rng(SEED)
    b, s = MAIN_SHAPE[0], MAIN_SHAPE[1]
    tokens = torch.from_numpy(
        rng.integers(0, icfg.vocab_size, (b, s + 1))).cuda()
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    dense_cfg = dataclasses.replace(icfg, attn_impl="dense")
    with torch.inference_mode():
        fa.launches = 0
        logits = forward(ip, batch["tokens"], icfg)
        torch.cuda.synchronize()
        launches = fa.launches
        check(launches == icfg.n_layers,
              f"flash launches {launches} != {icfg.n_layers} layers")
        check(logits.shape == (b, s, icfg.vocab_size)
              and bool(torch.isfinite(logits.float()).all()),
              "forward logits not finite or of the wrong shape")
        dense = forward(ip, batch["tokens"], dense_cfg)
        diff = (logits.float() - dense.float()).abs()
        agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        loss = loss_fn(ip, batch, icfg).item()
        dense_loss = loss_fn(ip, batch, dense_cfg).item()
        fwd_ms = cuda_ms(lambda: forward(ip, batch["tokens"], icfg), 3, 1)
        dense_ms = cuda_ms(lambda: forward(ip, batch["tokens"], dense_cfg),
                           3, 1)
        prof = device_profile(lambda: forward(ip, batch["tokens"], icfg))
    out = {"phase": "forward", "flash_launches": launches,
           "logits_max_abs_diff_vs_dense": diff.max().item(),
           "logits_mean_abs_diff_vs_dense": diff.mean().item(),
           "argmax_agreement_vs_dense": agree, "loss": loss,
           "dense_loss": dense_loss, "forward_ms": fwd_ms,
           "dense_forward_ms": dense_ms,
           "tokens_per_s": b * s / fwd_ms * 1e3, "profile": prof}
    # bf16 through 24 layers: the two attentions round p at different
    # places, and the residual stream amplifies it. Held: mean |diff| <=
    # 2e-2, max |diff| <= 0.5 (logits are ~N(0, 1) at this init), argmax
    # agreement >= 95%, loss within 1e-2.
    check(out["logits_mean_abs_diff_vs_dense"] <= 2e-2
          and out["logits_max_abs_diff_vs_dense"] <= 0.5
          and agree >= 0.95 and abs(loss - dense_loss) <= 1e-2
          and np.isfinite(loss), f"flash forward disagrees with dense: {out}")
    emit(out)
    return out


def train_batch(vocab: int, b: int, s: int, seed: int) -> dict:
    """One seeded batch on the card: tokens, the targets shifted by one,
    and a mask of ones."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s + 1))).cuda()
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": torch.ones((b, s), device=ids.device)}


def train_flops(cfg, b: int, s: int) -> int:
    """FLOPs of one train step as bench.py:228-230 counts them: 6 N per
    token for the weights, plus the causal attention's products."""
    return 6 * cfg.param_count() * b * s + (
        12 * cfg.n_layers * cfg.n_heads * cfg.d_head * b * s * s // 2)


# The train phase's loop: batches drawn from a cycle of TRAIN_CYCLE fixed
# seeded batches (so the loss can fall), TRAIN_STEPS steps, a checkpoint
# saved after step TRAIN_SAVE_AFTER while training goes on.
TRAIN_CYCLE, TRAIN_STEPS, TRAIN_SAVE_AFTER = 4, 14, 8
# Flash launches of one bench_400m train step: the forward kernel in the
# forward and again in the remat recompute, each backward kernel once, per
# layer; counted by kernel name in a profiled graph replay. Beside them, the
# other kinds of kernel of a step, matched in order on the full name:
# cuBLAS's products, the foreach kernels (clip, global norm, AdamW), dtype
# conversions and copies, other elementwise kernels.
FLASH_KINDS = {"flash_fwd": "flash_fwd_(bf16|f32)_kernel",
               "flash_bwd_dq": "flash_bwd_dq_(bf16|f32)_kernel",
               "flash_bwd_dkv": "flash_bwd_dkv_(bf16|f32)_kernel"}
TRAIN_KINDS = {**FLASH_KINDS, "gemm": DECODE_KINDS["gemm"],
               "foreach": "multi_tensor_apply",
               "copy_convert": "copy_kernel|direct_copy",
               "elementwise": "elementwise_kernel"}


def numpy_train_batches(vocab: int, b: int, s: int, n: int,
                        seed: int) -> list:
    """``n`` seeded numpy batches as a data source yields them: tokens,
    the targets shifted by one, and a mask of ones."""
    out = []
    for i in range(n):
        ids = np.random.default_rng(seed + i).integers(0, vocab, (b, s + 1))
        out.append({"tokens": ids[:, :-1], "targets": ids[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


def state_tensors(state) -> list:
    """Every tensor a TrainState holds: step, params, and per parameter
    AdamW's step count and moments."""
    from ray_tpu_torch.models.transformer import tree_leaves

    out = [state.step]
    for p in tree_leaves(state.params):
        st = state.opt_state.state[p]
        out += [p.detach(), st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


def tensors_differing(a: list, b: list) -> int:
    """How many of two states' tensors differ in any bit."""
    check(len(a) == len(b), "states of different structure")
    return sum(not torch.equal(x, y) for x, y in zip(a, b))


def _metric(m) -> tuple:
    return (m["loss"].item(), m["grad_norm"].item(), int(m["step"]))


def phase_train(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1],
                steps: int = TRAIN_STEPS,
                save_after: int = TRAIN_SAVE_AFTER) -> dict:
    """``bench_400m`` trained on the card as the reference's loops train
    it: numpy batches through the port's pump (``device_batches``), the
    port's ``make_train_step`` (step 1 the eager warm-up, step 2 captures
    the CUDA graph, then replays), and a ``save_sharded`` checkpoint after
    step ``save_after`` written while training goes on. Then: one replay
    profiled (48 / 24 / 24 flash launches by kernel name; the wrappers'
    counters must not move across replays); eager steps from a state of the
    same seed, which must equal the captured ones bit for bit (the same
    kernels in the same order on the same inputs; no kernel of the step
    sums with atomics); and the checkpoint restored into a fresh state,
    bit-equal to the state it saved, whose next step (eager) must equal
    the original's (captured) bit for bit, every tensor included."""
    import shutil
    import tempfile

    from ray_tpu_torch.data import device_batches
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.train import is_committed, load_sharded, save_sharded

    check(cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m trains with flash "
          "attention under remat 'dots'")
    check(2 < save_after < steps, "the save falls among the replays")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)

    def counters():
        return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)

    def on_card(i):
        return {k: torch.from_numpy(v).cuda() for k, v in cycle[i].items()}

    # The pump alone, with no step beside it: its own host cost per batch.
    alone = device_batches(lambda: iter(cycle * 2), prefetch_batches=2)
    t0 = time.perf_counter()
    for _ in alone:
        pass
    torch.cuda.synchronize()
    pump_alone_ms = ((time.perf_counter() - t0) * 1e3 / len(cycle) / 2,
                     alone.stats["host_s"] * 1e3 / len(cycle) / 2)

    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        metrics, events, host_ms = [], [], []
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
        pump = device_batches(
            lambda: (cycle[i % TRAIN_CYCLE] for i in range(steps)),
            prefetch_batches=2)
        for i, batch in enumerate(pump):
            n = i + 1  # the step this call takes
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.record()
            metrics.append(m)
            events.append((start, end))
            if n == 1:  # the eager warm-up
                torch.cuda.synchronize()
                eager_peak = torch.cuda.max_memory_allocated()
                above = {"eager_first_step": eager_peak - base}
                warm_counts = counters()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            elif n == 2:  # captured, and replayed once
                torch.cuda.synchronize()
                capture_counts = counters()
                t_replays = time.perf_counter()
            elif n == save_after:
                torch.cuda.synchronize()
                wall_ms = ((time.perf_counter() - t_replays) * 1e3
                           / (save_after - 2))
                captured_peak = torch.cuda.max_memory_allocated()
                above["captured"] = captured_peak - base
                at_save = [t.clone() for t in state_tensors(state)]
                t0 = time.perf_counter()
                handle = save_sharded(state, tmp, step=n)
                snapshot_ms = (time.perf_counter() - t0) * 1e3
                t_save = time.perf_counter()
            elif n == save_after + 1:
                after_save = [t.clone() for t in state_tensors(state)]
                write_done_next = handle.done()
        torch.cuda.synchronize()
        loop_after_save_s = time.perf_counter() - t_save
        run_counts = counters()
        handle.wait()
        write_s = handle.seconds
        commit_s = time.perf_counter() - t_save
        check(is_committed(tmp, save_after), "checkpoint not committed")
        ckpt_bytes = sum(f.stat().st_size for f in
                         Path(tmp, f"pieces_{save_after}").iterdir())
        check(pump.stats["batches"] == steps and not pump.thread.is_alive(),
              f"pump: {pump.stats}")
        check(warm_counts == want and capture_counts == tuple(
            2 * w for w in want) and run_counts == capture_counts,
              f"flash wrapper counts: warm-up {warm_counts}, after capture "
              f"{capture_counts}, after the run {run_counts} (want {want} "
              "per eager or captured step, none per replay)")
        check(step.captures == 1 and step.replays == steps - 1,
              f"{step.captures} captures, {step.replays} replays")
        losses = [m["loss"].item() for m in metrics]
        norms = [m["grad_norm"].item() for m in metrics]
        check([int(m["step"]) for m in metrics] == list(range(1, steps + 1)),
              "metrics' steps")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"non-finite loss or grad norm: {losses}, {norms}")
        first = float(np.mean(losses[:TRAIN_CYCLE]))
        last = float(np.mean(losses[-TRAIN_CYCLE:]))
        check(last < first, f"loss did not fall over the cycle: {losses}")
        step_ms = [a.elapsed_time(e) for a, e in events]
        replay_ms = step_ms[2:save_after]
        mean_ms = float(np.mean(replay_ms))
        flops = train_flops(cfg, b, s)

        # One replay profiled: the flash kernels by name, the busy share.
        batch = on_card(steps % TRAIN_CYCLE)
        before = counters()
        prof = device_profile(lambda: step(state, batch), kinds=TRAIN_KINDS)
        check(counters() == before, "a replay moved the flash counters")
        per_replay = tuple(prof["launches_by_kind"][k] for k in FLASH_KINDS)
        check(per_replay == want, f"one replay launched flash fwd/dq/dkv "
              f"{per_replay} times, not {want}")
        del batch

        # Eager steps from a state of the same seed against the captured.
        opt_b = default_optimizer()
        state_b, _ = make_sharded_state(cfg, opt_b, SEED)
        step_b = make_train_step(cfg, opt_b)
        eager, eager_ms = [], []
        for i in range(3):
            batch = on_card(i)
            if i == 2:  # the moments exist now, as in a captured step
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eager.append(_metric(step_b.eager(state_b, batch)[1]))
            end.record()
            torch.cuda.synchronize()
            eager_ms.append(start.elapsed_time(end))
        above["eager_later_step"] = torch.cuda.max_memory_allocated() - base
        captured = [_metric(m) for m in metrics[:3]]
        check(eager == captured, f"eager steps {eager} != captured (1: "
              f"eager warm-up, 2: first captured, 3: replay) {captured}")
        del state_b, step_b, opt_b, batch
        torch.cuda.empty_cache()

        # The checkpoint restored into a fresh state, and one more step.
        opt_c = default_optimizer()
        state_c, _ = make_sharded_state(cfg, opt_c, SEED + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_sharded(tmp, like=state_c)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_diff = tensors_differing(state_tensors(state_c), at_save)
        step_c = make_train_step(cfg, opt_c)
        _, m_c = step_c(state_c, on_card(save_after % TRAIN_CYCLE))
        resumed = _metric(m_c)
        resumed_diff = tensors_differing(state_tensors(state_c), after_save)
        check(restored_diff == 0, f"{restored_diff} restored tensors differ "
              "from the state saved")
        check(resumed == _metric(metrics[save_after]) and resumed_diff == 0,
              f"the restored state's next step {resumed} (tensors differing "
              f"{resumed_diff}) != the original's "
              f"{_metric(metrics[save_after])}")
        del state_c, step_c, opt_c, at_save, after_save
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, step, metrics
    torch.cuda.empty_cache()
    stats = pump.stats
    hidden_ms = max(0.0, stats["host_s"] - stats["wait_s"]) / steps * 1e3
    out = {"phase": "train", "batch": [b, s], "n_layers": cfg.n_layers,
           "remat_policy": cfg.remat_policy, "steps": steps,
           "losses": losses, "grad_norms": norms,
           "loss_mean_first_cycle": first, "loss_mean_last_cycle": last,
           "step_ms": step_ms, "step_ms_mean": mean_ms,
           "step_ms_timed": replay_ms,
           "step_ms_while_writing": step_ms[save_after:],
           "host_ms_per_call": host_ms,
           "host_ms_per_replay_mean": float(np.mean(host_ms[2:save_after])),
           "wall_ms_per_replay": wall_ms,
           "eager_step_ms": eager_ms,
           "tokens_per_s": b * s / mean_ms * 1e3, "flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_BF16_FLOPS,
           "launches_per_step": dict(zip(FLASH_KINDS, per_replay)),
           "wrapper_counts_in_run": dict(zip(FLASH_KINDS, run_counts)),
           "captures": 1, "replays_in_run": steps - 1,
           "eager_vs_captured": {"eager": eager, "captured": captured,
                                 "bit_equal": True},
           "peak_memory_eager_bytes": eager_peak,
           "peak_memory_captured_bytes": captured_peak,
           # peak of a step above what was allocated before it (the state;
           # AdamW's moments are made during the first step)
           "step_memory_above_state_bytes": above,
           "pump": {"batches": stats["batches"],
                    "prefetched": stats["ready"],
                    "host_ms_per_batch": stats["host_s"] / steps * 1e3,
                    "consumer_wait_ms_per_batch":
                        stats["wait_s"] / steps * 1e3,
                    "host_ms_per_batch_hidden": hidden_ms,
                    "alone_wall_ms_per_batch": pump_alone_ms[0],
                    "alone_host_ms_per_batch": pump_alone_ms[1]},
           "checkpoint": {"step": save_after, "bytes_written": ckpt_bytes,
                          "snapshot_ms": snapshot_ms,
                          "write_s": write_s,
                          "save_to_commit_s": commit_s,
                          "steps_after_save": steps - save_after,
                          "steps_after_save_s": loop_after_save_s,
                          "write_done_after_next_step": write_done_next,
                          "restore_s": restore_s,
                          "restored_tensors_differing": restored_diff,
                          "resumed_step": resumed,
                          "resumed_tensors_differing": resumed_diff},
           "profile": prof}
    emit(out)
    return out


# The mesh phase: bench_400m trained over a one-card mesh (world size 1,
# NCCL) under each rules table, held against the one-device step from the
# same seed and batches. At world size 1 every placement is whole and no
# collective runs, so the two are expected bit for bit; a difference would
# be printed, and must stay within the reference's bf16 loss tolerance
# (tests/test_model.py:138).
MESH_STEPS = 6
MESH_LOSS_RTOL = 5e-3


@contextlib.contextmanager
def one_card_process_group():
    """A world-size-1 NCCL process group on this card (a free local port),
    destroyed on the way out."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_train_run(cfg, cycle, mesh=None, rules=None, steps=MESH_STEPS,
                   kinds=TRAIN_KINDS, pipeline=None) -> dict:
    """``steps`` steps of a fresh state of seed ``SEED`` over ``cycle``
    (through the pump; over ``mesh`` with ``rules`` when given, else on one
    device; as a pipeline when ``pipeline`` = (schedule, microbatches)
    gives one, ``make_pipeline_train_step``): step 1 the warm-up, step 2 the
    capture, then replays. Returns
    the metrics, the replays' ms (CUDA events), the memory the run adds to
    what was allocated before it (the state's bytes, the peak, and the
    peaks above the state during the warm-up and during the capture and
    replays), one profiled replay's device ms and launches by ``kinds``,
    and the state and step."""
    from ray_tpu_torch.data import device_batches
    from ray_tpu_torch.parallel import (
        batch_sharding,
        default_optimizer,
        make_pipeline_train_step,
        make_sharded_state,
        make_train_step,
    )

    opt = default_optimizer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    if mesh is None:
        state, _ = make_sharded_state(cfg, opt, SEED)
        step = make_train_step(cfg, opt)
        sharding = None
    else:
        state, sh = make_sharded_state(cfg, opt, SEED, mesh=mesh, rules=rules)
        if pipeline is None:
            step = make_train_step(cfg, opt, mesh=mesh, state_shardings=sh,
                                   rules=rules)
        else:
            step = make_pipeline_train_step(
                cfg, opt, pipeline[1], mesh=mesh, state_shardings=sh,
                rules=rules, schedule=pipeline[0])
        sharding = batch_sharding(mesh, rules)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - before
    pump = device_batches(
        lambda: (cycle[i % len(cycle)] for i in range(steps)),
        prefetch_batches=2, sharding=sharding)
    metrics, events = [], []
    for batch in pump:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        metrics.append(m)
        events.append((start, end))
        if len(metrics) == 1:  # the warm-up (AdamW's moments made here)
            torch.cuda.synchronize()
            warm_up_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        if sharding is not None:
            check(all(type(v).__name__ == "DTensor" for v in batch.values()),
                  "the mesh pump yielded tensors that are not DTensors")
    torch.cuda.synchronize()
    check(step.captures == 1 and step.replays == steps - 1,
          f"{step.captures} captures, {step.replays} replays")
    captured_peak = torch.cuda.max_memory_allocated()
    peak = max(warm_up_peak, captured_peak) - before
    above = {"state_bytes": state_bytes,
             "warm_up": warm_up_peak - before - state_bytes,
             "captured": captured_peak - base}
    params = [_full(p).detach().clone() for p in _param_leaves(state)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in cycle[0].items()}
    prof = device_profile(lambda: step(state, batch), kinds=kinds)
    del batch
    replay_ms = [a.elapsed_time(e) for a, e in events[2:]]
    return {"metrics": [_metric(m) for m in metrics], "replay_ms": replay_ms,
            "peak_bytes": peak, "memory_above_state": above,
            "profile": prof, "params": params,
            "launches": tuple(prof["launches_by_kind"][k]
                              for k in FLASH_KINDS),
            "state": state, "step": step}


def _param_leaves(state) -> list:
    from ray_tpu_torch.models.transformer import tree_leaves

    return tree_leaves(state.params)


def _state_full(state) -> list:
    """Every tensor of a TrainState (``state_tensors``), whole."""
    return [_full(t) for t in state_tensors(state)]


def phase_mesh(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` over a one-card mesh (``build_mesh(MeshConfig(dp=1))``
    in a world-size-1 NCCL group): ``make_sharded_state(..., mesh=)`` and
    ``make_train_step(..., mesh=)`` fed by ``device_batches(...,
    sharding=batch_sharding(mesh))``, under ``DEFAULT_RULES`` and then
    ``FSDP_RULES``, ``MESH_STEPS`` steps each (warm-up, capture, replays).
    Each is held against the one-device step from the same seed and
    batches: losses, grad norms and every parameter after the last step.
    One profiled replay of each counts the flash kernels by name (48 / 24
    / 24); the replays' ms (CUDA events) and the peak memory stand beside
    the one-device step's. Then the mesh state's checkpoint restores into a
    one-device state bit for bit, and the other way round."""
    import shutil
    import tempfile

    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        FSDP_RULES,
        MeshConfig,
        build_mesh,
        default_optimizer,
        make_sharded_state,
    )
    from ray_tpu_torch.train import load_sharded, save_sharded

    check(cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m trains with flash "
          "attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    out = {"phase": "mesh", "batch": [b, s], "n_layers": cfg.n_layers,
           "steps": MESH_STEPS, "runs": {}}

    def summary(run):
        return {"losses": [m[0] for m in run["metrics"]],
                "grad_norms": [m[1] for m in run["metrics"]],
                "replay_ms": run["replay_ms"],
                "replay_ms_mean": float(np.mean(run["replay_ms"])),
                "peak_memory_bytes": run["peak_bytes"],  # above its start
                "memory_above_state_bytes": run["memory_above_state"],
                "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
                "profile_top_kernels_ms": run["profile"]["top_kernels_ms"],
                "profile_device_ms_by_kind":
                    run["profile"]["device_ms_by_kind"],
                "profile_busy_share": run["profile"]["device_busy_share"]}

    ref = mesh_train_run(cfg, cycle)
    check(ref["launches"] == want, f"one device: a replay launched flash "
          f"{ref['launches']}, not {want}")
    ref_params = ref.pop("params")
    out["runs"]["one_device"] = summary(ref)
    del ref["state"], ref["step"]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        check(mesh.mesh_dim_names == ("dp",) and tuple(mesh.shape) == (1,),
              f"mesh {mesh}")
        try:
            for name, rules in (("DEFAULT_RULES", DEFAULT_RULES),
                                ("FSDP_RULES", FSDP_RULES)):
                last_state = None  # one state on the card at a time
                torch.cuda.empty_cache()
                run = mesh_train_run(cfg, cycle, mesh, rules)
                check(run["launches"] == want, f"{name}: a replay launched "
                      f"flash {run['launches']}, not {want}")
                params = run.pop("params")  # after the last step
                differing = tensors_differing(params, ref_params)
                max_diff = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(params, ref_params))
                del params
                same = run["metrics"] == ref["metrics"]
                rel = max(abs(g[0] - r[0]) / abs(r[0]) for g, r in
                          zip(run["metrics"], ref["metrics"]))
                res = summary(run)
                res.update({"metrics_bit_equal": same,
                            "params_differing": differing,
                            "params_max_abs_diff": max_diff,
                            "loss_max_rel_diff": rel})
                if not same or differing:
                    print(f"chip_smoke mesh {name}: differs from one device: "
                          f"{differing} params (max {max_diff}), loss rel "
                          f"{rel}", flush=True)
                check(rel <= MESH_LOSS_RTOL, f"{name}: loss differs from the "
                      f"one-device step by {rel} relative")
                out["runs"][name] = res
                last_state, last_rules = run["state"], rules
                del run["step"], run
                torch.cuda.empty_cache()

            # mesh -> one device, and one device -> mesh, bit for bit
            save_sharded(last_state, f"{tmp}/mesh", step=MESH_STEPS + 1,
                         wait=True)
            one, _ = make_sharded_state(cfg, default_optimizer(), SEED + 7)
            t0 = time.perf_counter()
            load_sharded(f"{tmp}/mesh", like=one)
            torch.cuda.synchronize()
            restore_into_one_s = time.perf_counter() - t0
            into_one = tensors_differing(_state_full(one),
                                         _state_full(last_state))
            save_sharded(one, f"{tmp}/one", step=MESH_STEPS + 1, wait=True)
            del last_state
            torch.cuda.empty_cache()
            back, _ = make_sharded_state(cfg, default_optimizer(), SEED + 9,
                                         mesh=mesh, rules=last_rules)
            load_sharded(f"{tmp}/one", like=back)
            into_mesh = tensors_differing(_state_full(back), _state_full(one))
            check(into_one == 0 and into_mesh == 0,
                  f"checkpoint restores differ: mesh -> one device "
                  f"{into_one} tensors, one device -> mesh {into_mesh}")
            out["checkpoint"] = {
                "rules": "FSDP_RULES", "bytes_written": sum(
                    f.stat().st_size for f in
                    Path(tmp, "mesh", f"pieces_{MESH_STEPS + 1}").iterdir()),
                "mesh_to_one_device_tensors_differing": into_one,
                "one_device_to_mesh_tensors_differing": into_mesh,
                "restore_into_one_device_s": restore_into_one_s}
            del one, back
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["replay_ms_table"] = {k: v["replay_ms_mean"]
                              for k, v in out["runs"].items()}
    out["peak_memory_table"] = {k: v["peak_memory_bytes"]
                                for k, v in out["runs"].items()}
    emit(out)
    return out


# The moe phase: bench_400m with 4 experts, top-2, capacity factor 2.0 (the
# reference's MoE settings, tests/test_parallel.py:157 and
# __graft_entry__.py:231-234, at the flagship's widths: 971.6 M parameters)
# trained on one card as the train phase trains bench_400m. Kinds of kernel
# in its step, matched in order on the full name: the flash kernels,
# cuBLAS's products (the expert products among them), the MoE dispatch and
# combine (index copies and gathers, and the sort of the gather's backward),
# the foreach kernels, conversions and copies, other elementwise work.
MOE_KINDS = {**FLASH_KINDS, "gemm": DECODE_KINDS["gemm"],
             "scatter_gather": "index|scatter|gather|[Rr]adix|[Ss]ort",
             "foreach": "multi_tensor_apply",
             "copy_convert": "copy_kernel|direct_copy",
             "elementwise": "elementwise_kernel|reduce_kernel"}
# The index dispatch against the one-hot plain version, one layer at full
# width in bf16: both sum a token's <= 2 weighted expert rows in fp32 and
# round to bf16 once, so they may differ by one bf16 ulp (2^-8 relative).
MOE_LAYER_RTOL, MOE_LAYER_ATOL = 2.0 ** -8, 1e-6
MOE_GENERATE = (8, 128, 16)  # prompts, prompt length, new tokens


def bench_400m_dense():
    """``bench_400m`` with dense attention, as the pipeline's stages run
    it (``parallel/pipeline.py``); otherwise the flagship's settings."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.bench_400m(),
                               attn_impl="dense")


def bench_400m_moe():
    from ray_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.bench_400m(), moe_experts=4,
                               moe_top_k=2, moe_capacity_factor=2.0)


def moe_layer_check(params, cfg, tokens) -> dict:
    """Layer 0's ``moe_ffn`` on its own input (the normed embedding of
    ``tokens``) at full width: the index dispatch against the one-hot plain
    version (``moe_ffn_reference``) under ``MOE_LAYER_RTOL``, the picks each
    drops, and both timed (CUDA events)."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import moe

    lp = tf.layer_params(params, 0)
    k, cf = cfg.moe_top_k, cfg.moe_capacity_factor
    with torch.no_grad():
        h = tf._rms_norm(params["embed"][tokens].to(cfg.dtype),
                         lp["ln1"]["scale"])
        args = (h, lp["moe"]["router"], lp["moe"]["wi"], lp["moe"]["wo"])
        got, aux = moe.moe_ffn(*args, top_k=k, capacity_factor=cf)
        want, want_aux = moe.moe_ffn_reference(*args, top_k=k,
                                               capacity_factor=cf)
        g, n, _ = h.shape
        cap = moe.capacity(n, cfg.moe_experts, k, cf)
        dropped = int(moe.route(h, args[1], k, cap).dropped())
        dispatch_t = moe.one_hot_routing(h, args[1], k, cap)[0]
        dropped_ref = k * g * n - int(dispatch_t.sum())
        del dispatch_t
        err = (got.float() - want.float()).abs()
        bound = MOE_LAYER_RTOL * want.float().abs() + MOE_LAYER_ATOL
        over = float((err / bound).max())
        index_ms = cuda_ms(lambda: moe.moe_ffn(*args, top_k=k,
                                               capacity_factor=cf), 5)
        one_hot_ms = cuda_ms(lambda: moe.moe_ffn_reference(
            *args, top_k=k, capacity_factor=cf), 3)
        experts_ms = cuda_ms(lambda: moe.experts(
            torch.zeros((cfg.moe_experts, g, cap, cfg.d_model),
                        dtype=h.dtype, device=h.device),
            args[2], args[3], h.dtype), 5)
    out = {"shape": list(h.shape), "capacity": cap,
           "max_abs_err": float(err.max()), "max_err_over_bound": over,
           "bit_equal": bool(torch.equal(got, want)),
           "aux": aux.item(), "aux_one_hot": want_aux.item(),
           "dropped": dropped, "dropped_one_hot": dropped_ref,
           "index_ms": index_ms, "one_hot_ms": one_hot_ms,
           "expert_products_ms": experts_ms}
    check(over <= 1.0 and dropped == dropped_ref
          and abs(aux.item() - want_aux.item()) <= 1e-6 * abs(want_aux.item()),
          f"moe_ffn at full width differs from its one-hot plain version: "
          f"{out}")
    return out


def moe_drops_per_layer(params, cfg, tokens) -> list:
    """Picks past capacity in each layer of an eager forward of ``tokens``
    (``moe.moe_ffn`` wrapped for the forward to count them)."""
    from ray_tpu_torch.models.transformer import forward
    from ray_tpu_torch.ops import moe

    drops = []
    original = moe.moe_ffn

    def counting(x, router_w, wi, wo, *, top_k, capacity_factor, mesh=None):
        cap = moe.capacity(x.shape[1], router_w.shape[-1], top_k,
                           capacity_factor)
        drops.append(moe.route(x, router_w, top_k, cap).dropped())
        return original(x, router_w, wi, wo, top_k=top_k,
                        capacity_factor=capacity_factor, mesh=mesh)

    moe.moe_ffn = counting
    try:
        with torch.no_grad():
            forward(params, tokens, cfg)
    finally:
        moe.moe_ffn = original
    return [int(d) for d in drops]


def moe_generate_check(cfg) -> dict:
    """Greedy ``generate`` of the MoE model (bf16 from a seeded init,
    ``MOE_GENERATE``) through its captured programs, against the same
    bodies run uncaptured on the card: the tokens must be equal."""
    from ray_tpu_torch.models import generation
    from ray_tpu_torch.models.transformer import init_params

    b, s, new = MOE_GENERATE
    params, icfg = generation.prepare_for_inference(init_params(cfg, SEED),
                                                    cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, icfg.vocab_size, (b, s))).cuda()
    max_len = s + new
    t0 = time.perf_counter()
    captured = generation.generate(params, prompt, icfg, max_new_tokens=new,
                                   max_len=max_len)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    with torch.no_grad():
        cache = generation.init_kv_cache(icfg, b, max_len)
        logits = generation._forward_cached(params, prompt, cache, 0,
                                            icfg)[0][:, -1]
        first = torch.argmax(logits, dim=-1)
        zeros_i = torch.zeros(b, dtype=torch.long, device="cuda")
        rest = generation.decode_loop_into(
            params, cache, first.clone(), torch.tensor(s, device="cuda"),
            torch.zeros(b, device="cuda"), zeros_i, zeros_i.clone(), icfg,
            torch.zeros((b, new - 1), dtype=torch.long, device="cuda"))
    uncaptured = torch.cat([first[:, None], rest], dim=1)
    check(captured.shape == (b, new) and torch.equal(captured, uncaptured),
          "captured MoE generate differs from the same loop run uncaptured")
    programs = generation.programs()
    generation.release_programs()
    del params, cache
    torch.cuda.empty_cache()
    return {"prompts": b, "prompt_len": s, "new_tokens": new,
            "captured_equals_uncaptured": True,
            "first_call_s": first_call_s, "programs": programs}


def phase_moe(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` with 4 experts (``bench_400m_moe``) trained on one
    card through ``make_train_step``: seeded numpy batches [8, 2048] through
    ``device_batches``, step 1 the eager warm-up, step 2 the capture, steps
    3-6 replays (``mesh_train_run``). Checks: one profiled replay launches
    the flash kernels 48 / 24 / 24 times by name; losses and grad norms
    finite and the loss falling over the cycle (steps 5 and 6 below steps 1
    and 2, on the same batches); three eager steps from a state of the same
    seed equal the captured ones bit for bit; layer 0's ``moe_ffn`` at full
    width equals the one-hot plain version under ``MOE_LAYER_RTOL`` and
    drops as many picks; the same training over a one-card mesh (a
    world-size-1 NCCL group, ``DEFAULT_RULES``) equal to one device bit for
    bit (losses, grad norms, every parameter after step 6); and greedy
    ``generate`` through its captured programs equal to the same bodies
    run uncaptured. Printed: replay ms (CUDA events), tokens/s, peak memory,
    device ms by kind of a profiled replay, picks dropped per layer."""
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        build_mesh,
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    check(cfg.moe_experts == 4 and cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m with 4 experts trains "
          "with flash attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)

    def on_card(i):
        return {k: torch.from_numpy(v).cuda() for k, v in cycle[i].items()}

    params = init_params(cfg, SEED)
    tokens = on_card(0)["tokens"]
    layer = moe_layer_check(params, cfg, tokens)
    drops = moe_drops_per_layer(params, cfg, tokens)
    del params, tokens
    torch.cuda.empty_cache()

    run = mesh_train_run(cfg, cycle, kinds=MOE_KINDS)
    check(run["launches"] == want, f"a replay launched flash "
          f"{run['launches']}, not {want}")
    losses = [m[0] for m in run["metrics"]]
    norms = [m[1] for m in run["metrics"]]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses}, {norms}")
    check(losses[4] < losses[0] and losses[5] < losses[1],
          f"the loss did not fall over the cycle: {losses}")
    ref_params = run.pop("params")
    del run["state"], run["step"]
    torch.cuda.empty_cache()

    opt_b = default_optimizer()
    state_b, _ = make_sharded_state(cfg, opt_b, SEED)
    step_b = make_train_step(cfg, opt_b)
    eager = [_metric(step_b.eager(state_b, on_card(i))[1]) for i in range(3)]
    check(eager == run["metrics"][:3], f"eager steps {eager} != captured "
          f"{run['metrics'][:3]}")
    del state_b, step_b, opt_b
    torch.cuda.empty_cache()

    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        mrun = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                              kinds=MOE_KINDS)
        differing = tensors_differing(mrun.pop("params"), ref_params)
        del mrun["state"], mrun["step"], ref_params
        torch.cuda.empty_cache()
    check(mrun["launches"] == want, f"mesh: a replay launched flash "
          f"{mrun['launches']}, not {want}")
    check(mrun["metrics"] == run["metrics"] and differing == 0,
          f"the one-card mesh differs from one device: metrics "
          f"{mrun['metrics']} against {run['metrics']}, {differing} "
          "parameters differing")
    gen = moe_generate_check(cfg)
    mean_ms = float(np.mean(run["replay_ms"]))
    prof = run["profile"]
    out = {"phase": "moe", "batch": [b, s], "n_layers": cfg.n_layers,
           "moe_experts": cfg.moe_experts, "moe_top_k": cfg.moe_top_k,
           "moe_capacity_factor": cfg.moe_capacity_factor,
           "param_count": cfg.param_count(), "steps": MESH_STEPS,
           "losses": losses, "grad_norms": norms,
           "replay_ms": run["replay_ms"], "replay_ms_mean": mean_ms,
           "tokens_per_s": b * s / mean_ms * 1e3,
           "peak_memory_bytes": run["peak_bytes"],
           "memory_above_state_bytes": run["memory_above_state"],
           "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
           "profile_device_ms_by_kind": prof["device_ms_by_kind"],
           "profile_launches_by_kind": prof["launches_by_kind"],
           "profile_top_kernels_ms": prof["top_kernels_ms"],
           "profile_busy_share": prof["device_busy_share"],
           "eager_vs_captured": {"eager": eager, "bit_equal": True},
           "mesh": {"replay_ms_mean": float(np.mean(mrun["replay_ms"])),
                    "peak_memory_bytes": mrun["peak_bytes"],
                    "metrics_bit_equal": True, "params_differing": 0},
           "dropped_per_layer": drops,
           "picks_per_layer": cfg.moe_top_k * b * s,
           "layer0_check": layer, "generate": gen}
    emit(out)
    return out


# The seq phase: bench_400m over a one-card mesh with ring and Ulysses
# attention (sp = 1: the mesh has no sp axis, so no hop and no all-to-all
# runs; the cell exercises the local_map layer and the local attention).
SEQ_STEPS = 3  # warm-up, capture, one replay


def phase_seq(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """Over a one-card mesh (a world-size-1 NCCL group): the forward of
    ``bench_400m`` with ``attn_impl`` "ring" and "ulysses" against the
    dense-attention forward on the same parameters (the forward phase's
    tolerance); ``ulysses_attention(..., attn_impl="flash")`` at
    ``MAIN_SHAPE`` bf16 equal to ``flash_attention`` bit for bit; and
    ``SEQ_STEPS`` train steps of each (warm-up, capture, replay) with finite
    losses. Printed: the logits' differences, replay ms (CUDA events) and
    peak memory."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from ray_tpu_torch.models.transformer import forward, tree_map
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.ulysses_attention import ulysses_attention
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        batch_sharding,
        build_mesh,
        default_optimizer,
        make_sharded_state,
    )

    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    out = {"phase": "seq", "batch": [b, s], "n_layers": cfg.n_layers,
           "forward": {}, "train": {}}
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        q, k, v = (torch.randn(MAIN_SHAPE, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        whole = [Replicate()]
        with torch.no_grad():
            got = ulysses_attention(
                *(DTensor.from_local(t, mesh, whole) for t in (q, k, v)),
                mesh=mesh, attn_impl="flash").to_local()
            check(torch.equal(got, fa.flash_attention(q, k, v)),
                  "ulysses_attention(flash) differs from flash_attention")
        out["ulysses_flash_bit_equal_flash"] = True
        del q, k, v, got

        state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                      mesh=mesh)
        local = tree_map(lambda p: p.to_local(), state.params)
        tokens = torch.from_numpy(cycle[0]["tokens"]).cuda()
        placed = distribute_tensor(tokens, mesh, batch_sharding(mesh)[1],
                                   src_data_rank=None)
        with torch.no_grad():
            dense = forward(local, tokens,
                            dataclasses.replace(cfg, attn_impl="dense"))
            for impl in ("ring", "ulysses"):
                icfg = dataclasses.replace(cfg, attn_impl=impl)
                logits = forward(state.params, placed, icfg, mesh).to_local()
                diff = (logits.float() - dense.float()).abs()
                agree = float((logits.argmax(-1) == dense.argmax(-1))
                              .float().mean())
                res = {"logits_max_abs_diff_vs_dense": float(diff.max()),
                       "logits_mean_abs_diff_vs_dense": float(diff.mean()),
                       "argmax_agreement_vs_dense": agree,
                       "forward_ms": cuda_ms(lambda: forward(
                           state.params, placed, icfg, mesh), 2, 1)}
                out["forward"][impl] = res
                # the forward phase's tolerance
                check(res["logits_mean_abs_diff_vs_dense"] <= 2e-2
                      and res["logits_max_abs_diff_vs_dense"] <= 0.5
                      and agree >= 0.95, f"{impl} forward disagrees with "
                      f"dense: {res}")
                del logits, diff
        del state, local, dense
        torch.cuda.empty_cache()
        for impl in ("ring", "ulysses"):
            run = mesh_train_run(dataclasses.replace(cfg, attn_impl=impl),
                                 cycle, mesh, DEFAULT_RULES, steps=SEQ_STEPS)
            losses = [m[0] for m in run["metrics"]]
            check(all(np.isfinite(losses)), f"{impl}: losses {losses}")
            out["train"][impl] = {
                "losses": losses, "grad_norms": [m[1] for m in
                                                 run["metrics"]],
                "replay_ms": run["replay_ms"],
                "peak_memory_bytes": run["peak_bytes"],
                "profile_device_ms_by_kind":
                    run["profile"]["device_ms_by_kind"]}
            del run
            torch.cuda.empty_cache()
    emit(out)
    return out


# The pipe phase: bench_400m with dense attention (the pipeline's stages run
# dense attention, as the reference's) trained as a pipeline over a one-card
# mesh (world size 1) under GPipe and 1F1B. At pp = 1 the schedule, its ring
# buffer and the scoring run, but no hop and no collective over pp does.
# 1F1B's peak activation memory may be at most PIPE_PEAK_RATIO times GPipe's
# (__graft_entry__.py:219-224).
PIPE_SCHEDULES = ("gpipe", "1f1b")
PIPE_MICROBATCHES = 8  # microbatches of one row at [8, 2048]
PIPE_STEPS = 6  # warm-up, capture, four replays
PIPE_EAGER_STEPS = 3
PIPE_PEAK_RATIO = 1.05


def phase_pipe(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1]) -> dict:
    """``bench_400m`` (dense attention, fp32 parameters, bf16 compute, remat
    "dots") through ``make_pipeline_train_step`` over a one-card mesh (a
    world-size-1 NCCL group), ``PIPE_MICROBATCHES`` microbatches, under each
    schedule: ``PIPE_STEPS`` steps through the pump (warm-up, capture,
    replays), then ``PIPE_EAGER_STEPS`` eager steps from a fresh state of
    the same seed, which must equal the captured ones bit for bit; the peak
    memory of the last eager step above what was allocated before it. The
    first step's loss must lie within ``MESH_LOSS_RTOL`` of the
    non-pipelined dense loss on the same weights and batch, and 1F1B's peak
    within ``PIPE_PEAK_RATIO`` of GPipe's. No flash kernel runs (checked by
    name in a profiled replay). Printed: replay ms (CUDA events), tokens/s,
    MFU, peaks, launches and device ms by kind of a profiled replay."""
    from ray_tpu_torch.models.transformer import loss_fn
    from ray_tpu_torch.parallel import (
        DEFAULT_RULES,
        MeshConfig,
        batch_sharding,
        build_mesh,
        default_optimizer,
        make_pipeline_train_step,
        make_sharded_state,
    )
    from torch.distributed.tensor import distribute_tensor

    check(cfg.attn_impl == "dense" and cfg.remat
          and cfg.remat_policy == "dots", "the pipelined bench_400m trains "
          "with dense attention under remat 'dots'")
    cycle = numpy_train_batches(cfg.vocab_size, b, s, TRAIN_CYCLE, SEED + 2)
    flops = train_flops(cfg, b, s)
    out = {"phase": "pipe", "batch": [b, s], "n_layers": cfg.n_layers,
           "microbatches": PIPE_MICROBATCHES, "steps": PIPE_STEPS,
           "pp": 1, "runs": {}}
    with one_card_process_group():
        mesh = build_mesh(MeshConfig(dp=1))

        def placed(i):
            return {k: distribute_tensor(torch.from_numpy(v).cuda(), mesh,
                                         batch_sharding(mesh)[1],
                                         src_data_rank=None)
                    for k, v in cycle[i].items()}

        state, _ = make_sharded_state(cfg, default_optimizer(), SEED,
                                      mesh=mesh)
        with torch.no_grad():
            dense_loss = loss_fn(state.params, placed(0), cfg,
                                 mesh).full_tensor().item()
        del state
        torch.cuda.empty_cache()
        out["dense_first_loss"] = dense_loss
        for schedule in PIPE_SCHEDULES:
            t0 = time.perf_counter()
            run = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                                 steps=PIPE_STEPS,
                                 pipeline=(schedule, PIPE_MICROBATCHES))
            del run["state"], run["step"], run["params"]
            torch.cuda.empty_cache()
            check(run["launches"] == (0, 0, 0), f"{schedule}: a replay "
                  f"launched flash kernels {run['launches']}")
            losses = [m[0] for m in run["metrics"]]
            rel = abs(losses[0] - dense_loss) / abs(dense_loss)
            check(all(np.isfinite(losses)) and rel <= MESH_LOSS_RTOL,
                  f"{schedule}: losses {losses} against the dense step's "
                  f"{dense_loss}")
            opt = default_optimizer()
            state, sh = make_sharded_state(cfg, opt, SEED, mesh=mesh)
            step = make_pipeline_train_step(cfg, opt, PIPE_MICROBATCHES,
                                            mesh=mesh, state_shardings=sh,
                                            schedule=schedule)
            eager = []
            for i in range(PIPE_EAGER_STEPS):
                batch = placed(i)
                if i == PIPE_EAGER_STEPS - 1:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                eager.append(_metric(step.eager(state, batch)[1]))
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated() - base
            check(eager == run["metrics"][:PIPE_EAGER_STEPS],
                  f"{schedule}: eager steps {eager} != captured "
                  f"{run['metrics'][:PIPE_EAGER_STEPS]}")
            del state, step, opt, batch
            torch.cuda.empty_cache()
            mean_ms = float(np.mean(run["replay_ms"]))
            prof = run["profile"]
            out["runs"][schedule] = {
                "losses": losses, "grad_norms": [m[1] for m in
                                                 run["metrics"]],
                "first_loss_rel_diff_vs_dense": rel,
                "replay_ms": run["replay_ms"], "replay_ms_mean": mean_ms,
                "tokens_per_s": b * s / mean_ms * 1e3,
                "mfu": flops / (mean_ms / 1e3) / PEAK_BF16_FLOPS,
                "eager_step_peak_above_start_bytes": eager_peak,
                "peak_memory_bytes": run["peak_bytes"],
                "memory_above_state_bytes": run["memory_above_state"],
                "eager_vs_captured": {"eager": eager, "bit_equal": True},
                "launches_per_step": dict(zip(FLASH_KINDS, run["launches"])),
                "profile_launches_by_kind": prof["launches_by_kind"],
                "profile_device_ms_by_kind": prof["device_ms_by_kind"],
                "profile_top_kernels_ms": prof["top_kernels_ms"],
                "profile_busy_share": prof["device_busy_share"],
                "seconds": time.perf_counter() - t0}
    peaks = {k: v["eager_step_peak_above_start_bytes"]
             for k, v in out["runs"].items()}
    out["peak_1f1b_over_gpipe"] = peaks["1f1b"] / peaks["gpipe"]
    check(peaks["1f1b"] <= PIPE_PEAK_RATIO * peaks["gpipe"],
          f"1F1B's peak {peaks['1f1b']} above {PIPE_PEAK_RATIO} x GPipe's "
          f"{peaks['gpipe']}")
    emit(out)
    return out


# multicard: bench_400m over four cards (NCCL, one process per card, spawned
# by this script) in six layouts, each against the one-card run of the same
# seed and batches (dense attention for ring, Ulysses and the pipelines, whose
# math it is; the same MoE model for the expert layout), losses within
# MESH_LOSS_RTOL per step; then dryrun_multidevice(4). Kinds of kernel in a
# replay: NCCL's collectives first, then the train step's kinds.
MULTICARD_WORLD = 4
MULTICARD_STEPS = 4  # warm-up, capture, two replays
MULTICARD_KINDS = {"nccl": "nccl", **MOE_KINDS}
MULTICARD_LAYOUTS = {  # mesh, config changes, pipeline (schedule, M)
    "ring_dp2_sp2": ({"dp": 2, "sp": 2}, {"attn_impl": "ring"}, None),
    "ulysses_sp2_tp2": ({"sp": 2, "tp": 2}, {"attn_impl": "ulysses"}, None),
    "moe_ep2_dp2": ({"dp": 2, "ep": 2}, {"moe_experts": 4, "moe_top_k": 2,
                                          "moe_capacity_factor": 2.0}, None),
    "pipe_1f1b_pp4": ({"pp": 4}, {"attn_impl": "dense"}, ("1f1b", 8)),
    "pipe_gpipe_dp2_pp2": ({"dp": 2, "pp": 2}, {"attn_impl": "dense"},
                           ("gpipe", 4)),
    "pipe_1f1b_pp2_tp2": ({"pp": 2, "tp": 2}, {"attn_impl": "dense"},
                          ("1f1b", 4)),
}
MULTICARD_TIMEOUT_S = 900


def multicard_rank(rank: int, world: int, port: str) -> None:
    """One rank of ``multicard`` (card ``rank``): the one-card runs, then
    each layout over the four cards, then the dry run; rank 0 prints the
    result line."""
    import faulthandler

    import torch.distributed as dist

    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, build_mesh
    from ray_tpu_torch.parallel.dryrun import dryrun_multidevice

    # a rank still waiting shortly before the launcher's deadline shows
    # where (every thread's stack), and exits
    faulthandler.dump_traceback_later(MULTICARD_TIMEOUT_S - 30, exit=True)

    def stage(what):
        print(f"multicard rank {rank}: {what} "
              f"({time.strftime('%H:%M:%S')})", flush=True)

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        base = TransformerConfig.bench_400m()
        b, s = MAIN_SHAPE[0], MAIN_SHAPE[1]
        cycle = numpy_train_batches(base.vocab_size, b, s, TRAIN_CYCLE,
                                    SEED + 2)
        one_card = {}
        for name in ("dense", "moe"):
            kw = MULTICARD_LAYOUTS["moe_ep2_dp2"][1] if name == "moe" else {
                "attn_impl": "dense"}
            stage(f"one-card run, {name}")
            run = mesh_train_run(dataclasses.replace(base, **kw), cycle,
                                 steps=MULTICARD_STEPS)
            one_card[name] = {"metrics": run["metrics"],
                              "replay_ms": run["replay_ms"]}
            del run
            torch.cuda.empty_cache()
        out = {"phase": "multicard", "world": world, "batch": [b, s],
               "layouts": {}}
        for name, (sizes, kw, pipeline) in MULTICARD_LAYOUTS.items():
            stage(f"layout {name}")
            cfg = dataclasses.replace(base, **kw)
            mesh = build_mesh(MeshConfig(**sizes))
            run = mesh_train_run(cfg, cycle, mesh, DEFAULT_RULES,
                                 steps=MULTICARD_STEPS, kinds=MULTICARD_KINDS,
                                 pipeline=pipeline)
            ref = one_card["moe" if cfg.moe_experts else "dense"]
            rel = [abs(g[0] - r[0]) / abs(r[0])
                   for g, r in zip(run["metrics"], ref["metrics"])]
            prof = run["profile"]
            out["layouts"][name] = {
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "pipeline": pipeline,
                "losses": [m[0] for m in run["metrics"]],
                "one_card_losses": [m[0] for m in ref["metrics"]],
                "loss_rel_diff": rel,
                "replay_ms": run["replay_ms"],
                "one_card_replay_ms": ref["replay_ms"],
                "peak_memory_bytes": run["peak_bytes"],
                "device_ms_by_kind": prof["device_ms_by_kind"],
                "launches_by_kind": prof["launches_by_kind"],
                "collective_ms": prof["device_ms_by_kind"]["nccl"],
                "busy_share": prof["device_busy_share"]}
            check(all(np.isfinite(m[0]) for m in run["metrics"])
                  and max(rel) <= MESH_LOSS_RTOL,
                  f"{name}: losses {run['metrics']} against one card "
                  f"{ref['metrics']}")
            del run
            torch.cuda.empty_cache()
        stage("dryrun_multidevice")
        out["dryrun"] = dryrun_multidevice(world)
        if rank == 0:
            emit(out)
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


def phase_multicard() -> None:
    """Spawns ``multicard_rank`` in ``MULTICARD_WORLD`` processes (this
    script, one per card) and waits for them, at most
    ``MULTICARD_TIMEOUT_S``; when a rank fails the others are killed, and
    every rank's output is printed. Needs four cards."""
    import shutil
    import socket
    import tempfile

    n = torch.cuda.device_count()
    if n < MULTICARD_WORLD:
        raise RuntimeError(f"multicard needs {MULTICARD_WORLD} CUDA cards; "
                           f"{n} visible")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_multicard_"))
    logs = [open(work / f"rank{r}.log", "w+") for r in range(MULTICARD_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "multicard-rank",
         str(r), str(MULTICARD_WORLD), port], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(MULTICARD_WORLD)]
    deadline = time.monotonic() + MULTICARD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.returncode is not None):
                break  # a rank failed: its peers would wait for it
            if time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * MULTICARD_WORLD:
        for r, (c, o) in enumerate(zip(codes, outs)):
            print(f"--- multicard rank {r} (exit {c}) ---\n{o[-8000:]}",
                  flush=True)
        raise RuntimeError(f"multicard ranks exited {codes}")
    print(outs[0], end="", flush=True)
    shutil.rmtree(work, ignore_errors=True)


# Flash against dense attention through the whole model:
# - fp32 (TF32 off), 2 layers: the same math with sums in another order and
#   expf; each leaf's grads may differ by 2e-4 of that leaf's largest dense
#   grad (a wrong mask or GQA sum moves them by O(1) of it).
# - bf16, full depth, the first train step: the two attentions round p and
#   ds at different places through 24 layers; loss within 2e-3 and grad
#   norm within 5e-3 relative (both ~1e-4 on the card).
GRAD_FP32_RTOL = 2e-4
STEP_LOSS_ATOL, STEP_NORM_RTOL = 2e-3, 5e-3


def phase_grad(cfg, b32: int = 2, b: int = MAIN_SHAPE[0],
               s: int = MAIN_SHAPE[1], steps: int = 7) -> dict:
    from ray_tpu_torch.models.transformer import (
        init_params,
        loss_fn,
        tree_leaves,
        tree_map,
    )
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = tree_map(lambda t: t.requires_grad_(True),
                      init_params(cfg32, SEED))
    batch = train_batch(cfg.vocab_size, b32, s, SEED + 3)
    grads = {}
    for impl in ("flash", "dense"):
        loss = loss_fn(params, batch,
                       dataclasses.replace(cfg32, attn_impl=impl))
        grads[impl] = (loss.item(),
                       torch.autograd.grad(loss, tree_leaves(params)))
    ratios = [((f - d).abs().max() / d.abs().max().clamp_min(1e-30)).item()
              for f, d in zip(grads["flash"][1], grads["dense"][1])]
    out = {"phase": "grad", "fp32_layers": 2, "fp32_batch": [b32, s],
           "fp32_loss_flash": grads["flash"][0],
           "fp32_loss_dense": grads["dense"][0],
           "fp32_grad_max_rel_err": max(ratios),
           "fp32_grad_rtol": GRAD_FP32_RTOL}
    check(max(ratios) <= GRAD_FP32_RTOL
          and abs(grads["flash"][0] - grads["dense"][0]) <= 1e-4,
          f"fp32 flash grads disagree with dense: {out}")
    del grads, params
    torch.cuda.empty_cache()

    # The train phase's run again (same init, same batch), beside the same
    # steps with dense attention: step 1 is held to the tolerances above;
    # the later steps are reported, to tell the optimizer's dynamics on a
    # repeated batch from the kernels'.
    init = init_params(cfg, SEED)
    batch = train_batch(cfg.vocab_size, b, s, SEED + 2)
    traj = {}
    for impl in ("flash", "dense"):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        opt = default_optimizer()
        state, _ = make_sharded_state(icfg, opt, SEED,
                                      params=tree_map(torch.clone, init))
        step = make_train_step(icfg, opt)
        ms = [step(state, batch)[1] for _ in range(steps)]
        traj[impl] = [(m["loss"].item(), m["grad_norm"].item()) for m in ms]
        del state, step, ms
        torch.cuda.empty_cache()
    (lf, nf), (ld, nd) = traj["flash"][0], traj["dense"][0]
    out.update({"bf16_step_loss_flash": lf, "bf16_step_loss_dense": ld,
                "bf16_step_grad_norm_flash": nf,
                "bf16_step_grad_norm_dense": nd,
                "bf16_losses_flash": [x[0] for x in traj["flash"]],
                "bf16_losses_dense": [x[0] for x in traj["dense"]],
                "bf16_grad_norms_flash": [x[1] for x in traj["flash"]],
                "bf16_grad_norms_dense": [x[1] for x in traj["dense"]]})
    check(bool(np.isfinite([lf, ld, nf, nd]).all())
          and abs(lf - ld) <= STEP_LOSS_ATOL
          and abs(nf / nd - 1) <= STEP_NORM_RTOL,
          f"bf16 flash train step disagrees with dense: {out}")
    emit(out)
    return out


# bench.py's inference leg (``measure_inference``, bench.py:233-270, called
# at :388-391): bench_400m with dense attention and no remat, bf16, 8
# prompts of 1024 tokens, 64 new tokens through a 1089-row cache.
INFERENCE_BATCH, INFERENCE_PROMPT, INFERENCE_NEW = 8, 1024, 64


def captured_decode_block(params, cfg, cache, first, start: int,
                          steps: int) -> torch.Tensor:
    """``decode_block_into`` (the engine's decode program) from ``first`` at
    ``start`` for every slot, greedy, captured in a CUDA graph
    (``ray_tpu_torch.graphs``) and replayed once (the state and the cache
    rows the warm-up wrote are reset first). Returns the tokens [B,
    steps]."""
    from ray_tpu_torch import graphs
    from ray_tpu_torch.models.generation import decode_block_into

    b = first.shape[0]
    tok, pos = first.clone(), torch.full((b,), start, device=first.device)
    zeros_i = torch.zeros(b, dtype=torch.long, device=first.device)
    temps = torch.zeros(b, dtype=torch.float32, device=first.device)
    counts = zeros_i.clone()
    out = torch.zeros((b, steps), dtype=torch.long, device=first.device)

    def block():
        decode_block_into(params, cache, tok, pos, temps, zeros_i, counts,
                          cfg, out)

    graphs.warm_up(block, first.device)
    cap = graphs.capture(block)
    tok.copy_(first)
    pos.fill_(start)
    counts.zero_()
    cap.replay()
    torch.cuda.synchronize()
    del cap
    return out.clone()


def phase_inference(cfg) -> dict:
    """bench.py's inference leg on the port: ``prefill`` timed as TTFT and
    ``decode_loop`` as decode tokens/s (each the second call of its
    signature, the first having captured its programs), as bench.py times
    the reference's two compiled programs. Checks: the timed loop runs no
    eager decode step; it replays its captured blocks, each holding one
    decode attention launch per layer per step, and so does a profiled
    replay by kernel name. Then the first and second calls of a 256- and a
    1023-step loop (what capture costs in time and memory at longer
    generations). The captured ``generate`` gives the same greedy tokens as
    the same bodies run uncaptured on the card; in float32 with TF32 off,
    the engine's decode program (captured, ``RAYTPU_DECODE_DEFERRED_WRITES``
    unset and set) gives ``generate``'s tokens from its prefill, the two
    structures bit for bit alike."""
    import os

    from ray_tpu_torch.models import generation
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import decode_attention as da

    b, s, new = INFERENCE_BATCH, INFERENCE_PROMPT, INFERENCE_NEW
    max_len = s + new + 1
    icfg = dataclasses.replace(cfg, attn_impl="dense", remat=False)
    params, icfg = generation.prepare_for_inference(init_params(icfg, SEED),
                                                    icfg)
    rng = np.random.default_rng(SEED + 6)
    prompt = torch.from_numpy(rng.integers(0, icfg.vocab_size, (b, s))).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    out = {"phase": "inference", "batch": b, "prompt_len": s,
           "new_tokens": new, "max_len": max_len,
           "n_layers": icfg.n_layers}
    generation.release_programs()
    da.launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def run_prefill():
        return generation.prefill(params, prompt, icfg, max_len)

    _, out["prefill_capture_ms"] = timed(run_prefill)
    (logits, cache), out["ttft_ms"] = timed(run_prefill)
    first = torch.argmax(logits, dim=-1)
    start = torch.tensor(s, device="cuda")

    def run_decode():
        return generation.decode_loop(params, first, cache, start, icfg, new,
                                      0.0, gen)

    _, out["decode_capture_ms"] = timed(run_decode)
    with eager_decode_steps("decode_step") as eager:
        toks, decode_ms = timed(run_decode)
    out.update({"decode_ms": decode_ms,
                "decode_tokens_per_s": b * new / decode_ms * 1e3,
                "eager_decode_steps_in_timed_loop": eager[0],
                "decode_ms_cuda_events": cuda_ms(run_decode, 3, 0)})
    programs = generation.programs()
    out["programs"] = [{"kind": list(kind), "replays": replays,
                        "decode_attention_launches": launches}
                       for kind, replays, launches in programs]
    decode = [(kind[1], replays, launches)
              for kind, replays, launches in programs if kind[0] == "decode"]
    plan = generation._block_plan(new)
    check(sorted(k for k, _, _ in decode) == sorted(set(plan))
          and all(r >= 2 * plan.count(k) for k, r, _ in decode),
          f"decode_loop ran from its captured blocks {plan}: {programs}")
    rates = {launches / k for k, _, launches in decode}
    per_step = rates.pop() if len(rates) == 1 else sorted(rates)
    per_step = (int(per_step) if isinstance(per_step, float)
                and per_step.is_integer() else per_step)
    out["decode_attention_launches_per_step"] = per_step
    out["decode_attention_wrapper_launches"] = da.launches
    check(eager[0] == 0 and per_step == icfg.n_layers,
          f"the timed loop ran {eager[0]} eager decode steps; its graph "
          f"holds {per_step} decode attention launches per step, not "
          f"{icfg.n_layers}")
    prof = device_profile(run_decode, kinds=DECODE_KINDS)
    per_step_by_name = prof["launches_by_kind"]["decode_attention"] / new
    out["decode_profile"] = prof
    out["decode_attention_kernel_ms_per_step"] = (
        prof["device_ms_by_kind"]["decode_attention"] / new)
    check(per_step_by_name == icfg.n_layers,
          f"a profiled replay ran {per_step_by_name} decode attention calls "
          f"per step, not {icfg.n_layers}")
    check(toks.shape == (b, new) and bool(((toks >= 0)
                                           & (toks < icfg.vocab_size)).all()),
          "decode_loop tokens of the wrong shape or out of the vocabulary")

    # the first call of a longer loop: the blocks it captures (one at 256
    # steps, all six at 1023) against its second call, and the memory the
    # capture took (the session's pool; its static cache came with prefill)
    out["first_call_by_new_tokens"] = {}
    for n in (256, 1023):
        generation.release_programs()
        torch.cuda.empty_cache()
        logits_n, cache_n = generation.prefill(params, prompt, icfg,
                                               s + n + 1)
        first_n = torch.argmax(logits_n, dim=-1)
        torch.cuda.synchronize()
        alloc, reserved = (torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved())

        def run_n():
            return generation.decode_loop(params, first_n, cache_n, start,
                                          icfg, n, 0.0, gen)

        _, first_ms = timed(run_n)
        grown = (torch.cuda.memory_allocated() - alloc,
                 torch.cuda.memory_reserved() - reserved)
        _, second_ms = timed(run_n)
        out["first_call_by_new_tokens"][n] = {
            "block_plan": generation._block_plan(n),
            "programs_captured": sum(k[0] == "decode"
                                     for k, _, _ in generation.programs()),
            "first_call_ms": first_ms, "second_call_ms": second_ms,
            "capture_ms": first_ms - second_ms,
            "allocated_bytes_grown": grown[0],
            "reserved_bytes_grown": grown[1]}
        del logits_n, cache_n
    generation.release_programs()
    torch.cuda.empty_cache()

    # captured generate against the same bodies run uncaptured on the card
    captured = generation.generate(params, prompt, icfg,
                                   max_new_tokens=new + 1, max_len=max_len)
    with torch.no_grad():
        cache_e = generation.init_kv_cache(icfg, b, max_len)
        logits_e = generation._forward_cached(params, prompt, cache_e, 0,
                                              icfg)[0][:, -1]
        first_e = torch.argmax(logits_e, dim=-1)
        zeros_i = torch.zeros(b, dtype=torch.long, device="cuda")
        rest_e = generation.decode_loop_into(
            params, cache_e, first_e.clone(), torch.tensor(s, device="cuda"),
            torch.zeros(b, device="cuda"), zeros_i, zeros_i.clone(), icfg,
            torch.zeros((b, new), dtype=torch.long, device="cuda"))
    uncaptured = torch.cat([first_e[:, None], rest_e], dim=1)
    check(torch.equal(captured, uncaptured),
          "captured generate differs from the same loop run uncaptured")
    out["captured_equals_uncaptured"] = True
    out["prefill_logits_bit_equal_uncaptured"] = torch.equal(logits,
                                                             logits_e)
    out["tokens_equal_decode_loop"] = torch.equal(captured[:, 1:], toks)
    del cache_e, logits_e
    generation.release_programs()
    torch.cuda.empty_cache()

    # float32, TF32 off: generate's tokens against the engine's decode
    # program from generate's prefill, with and without deferred writes
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(icfg, dtype=torch.float32)
    ref = generation.generate(params, prompt, cfg32, max_new_tokens=new + 1,
                              max_len=max_len)
    with torch.no_grad():
        logits32, cache32 = generation.prefill(params, prompt, cfg32,
                                               max_len)
        first32 = torch.argmax(logits32, dim=-1)
        blocks = {}
        for flag in ("0", "1"):
            os.environ["RAYTPU_DECODE_DEFERRED_WRITES"] = flag
            try:
                blocks[flag] = captured_decode_block(
                    params, cfg32, {k: v.clone() for k, v in cache32.items()},
                    first32, s, new)
            finally:
                os.environ.pop("RAYTPU_DECODE_DEFERRED_WRITES")
    check(torch.equal(blocks["1"], blocks["0"]),
          "deferred writes change the engine's decode tokens")
    check(torch.equal(first32, ref[:, 0])
          and torch.equal(blocks["1"], ref[:, 1:]),
          "fp32: the deferred-writes decode differs from generate")
    out["fp32_deferred_writes_equals_generate"] = True
    del cache32, logits32, params
    generation.release_programs()
    torch.cuda.empty_cache()
    emit(out)
    return out


def _serve_concurrently(engine, prompts, max_new_tokens):
    """One client thread per prompt, all started together. Returns each
    stream's tokens and the arrival times of its tokens (s since start)."""
    results = [None] * len(prompts)
    stamps = [[] for _ in prompts]
    t0 = time.perf_counter()

    def client(i):
        toks = []
        for tok in engine.generate_stream(prompts[i],
                                          max_new_tokens=max_new_tokens):
            stamps[i].append(time.perf_counter() - t0)
            toks.append(tok)
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client never finished")
    return results, stamps


def _decode_state(cfg, rng, slots, pos, max_len):
    """A fresh engine-sized cache and greedy slot state on the card: random
    next tokens, every slot at position ``pos``."""
    from ray_tpu_torch.models.generation import init_kv_cache

    cache = init_kv_cache(cfg, slots, max_len)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, slots)).cuda()
    pos_t = torch.full((slots,), pos, device=tok.device)
    zeros_i = torch.zeros(slots, dtype=torch.long, device=tok.device)
    temps = torch.zeros(slots, dtype=torch.float32, device=tok.device)
    return cache, tok, pos_t, temps, zeros_i, zeros_i.clone()


def decode_profile(params, cfg, rng, slots=8, steps=8, pos=300,
                   max_len=1024) -> dict:
    """One engine-sized decode block (``slots`` slots at position ``pos`` of
    a ``max_len``-row cache, ``steps`` greedy steps) run eagerly, op by op,
    under the profiler: the host's share of a step without graphs. Device
    time is also summed by kind of kernel (``DECODE_KINDS``)."""
    from ray_tpu_torch.models.generation import (
        decode_block,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    state = _decode_state(icfg, rng, slots, pos, max_len)

    def block():
        decode_block(ip, *state, icfg, steps)

    with torch.inference_mode():
        block()  # warm-up
        prof = device_profile(block, kinds=DECODE_KINDS)
    prof["steps"] = steps
    prof["wall_ms_per_step"] = prof["wall_ms"] / steps
    return prof


def graph_decode_profile(params, cfg, rng, slots=8, steps=8, pos=300,
                         max_len=1024) -> dict:
    """The same decode block as the engine runs it: ``decode_block_into``
    captured in one CUDA graph (``ray_tpu_torch.graphs``) and replayed
    (every slot back at ``pos`` before each replay). Device ms per step by
    CUDA events over 5 replays, then one replay under the profiler (busy
    share, device ms by kind), and the int8 and decode attention launches
    the graph holds. Beside it, the block captured again with
    ``RAYTPU_DECODE_DEFERRED_WRITES=1`` (the reference's deferred-writes
    structure), the two timed in turns: default, deferred, default,
    deferred."""
    import os

    from ray_tpu_torch import graphs
    from ray_tpu_torch.models.generation import (
        decode_block_into,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    cache, tok, pos_t, temps, seeds, counts = _decode_state(
        icfg, rng, slots, pos, max_len)
    out = torch.empty((slots, steps), dtype=torch.long, device=tok.device)
    block = functools.partial(decode_block_into, ip, cache, tok, pos_t,
                              temps, seeds, counts, icfg, out)
    caps = {}
    knob = "RAYTPU_DECODE_DEFERRED_WRITES"
    with torch.inference_mode():
        was = os.environ.pop(knob, None)
        try:
            for flag in ("0", "1"):
                os.environ[knob] = flag
                graphs.warm_up(block, tok.device)
                caps[flag] = graphs.capture(block)
        finally:
            os.environ.pop(knob)
            if was is not None:
                os.environ[knob] = was

        def replayer(flag):
            def replay():
                pos_t.fill_(pos)
                caps[flag].graph.replay()
            return replay

        turns = {"0": [], "1": []}
        for flag in ("0", "1", "0", "1"):
            turns[flag].append(cuda_ms(replayer(flag), 5, 1) / steps)
        prof = device_profile(replayer("0"), kinds=DECODE_KINDS)
    launches = caps["0"].launches
    del caps
    torch.cuda.empty_cache()
    prof.update({"steps": steps,
                 "device_ms_per_step_cuda_events": turns["0"][0],
                 "wall_ms_per_step": prof["wall_ms"] / steps,
                 "int8_launches_per_replay": launches["int8_matmul"],
                 "decode_attention_launches_per_replay":
                     launches["decode_attention"],
                 "deferred_writes_turns_ms_per_step": {
                     "per_layer_writes": turns["0"],
                     "deferred_writes": turns["1"]}})
    prof["device_ms_per_step_by_kind"] = {
        k: v / steps for k, v in prof["device_ms_by_kind"].items()}
    prof["decode_attention_launches_per_step_by_name"] = (
        prof["launches_by_kind"]["decode_attention"] / steps)
    check(prof["decode_attention_launches_per_step_by_name"]
          == icfg.n_layers,
          f"a profiled replay of the engine's decode block ran "
          f"{prof['decode_attention_launches_per_step_by_name']} decode "
          f"attention kernels per step, not one per layer ({icfg.n_layers})")
    return prof


@contextlib.contextmanager
def eager_decode_steps(name: str = "decode_step_multi"):
    """Counts the decode steps that Python runs while the block is open
    (``generation.<name>`` called op by op: the engine's
    ``decode_step_multi``, ``generate``'s ``decode_step``); a replayed graph
    calls none."""
    from ray_tpu_torch.models import generation

    real = getattr(generation, name)
    count = [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(generation, name, counted)
    try:
        yield count
    finally:
        setattr(generation, name, real)


def graph_stats(engine, int8_wrapper_launches: int) -> dict:
    """The engine's graph replays, the int8 and decode attention kernel
    launches they made (each graph's captured launches times its replays),
    the int8 launches the wrapper counted (warm-up and capture), and the
    launches of each per decode step."""
    replays = engine.graph_replays
    decode = [key for key in replays if key[0] == "decode"]
    steps = sum(replays[key] * key[1] for key in decode)
    out = {"graph_replays": {f"{a}_{b}": n for (a, b), n in replays.items()},
           "replayed_decode_steps": steps,
           "int8_launches_wrapper": int8_wrapper_launches}
    for name, per_graph in (("int8", engine.graph_int8_launches),
                            ("decode_attention",
                             engine.graph_decode_attention_launches)):
        per_step = None
        if steps:  # each block length's graph holds a whole number per step
            per_step = sum(replays[key] * per_graph[key]
                           for key in decode) / steps
            per_step = int(per_step) if per_step.is_integer() else per_step
        out.update({f"graph_{name}_launches": {
                        f"{a}_{b}": n for (a, b), n in per_graph.items()},
                    f"{name}_launches_replayed": sum(
                        replays[key] * per_graph[key] for key in replays),
                    f"{name}_launches_per_decode_step": per_step})
    return out


def serve_through_graphs(engine, prompts, new, vocab) -> dict:
    """Warms the engine with one short request, then serves ``prompts``
    concurrently: every decode block of the traffic must be a graph replay
    (no decode step run by Python). Then one sampled request (temperature
    1, seed 5) twice: the same tokens both times."""
    engine.generate(prompts[0][:64], max_new_tokens=4)  # warm-up
    with eager_decode_steps() as eager:
        results, stamps = _serve_concurrently(engine, prompts, new)
    stats = engine.stats()
    kw = dict(max_new_tokens=16, temperature=1.0, seed=5)
    sampled = [engine.generate(prompts[1][:100], **kw) for _ in range(2)]
    check(stats["graph_replays"] > 0 and eager[0] == 0,
          f"serving ran {eager[0]} eager decode steps, "
          f"{stats['graph_replays']} graph replays")
    check(sampled[0] == sampled[1]
          and all(0 <= t < vocab for t in sampled[0]),
          f"temperature-1 requests differ: {sampled}")
    return {**serve_metrics(results, stamps, new, vocab),
            "decode_steps": stats["steps"],
            "graph_replays_total": stats["graph_replays"],
            "eager_decode_steps_in_traffic": eager[0],
            "sampled_tokens_equal_twice": True,
            "sampled_differs_from_greedy":
            sampled[0] != engine.generate(prompts[1][:100],
                                          max_new_tokens=16)}


def check_hash_bits_cpu_equals_cuda(vocab: int) -> dict:
    """The sampler's integer bits for the same (seed, count) pairs must be
    equal on the CPU and on the card."""
    from ray_tpu_torch.models.generation import _hash_bits

    seeds = torch.tensor([0, 1, 7, -3, 2 ** 31 + 5, 123456789, 5, 5])
    counts = torch.tensor([0, 1, 2, 3, 4, 1000, 0, 1])
    cpu = _hash_bits(seeds, counts, vocab)
    card = _hash_bits(seeds.cuda(), counts.cuda(), vocab).cpu()
    check(torch.equal(cpu, card), "hash bits differ between CPU and CUDA")
    return {"pairs": len(seeds), "vocab": vocab, "equal": True}


def serve_metrics(results, stamps, new: int, vocab: int) -> dict:
    """Checks that every stream has ``new`` valid ids; TTFT median and max,
    and the decode rate once every request has its first token (the tokens
    that arrived after that moment over the time they took)."""
    for r in results:
        check(r is not None and len(r) == new
              and all(isinstance(t, int) and 0 <= t < vocab for t in r),
              f"bad stream {r}")
    ttft = [s[0] for s in stamps]
    wall = max(s[-1] for s in stamps)
    all_in = max(ttft)
    decoded = sum(t > all_in for s in stamps for t in s)
    return {"requests": len(results), "new_tokens": new, "wall_s": wall,
            "tokens_per_s": sum(map(len, results)) / wall,
            "decode_tokens_per_s": decoded / (wall - all_in),
            "ttft_ms_median": float(np.median(ttft)) * 1e3,
            "ttft_ms_max": all_in * 1e3}


def fp32_engine_equals_generate(params, cfg, rng) -> None:
    """In float32 with TF32 off, the engine's greedy tokens for 3
    interleaved prompts (2 slots, 16 new tokens) must EQUAL ``generate``'s,
    one prompt at a time."""
    from ray_tpu_torch.models.generation import generate, release_programs
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    new = 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 100, 70)]
    ref = [generate(params, p[None], cfg32, max_new_tokens=new,
                    max_len=256)[0].tolist() for p in prompts]
    release_programs()  # generate's sessions leave the card to the engine
    engine = LLMEngine(params, cfg32, max_slots=2, max_len=256,
                       prefill_buckets=(64, 128))
    try:
        got, _ = _serve_concurrently(engine, prompts, new)
    finally:
        engine.shutdown()
    check(got == ref, f"fp32 engine tokens differ from generate: {got} "
          f"vs {ref}")


def phase_serve(params, cfg) -> dict:
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import int8_matmul as im
    from ray_tpu_torch.serve.llm import LLMEngine

    rng = np.random.default_rng(SEED + 1)
    new = 32
    lens = rng.integers(64, 501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    fa.launches = im.launches = 0
    engine = LLMEngine(params, cfg, max_slots=8, max_len=1024,
                       prefill_buckets=(128, 512))
    try:
        traffic = serve_through_graphs(engine, prompts, new, cfg.vocab_size)
        graphs = graph_stats(engine, im.launches)
    finally:
        engine.shutdown()
    out = {"phase": "serve", "prompt_lens": lens.tolist(), **traffic,
           **graphs, "flash_launches": fa.launches}
    check(graphs["int8_launches_per_decode_step"] == 0,
          "bf16 weights launch no int8 kernel")
    check(graphs["decode_attention_launches_per_decode_step"]
          == cfg.n_layers, f"decode attention launches per decode step "
          f"{graphs['decode_attention_launches_per_decode_step']}, not one "
          f"per layer ({cfg.n_layers})")
    del engine
    torch.cuda.empty_cache()
    out["decode_block_graph_profile"] = graph_decode_profile(params, cfg, rng)
    out["decode_block_profile"] = decode_profile(params, cfg, rng)
    out["hash_bits_cpu_equals_cuda"] = check_hash_bits_cpu_equals_cuda(
        cfg.vocab_size)
    torch.cuda.empty_cache()

    # float32, TF32 off: the engine's greedy tokens must EQUAL generate's
    fp32_engine_equals_generate(params, cfg, rng)
    out["fp32_engine_equals_generate"] = True
    emit(out)
    return out


def weight_bytes(params) -> dict:
    """Bytes of the weights at rest: the layers' int8 ``q`` and fp32 scales,
    their other leaves (norms; every weight when none is quantized), and
    the embedding, lm_head and final norm."""
    from ray_tpu_torch.models.quant import QTensor
    from ray_tpu_torch.models.transformer import tree_leaves

    out = {"layers_int8": 0, "layers_scales": 0, "layers_other": 0,
           "embed_head_final_ln": 0}
    for w in tree_leaves(params["layers"]):
        if isinstance(w, QTensor):
            out["layers_int8"] += w.q.numel() * w.q.element_size()
            out["layers_scales"] += w.s.numel() * w.s.element_size()
        else:
            out["layers_other"] += w.numel() * w.element_size()
    out["embed_head_final_ln"] = sum(
        w.numel() * w.element_size() for name, sub in params.items()
        if name != "layers" for w in tree_leaves(sub))
    return out


def dequant_ms_per_step(params, dtype) -> float:
    """Device time (CUDA events) of dequantizing every layer weight once,
    layer by layer, as one decode step or one prefill does."""
    from ray_tpu_torch.models.quant import QTensor
    from ray_tpu_torch.models.transformer import tree_leaves, unbind_layers

    n_layers = params["layers"]["ln1"]["scale"].shape[0]
    qts = [w for lp in unbind_layers(params, n_layers)
           for w in tree_leaves(lp) if isinstance(w, QTensor)]

    def run():
        for w in qts:
            w.to(dtype)

    with torch.inference_mode():
        return cuda_ms(run, 3, 1)


def serve_7b_traffic(params, cfg, prompts, new) -> dict:
    """bench.py's serving engine (8 slots, max_len 512, prefill bucket 128,
    block 8 steps) answering ``prompts`` concurrently through its graphs;
    then one decode block of 8 slots at a position inside that traffic,
    replayed from a graph and run eagerly, each profiled."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import int8_matmul as im
    from ray_tpu_torch.serve.llm import LLMEngine

    fa.launches = im.launches = 0
    t0 = time.perf_counter()
    engine = LLMEngine(params, cfg, max_slots=8, max_len=512,
                       prefill_buckets=(128,), block_steps=8)
    build_s = time.perf_counter() - t0
    try:
        out = serve_through_graphs(engine, prompts, new, cfg.vocab_size)
        out.update(graph_stats(engine, im.launches))
    finally:
        engine.shutdown()
    del engine
    out.update({"engine_build_s": build_s, "flash_launches": fa.launches})
    check(fa.launches == 0, "serve_7b attends densely: no flash launch")
    check(out["decode_attention_launches_per_decode_step"] == cfg.n_layers,
          f"decode attention launches per decode step "
          f"{out['decode_attention_launches_per_decode_step']}, not one per "
          f"layer ({cfg.n_layers})")
    torch.cuda.empty_cache()
    at = len(prompts[0]) + new // 2
    out["decode_block_graph_profile"] = graph_decode_profile(
        params, cfg, np.random.default_rng(SEED + 4), pos=at, max_len=512)
    out["decode_block_profile"] = decode_profile(
        params, cfg, np.random.default_rng(SEED + 4), pos=at, max_len=512)
    torch.cuda.empty_cache()
    return out


def logits_vs(ref, got) -> dict:
    """max|got - ref| / max|ref| and top-1 agreement of two logit tensors."""
    ref, got = ref.float(), got.float()
    return {"max_abs_diff_over_max_abs_ref":
            ((got - ref).abs().max() / ref.abs().max()).item(),
            "top1_agreement":
            (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}


# int8 against bf16 logits (tests/test_quant.py:63): the int8 grid moves
# every weight by up to half a step of its channel's scale; gated at 2
# layers of the full width, reported at full depth.
INT8_LOGITS_RTOL = 0.12


def phase_serve_7b() -> dict:
    """``serve_7b`` (6.7B parameters, full width and depth) served int8 on
    the card through ``LLMEngine`` at bench.py's shape, then the same
    traffic on bf16 weights of the same init, timing only; the fp32 engine
    equals ``generate`` on the int8 weights; int8 against bf16 logits."""
    from ray_tpu_torch.models.generation import prepare_for_inference
    from ray_tpu_torch.models.quant import (
        init_params_by_layer,
        init_params_int8,
        quantize_params_int8,
    )
    from ray_tpu_torch.models.transformer import (
        TransformerConfig,
        forward,
        init_params,
        tree_map,
    )

    t_phase = time.perf_counter()
    cfg = TransformerConfig.serve_7b()
    rng = np.random.default_rng(SEED + 5)
    new = 64
    prompts = [rng.integers(0, cfg.vocab_size, 128) for _ in range(8)]
    probe = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128))).cuda()
    out = {"phase": "serve_7b", "param_count": cfg.param_count(),
           "n_layers": cfg.n_layers, "prompt_len": 128}

    # int8 weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_int8(cfg, SEED)
    torch.cuda.synchronize()
    out["int8_init_s"] = time.perf_counter() - t0
    out["int8_weight_bytes"] = weight_bytes(params)
    out["int8_max_memory_allocated_after_init_bytes"] = (
        torch.cuda.max_memory_allocated())
    out["int8"] = serve_7b_traffic(params, cfg, prompts, new)
    check(out["int8"]["int8_launches_per_decode_step"] == 6 * cfg.n_layers,
          f"int8 weights: {out['int8']['int8_launches_per_decode_step']} "
          f"int8_matmul launches per decode step, not {6 * cfg.n_layers}")
    # what the kernel took off the path: the plain dequant of every weight
    out["int8"]["plain_dequant_ms_per_step"] = dequant_ms_per_step(params,
                                                                   cfg.dtype)
    out["int8"]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    fp32_engine_equals_generate(params, cfg, rng)
    out["fp32_engine_equals_generate"] = True
    out["fp32_check_layers"] = cfg.n_layers
    out["fp32_check_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        ip, icfg = prepare_for_inference(params, cfg)
        int8_logits = forward(ip, probe, icfg).float()
    del params, ip
    torch.cuda.empty_cache()

    # bf16 weights of the same init (each layer the bf16 rounding of the
    # fp32 layer that init_params_int8 quantized): timing only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_by_layer(
        cfg, SEED, lambda layer: tree_map(lambda w: w.to(torch.bfloat16),
                                          layer))
    torch.cuda.synchronize()
    out["bf16_init_s"] = time.perf_counter() - t0
    out["bf16_weight_bytes"] = weight_bytes(params)
    out["bf16"] = serve_7b_traffic(params, cfg, prompts, new)
    check(out["bf16"]["int8_launches_per_decode_step"] == 0,
          "bf16 weights launch no int8 kernel")
    out["bf16"]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        ip, icfg = prepare_for_inference(params, cfg)
        out["full_depth_int8_vs_bf16_logits"] = logits_vs(
            forward(ip, probe, icfg), int8_logits)
    del params, ip, int8_logits
    torch.cuda.empty_cache()

    # the gate: 2 layers at full width, a bf16 init against its int8
    # quantization, on one 128-token prompt
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.bfloat16)
    with torch.inference_mode():
        p2 = init_params(cfg2, SEED)
        ref = forward(p2, probe, cfg2)
        got = forward(quantize_params_int8(p2), probe, cfg2)
        two = logits_vs(ref, got)
    del p2, ref, got
    torch.cuda.empty_cache()
    two["rtol"] = INT8_LOGITS_RTOL
    out["two_layer_int8_vs_bf16_logits"] = two
    check(two["max_abs_diff_over_max_abs_ref"] < INT8_LOGITS_RTOL,
          f"int8 logits stray from bf16 at 2 layers: {two}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on the "
              "card only", file=sys.stderr)
        return 1
    if len(argv) == 4 and argv[0] == "multicard-rank":
        multicard_rank(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv not in ([], ["kernel"], ["decode_kernel"], ["serve_7b"],
                    ["train"], ["inference"], ["mesh"], ["moe"], ["seq"],
                    ["pipe"], ["multicard"]):
        print("usage: chip_smoke.py [kernel | decode_kernel | serve_7b | "
              "train | inference | mesh | moe | seq | pipe | multicard]",
              file=sys.stderr)
        return 2
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if argv == ["decode_kernel"]:
        from ray_tpu_torch.ops import build

        build.build(["decode_attention"], verbose=True)
        phase_decode_kernel()
        print(smi, flush=True)
        return 0
    if argv == ["serve_7b"]:
        phase_serve_7b()
        print(smi, flush=True)
        return 0
    if argv == ["train"]:
        phase_train(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["inference"]:
        phase_inference(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["mesh"]:
        phase_mesh(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["moe"]:
        phase_moe(bench_400m_moe())
        print(smi, flush=True)
        return 0
    if argv == ["seq"]:
        phase_seq(TransformerConfig.bench_400m())
        print(smi, flush=True)
        return 0
    if argv == ["pipe"]:
        phase_pipe(bench_400m_dense())
        print(smi, flush=True)
        return 0
    if argv == ["multicard"]:
        phase_multicard()
        print(smi, flush=True)
        return 0
    kernel = phase_kernel()
    int8 = phase_int8_kernel()
    dec = phase_decode_kernel()
    if argv == ["kernel"]:
        print(smi, flush=True)
        return 0
    cfg = TransformerConfig.bench_400m()
    params = init_params(cfg, SEED)
    phase_forward(params, cfg)
    train = phase_train(cfg)
    mesh = phase_mesh(cfg)
    moe_run = phase_moe(bench_400m_moe())
    phase_seq(cfg)
    phase_pipe(bench_400m_dense())
    phase_grad(cfg)
    inference = phase_inference(cfg)
    phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    s7 = phase_serve_7b()
    print(smi, flush=True)
    per_step = train["launches_per_step"]
    wrappers = train["wrapper_counts_in_run"]
    # per replayed step over the one-card mesh (DEFAULT_RULES; FSDP_RULES
    # checked equal in the mesh phase)
    per_mesh_step = mesh["runs"]["DEFAULT_RULES"]["launches_per_step"]
    per_moe_step = moe_run["launches_per_step"]  # bench_400m x4 experts
    int8_step = int8["decode_step"]
    dec7, dec_inf = (dec["times"]["serve_7b_step"],
                     dec["times"]["inference_step"])
    main_bwd = kernel["bwd_cases"][0]
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:72",
         "launches": per_step["flash_fwd"],
         "launches_per_mesh_step": per_mesh_step["flash_fwd"],
         "launches_per_moe_step": per_moe_step["flash_fwd"],
         "wrapper_count_in_train_run": wrappers["flash_fwd"],
         "max_abs_err": kernel["cases"][0]["max_abs_err"],
         "ms": kernel["kernel_ms"], "plain_ms": kernel["plain_ms"],
         "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
         "library_ms": kernel["library_ms"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:158",
         "fuses": "delta = rowsum(dO*O), ray_tpu/ops/flash_attention.py:247",
         "launches": per_step["flash_bwd_dq"],
         "launches_per_mesh_step": per_mesh_step["flash_bwd_dq"],
         "launches_per_moe_step": per_moe_step["flash_bwd_dq"],
         "wrapper_count_in_train_run": wrappers["flash_bwd_dq"],
         "max_abs_err": main_bwd["dq_max_abs_err"],
         "ms": kernel["bwd_dq_ms"], "plain_ms": kernel["bwd_dq_plain_ms"],
         "bound_ms": kernel["bwd_dq_bound_ms"],
         "bound_by": kernel["bwd_dq_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:197",
         "launches": per_step["flash_bwd_dkv"],
         "launches_per_mesh_step": per_mesh_step["flash_bwd_dkv"],
         "launches_per_moe_step": per_moe_step["flash_bwd_dkv"],
         "wrapper_count_in_train_run": wrappers["flash_bwd_dkv"],
         "max_abs_err": max(main_bwd["dk_max_abs_err"],
                            main_bwd["dv_max_abs_err"]),
         "ms": kernel["bwd_dkv_ms"], "plain_ms": kernel["bwd_plain_ms"],
         "bound_ms": kernel["bwd_dkv_bound_ms"],
         "bound_by": kernel["bwd_dkv_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
        # per serve_7b decode step: 6 products per layer at M 8, 32 layers
        {"name": "int8_matmul", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/int8_matmul.cu",
         "replaces": "ray_tpu/models/quant.py:43 (XLA fusion)",
         "launches": s7["int8"]["int8_launches_per_decode_step"],
         "launches_in_traffic": s7["int8"]["int8_launches_replayed"],
         "max_abs_err": int8["serve_7b_max_abs_err"],
         "ms": int8_step["kernel_ms"], "plain_ms": int8_step["plain_ms"],
         "bound_ms": int8_step["bound_ms"],
         "bound_by": int8_step["bound_by"],
         "library_ms": int8_step["library_ms"],
         # per serve_7b prefill: the same products at M 128
         "prefill_ms": int8["prefill_step"]["kernel_ms"],
         "prefill_bound_ms": int8["prefill_step"]["bound_ms"]},
        # per serve_7b decode step: one call per layer, 8 slots at position
        # 160 of 512 with the self column; beside it, per step of bench.py's
        # inference leg (bench_400m, lengths 1025..1088 of 1089)
        {"name": "decode_attention", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/decode_attention.cu",
         "replaces": "ray_tpu/models/generation.py:151 (XLA fusion; and "
                     ":61 at S = 1)",
         "launches": s7["int8"]["decode_attention_launches_per_decode_step"],
         "launches_in_traffic":
             s7["int8"]["decode_attention_launches_replayed"],
         "launches_per_inference_step":
             inference["decode_attention_launches_per_step"],
         "max_abs_err": dec["max_abs_err"]["bfloat16"],
         "ms": dec7["kernel_ms_per_step"],
         "plain_ms": dec7["plain_ms_per_step"],
         "bound_ms": dec7["bound_ms_per_step"], "bound_by": dec7["bound_by"],
         "library_ms": dec7["library_ms_per_step"],
         "inference_ms": dec_inf["kernel_ms_per_step"],
         "inference_plain_ms": dec_inf["plain_ms_per_step"],
         "inference_bound_ms": dec_inf["bound_ms_per_step"],
         "inference_library_ms": dec_inf["library_ms_per_step"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
