"""On-card smoke of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase (what a check runs)
    timeout 300 python3 chip_smoke.py kernel   # the kernel phase only
    timeout 600 python3 chip_smoke.py serve_7b # the serve_7b phase only

Run from the repo root on a machine with one CUDA card. Six phases; any
failure raises and the script exits non-zero without a result line. With
the argument ``kernel`` (or ``serve_7b``) it runs that phase alone and
prints no result line: the first call after a kernel (or the serving path)
changes, under ``timeout``.

1. kernel: builds every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (nvcc,
   sm_90a, one process per source, all at once) and prints ptxas's
   registers, shared memory and spills for each; holds the forward kernel
   and the two backward kernels (dQ with the delta it fuses, dK/dV on that
   delta) against their plain PyTorch versions on the card, at the 400M
   model's shapes and at others (ragged S, GQA, fp32, and the head dims the
   kernels pad: 16, 32, 64, 96, 192, 256), and times kernels, plain
   versions and the library yardsticks (SDPA forward and backward) at the
   400M model's shapes (CUDA events, after warm-up).
2. forward: ``bench_400m`` (full width: 24 layers, d_model 1024, 8 heads x
   128) in bf16 from a seeded random init, ``forward`` and ``loss_fn`` on
   tokens [8, 2048]; the flash kernel must launch exactly once per layer and
   the logits must agree with the dense-attention forward.
3. train: ``bench_400m`` (remat "dots", flash) through
   ``make_sharded_state`` / ``make_train_step`` / ``default_optimizer`` on
   one seeded batch [8, 2048] repeated: 2 warm-up and 5 timed steps, each
   launching the forward kernel 48 times (forward and remat recompute) and
   each backward kernel 24 times; loss and grad norm finite, the loss
   falling; step ms, tokens/s, MFU, peak memory and a profiled step.
4. grad: the flash grads of ``loss_fn`` against the dense-attention grads,
   at the 400M width with 2 layers in fp32 (TF32 off), and the full-depth
   bf16 train steps' losses and grad norms, flash against dense (step 1
   held to a tolerance, the rest reported).
5. serve: ``LLMEngine`` over ``bench_400m`` in bf16 answers 8 concurrent
   greedy requests from client threads; then, in float32 with TF32 off, the
   engine's greedy tokens for 3 interleaved prompts must EQUAL ``generate``'s.
6. serve_7b: ``serve_7b`` (6.7B parameters, 32 layers, d_model 4096, 32
   heads x 128, full width and depth) from ``init_params_int8`` on the card
   (weight bytes and peak memory printed), served through ``LLMEngine`` at
   bench.py's shape (8 slots, max_len 512, prefill bucket 128, blocks of 8
   steps): 8 concurrent greedy requests of 128-token prompts and 64 new
   tokens (TTFT median and max, decode tokens/s with 8 slots active) and a
   profiled decode block (device busy share, top kernels, device time by
   kind, the dequant's device time per step); the same on bf16 weights of
   the same init, timing only. Checks: 8 valid 64-token streams each time;
   in float32 with TF32 off, the engine's greedy tokens EQUAL
   ``generate``'s on the int8 weights at full depth; int8 against bf16
   logits on one 128-token prompt within ``INT8_LOGITS_RTOL`` at 2 layers
   (full depth reported). No flash kernel runs here (dense attention, as in
   JAX): the phase reports ``flash_launches`` 0.

Prints one JSON line per phase, the card's name and power limit (as
nvidia-smi reports them), a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import threading
import time

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
# name: dtype conversions (the dequant's int8 -> bf16 and the cached
# attention's bf16 -> fp32 among them), products by a broadcast scale and
# other elementwise multiplies, matrix products (cuBLAS's nvjet and gemv
# kernels).
DECODE_KINDS = {"copy_convert": "direct_copy_kernel", "mul": "MulFunctor",
                "gemm": "gemm|gemv|nvjet|xmma|cutlass"}


def device_profile(fn, top: int = 10, kinds: dict = None) -> dict:
    """Runs ``fn()`` once under torch.profiler. Returns the host wall time,
    the time the host took to queue the work (until ``fn`` returned), the
    device's busy time (union of its kernel and copy intervals), the busy
    share of the wall, the kernels with the most device time and, with
    ``kinds`` (name -> regex), the device time of each kind of kernel."""
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
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        if kinds:
            kind = next((k for k, rx in kinds.items() if re.search(rx, name)),
                        "other")
            by_kind[kind] += (stop - start) / 1e3
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


def phase_train(cfg, b: int = MAIN_SHAPE[0], s: int = MAIN_SHAPE[1],
                warmup: int = 2, timed: int = 5) -> dict:
    """``bench_400m`` trained on the card through the port's entry points:
    one seeded batch, repeated; every step must launch the forward kernel
    twice per layer (forward and remat recompute) and each backward kernel
    once per layer."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (
        default_optimizer,
        make_sharded_state,
        make_train_step,
    )

    check(cfg.attn_impl == "flash" and cfg.remat
          and cfg.remat_policy == "dots", "bench_400m trains with flash "
          "attention under remat 'dots'")
    opt = default_optimizer()
    state, _ = make_sharded_state(cfg, opt, SEED)
    step = make_train_step(cfg, opt)
    batch = train_batch(cfg.vocab_size, b, s, SEED + 2)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, events, launches = [], [], []
    for _ in range(warmup + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
        start.record()
        state, m = step(state, batch)
        end.record()
        counts = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        check(counts == want, f"train step launched flash fwd/dq/dkv "
              f"{counts} times, not {want}")
        launches.append(counts)
        metrics.append(m)
        events.append((start, end))
    torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    step_ms = [a.elapsed_time(e) for a, e in events[warmup:]]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses}, {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    mean_ms = float(np.mean(step_ms))
    flops = train_flops(cfg, b, s)
    prof = device_profile(lambda: step(state, batch))
    # The same step under remat "full", which runs no selective-checkpoint
    # dispatch mode on the host (and recomputes more on the device): is the
    # host's queueing time the policy's?
    full = make_train_step(dataclasses.replace(cfg, remat_policy="full"), opt)
    full(state, batch)  # warm-up
    prof_full = device_profile(lambda: full(state, batch))
    del state, step, full, metrics
    torch.cuda.empty_cache()
    out = {"phase": "train", "batch": [b, s], "n_layers": cfg.n_layers,
           "remat_policy": cfg.remat_policy, "losses": losses,
           "grad_norms": norms, "step_ms": step_ms, "step_ms_mean": mean_ms,
           "tokens_per_s": b * s / mean_ms * 1e3, "flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_BF16_FLOPS,
           "launches_per_step": dict(zip(("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv"), launches[-1])),
           "max_memory_allocated_bytes": peak_mem, "profile": prof,
           "profile_remat_full": prof_full}
    emit(out)
    return out


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


def decode_profile(params, cfg, rng, slots=8, steps=8, pos=300,
                   max_len=1024) -> dict:
    """One engine-sized decode block (``slots`` slots at position ``pos`` of
    a ``max_len``-row cache, ``steps`` greedy steps) under the profiler:
    does the host's queueing or the device bound a decode step? Device time
    is also summed by kind of kernel (``DECODE_KINDS``)."""
    from ray_tpu_torch.models.generation import (
        decode_block,
        init_kv_cache,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    cache = init_kv_cache(icfg, slots, max_len)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, slots)).cuda()
    pos = torch.full((slots,), pos, device=tok.device)
    host = np.zeros(slots)

    def block():
        decode_block(ip, cache, tok, pos, host, host, host, icfg, steps)

    with torch.inference_mode():
        block()  # warm-up
        prof = device_profile(block, kinds=DECODE_KINDS)
    prof["steps"] = steps
    prof["wall_ms_per_step"] = prof["wall_ms"] / steps
    return prof


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
    from ray_tpu_torch.models.generation import generate
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    new = 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 100, 70)]
    ref = [generate(params, p[None], cfg32, max_new_tokens=new,
                    max_len=256)[0].tolist() for p in prompts]
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
    from ray_tpu_torch.serve.llm import LLMEngine

    rng = np.random.default_rng(SEED + 1)
    new = 32
    lens = rng.integers(64, 501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    fa.launches = 0
    engine = LLMEngine(params, cfg, max_slots=8, max_len=1024,
                       prefill_buckets=(128, 512))
    try:
        engine.generate(prompts[0][:64], max_new_tokens=4)  # warm-up
        results, stamps = _serve_concurrently(engine, prompts, new)
        steps = engine.stats()["steps"]
    finally:
        engine.shutdown()
    out = {"phase": "serve", "prompt_lens": lens.tolist(),
           **serve_metrics(results, stamps, new, cfg.vocab_size),
           "decode_steps": steps, "flash_launches": fa.launches}
    del engine
    out["decode_block_profile"] = decode_profile(params, cfg, rng)
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
    block 8 steps) answering ``prompts`` concurrently; then one profiled
    decode block of 8 slots at a position inside that traffic."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMEngine

    fa.launches = 0
    engine = LLMEngine(params, cfg, max_slots=8, max_len=512,
                       prefill_buckets=(128,), block_steps=8)
    try:
        engine.generate(prompts[0][:64], max_new_tokens=4)  # warm-up
        results, stamps = _serve_concurrently(engine, prompts, new)
        steps = engine.stats()["steps"]
    finally:
        engine.shutdown()
    del engine
    out = {**serve_metrics(results, stamps, new, cfg.vocab_size),
           "decode_steps": steps, "flash_launches": fa.launches}
    check(fa.launches == 0, "serve_7b attends densely: no flash launch")
    torch.cuda.empty_cache()
    out["decode_block_profile"] = decode_profile(
        params, cfg, np.random.default_rng(SEED + 4), pos=len(prompts[0])
        + new // 2, max_len=512)
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
    out["int8"]["dequant_ms_per_step"] = dequant_ms_per_step(params,
                                                             cfg.dtype)
    busy = out["int8"]["decode_block_profile"]["device_busy_ms"]
    out["int8"]["dequant_share_of_decode_device_busy"] = (
        out["int8"]["dequant_ms_per_step"] * 8 / busy if busy else None)
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
    if argv not in ([], ["kernel"], ["serve_7b"]):
        print("usage: chip_smoke.py [kernel | serve_7b]", file=sys.stderr)
        return 2
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if argv == ["serve_7b"]:
        phase_serve_7b()
        print(smi, flush=True)
        return 0
    kernel = phase_kernel()
    if argv == ["kernel"]:
        print(smi, flush=True)
        return 0
    cfg = TransformerConfig.bench_400m()
    params = init_params(cfg, SEED)
    phase_forward(params, cfg)
    train = phase_train(cfg)
    phase_grad(cfg)
    phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_serve_7b()
    print(smi, flush=True)
    per_step = train["launches_per_step"]
    main_bwd = kernel["bwd_cases"][0]
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:72",
         "launches": per_step["flash_fwd"],
         "max_abs_err": kernel["cases"][0]["max_abs_err"],
         "ms": kernel["kernel_ms"], "plain_ms": kernel["plain_ms"],
         "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
         "library_ms": kernel["library_ms"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:158",
         "fuses": "delta = rowsum(dO*O), ray_tpu/ops/flash_attention.py:247",
         "launches": per_step["flash_bwd_dq"],
         "max_abs_err": main_bwd["dq_max_abs_err"],
         "ms": kernel["bwd_dq_ms"], "plain_ms": kernel["bwd_dq_plain_ms"],
         "bound_ms": kernel["bwd_dq_bound_ms"],
         "bound_by": kernel["bwd_dq_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:197",
         "launches": per_step["flash_bwd_dkv"],
         "max_abs_err": max(main_bwd["dk_max_abs_err"],
                            main_bwd["dv_max_abs_err"]),
         "ms": kernel["bwd_dkv_ms"], "plain_ms": kernel["bwd_plain_ms"],
         "bound_ms": kernel["bwd_dkv_bound_ms"],
         "bound_by": kernel["bwd_dkv_bound_by"],
         "library_ms": kernel["bwd_library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
