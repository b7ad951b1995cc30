"""On-card smoke of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card. Three phases; any
failure raises and the script exits non-zero without a result line:

1. kernel: builds every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (nvcc,
   sm_90a, one process per source, all at once), holds each against its plain
   PyTorch version on the card, and times kernel, plain version and the
   library yardstick at the 400M model's shapes (CUDA events, after warm-up).
2. forward: ``bench_400m`` (full width: 24 layers, d_model 1024, 8 heads x
   128) in bf16 from a seeded random init, ``forward`` and ``loss_fn`` on
   tokens [8, 2048]; the flash kernel must launch exactly once per layer and
   the logits must agree with the dense-attention forward.
3. serve: ``LLMEngine`` over ``bench_400m`` in bf16 answers 8 concurrent
   greedy requests from client threads; then, in float32 with TF32 off, the
   engine's greedy tokens for 3 interleaved prompts must EQUAL ``generate``'s.

Prints one JSON line per phase, the card's name and power limit (as
nvidia-smi reports them), a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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


def device_profile(fn, top: int = 6) -> dict:
    """Runs ``fn()`` once under torch.profiler. Returns the host wall time,
    the time the host took to queue the work (until ``fn`` returned), the
    device's busy time (union of its kernel and copy intervals), the busy
    share of the wall, and the kernels with the most device time."""
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
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        name = name[:80]
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    busy_ms = busy_us / 1e3 if spans else None  # None: profiler saw none
    return {"wall_ms": wall * 1e3, "host_queue_ms": queued * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if spans else None,
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:top]}


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
    return case, (q, k, v)


def phase_kernel() -> dict:
    from ray_tpu_torch.ops import build
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    libs = build.build(verbose=True)  # prints ptxas's register report
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, s, h, d = MAIN_SHAPE
    with torch.inference_mode():
        main, (q, k, v) = compare_kernel(fa, gen, MAIN_SHAPE, h,
                                         torch.bfloat16, True)
        cases = [main] + [
            compare_kernel(fa, gen, shape, hkv, dtype, causal)[0]
            for shape, hkv, dtype, causal in [
                ((2, 512, 8, 128), 8, torch.bfloat16, False),
                ((2, 512, 8, 128), 2, torch.bfloat16, True),  # GQA
                ((2, 1000, 8, 128), 8, torch.bfloat16, True),  # ragged S
                ((2, 1000, 8, 128), 2, torch.bfloat16, False),
                ((1, 384, 4, 256), 4, torch.bfloat16, True),  # gptj_6b's D
                ((2, 300, 8, 128), 2, torch.float32, True),
                ((1, 333, 4, 64), 4, torch.float32, False),
            ]
        ]
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_reference(q, k, v, True), 5)
        # yardstick only: the port never calls SDPA
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True), 20)
    bound_ms, bound_by, flops = attention_bound_ms(b, s, h, d,
                                                   torch.bfloat16, True)
    out = {"phase": "kernel", "build_s": build_s,
           "libraries": {n: str(p.name) for n, p in libs.items()},
           "cases": cases, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / ms,
           "tflops": flops / ms / 1e9}
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


def decode_profile(params, cfg, rng, slots=8, steps=8, pos=300) -> dict:
    """One engine-sized decode block (8 slots at position 300 of a
    1024-row cache, 8 greedy steps) under the profiler: does the host's
    queueing or the device bound a decode step?"""
    from ray_tpu_torch.models.generation import (
        decode_block,
        init_kv_cache,
        prepare_for_inference,
    )

    ip, icfg = prepare_for_inference(params, cfg)
    cache = init_kv_cache(icfg, slots, 1024)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, slots)).cuda()
    pos = torch.full((slots,), pos, device=tok.device)
    host = np.zeros(slots)

    def block():
        decode_block(ip, cache, tok, pos, host, host, host, icfg, steps)

    with torch.inference_mode():
        block()  # warm-up
        prof = device_profile(block)
    prof["steps"] = steps
    prof["wall_ms_per_step"] = prof["wall_ms"] / steps
    return prof


def phase_serve(params, cfg) -> dict:
    from ray_tpu_torch.models.generation import generate
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
    for r in results:
        check(r is not None and len(r) == new
              and all(isinstance(t, int) and 0 <= t < cfg.vocab_size
                      for t in r), f"bad stream {r}")
    ttft = [s[0] for s in stamps]
    wall = max(s[-1] for s in stamps)
    # decode rate once every request has its first token: the tokens that
    # arrived after that moment over the time they took
    all_in = max(ttft)
    decoded = sum(t > all_in for s in stamps for t in s)
    out = {"phase": "serve", "requests": len(prompts),
           "prompt_lens": lens.tolist(), "new_tokens": new,
           "wall_s": wall, "tokens_per_s": sum(map(len, results)) / wall,
           "decode_tokens_per_s": decoded / (wall - all_in),
           "ttft_ms_median": float(np.median(ttft)) * 1e3,
           "ttft_ms_max": all_in * 1e3, "decode_steps": steps,
           "flash_launches": fa.launches}
    del engine
    out["decode_block_profile"] = decode_profile(params, cfg, rng)
    torch.cuda.empty_cache()

    # float32, TF32 off: the engine's greedy tokens must EQUAL generate's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    prompts32 = [rng.integers(0, cfg.vocab_size, n) for n in (40, 100, 70)]
    ref = [generate(params, p[None], cfg32, max_new_tokens=16,
                    max_len=256)[0].tolist() for p in prompts32]
    engine = LLMEngine(params, cfg32, max_slots=2, max_len=256,
                       prefill_buckets=(64, 128))
    try:
        got, _ = _serve_concurrently(engine, prompts32, 16)
    finally:
        engine.shutdown()
    check(got == ref, f"fp32 engine tokens differ from generate: {got} "
          f"vs {ref}")
    out["fp32_engine_equals_generate"] = True
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on the "
              "card only", file=sys.stderr)
        return 1
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kernel = phase_kernel()
    cfg = TransformerConfig.bench_400m()
    params = init_params(cfg, SEED)
    fwd = phase_forward(params, cfg)
    phase_serve(params, cfg)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:72",
        "launches": fwd["flash_launches"],
        "max_abs_err": kernel["cases"][0]["max_abs_err"],
        "ms": kernel["kernel_ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
