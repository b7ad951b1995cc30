"""Times the bf16 int8 weight-only matmul kernel under other launch plans,
and with parts of its work taken out, on the card.

    python3 -m ray_tpu_torch.ops.sweep_int8 8:132:232448 8:264:116224
    python3 -m ray_tpu_torch.ops.sweep_int8 base stream no_dequant no_products

Run from the repo root (it uses ``chip_smoke.py``'s helpers). An argument
``MAX_SPLIT:SMS:SMEM_LIMIT`` is a launch plan: ``launch_plan`` then splits K
over at most MAX_SPLIT blocks while the blocks of a product fit SMS (132 is
one block per SM of an H100, 264 two) and sizes the ring to SMEM_LIMIT bytes
of shared memory (116224 lets two blocks share an SM). For each plan, at
serve_7b's three weight shapes and M 8 and 128 in bf16: the kernel against
its plain version under ``chip_smoke.compare_int8``'s bound (bit-equal
across two launches and with row 0 alone), and its device time in a CUDA
graph over weights that rotate through more than L2 holds
(``chip_smoke.graph_ms``), three times, with the plan.

Any other argument names a copy of ``csrc/int8_matmul.cu`` built beside the
package (one ``nvcc`` each, all at once, under the git-ignored
``_build/sweep_int8/``) and timed the same way under the default plan, in
turns, twice: ``base`` (the source as it is), ``stream`` (the consumers only
wait for each stage and release it: the ring's copies alone),
``no_dequant`` (the q words go to the wgmmas undequantized) and
``no_products`` (the fragments are built and folded into the accumulators
without a wgmma). The last three compute wrong results by design and are
not checked: they show which part of a stage binds.

Prints ptxas's report of the kernels it built, one JSON line per plan or
copy, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from ray_tpu_torch.ops import build
from ray_tpu_torch.ops import int8_matmul as im

SHAPES = ((4096, 4096), (4096, 16384), (16384, 4096))

# The stage loop of the consumers, and what each copy puts in its place.
_LOADS = """        uint32_t a[KG][2][4];  // [k step][tile]"""
_DEQUANT = """          dequant_fragment<0>(a[i][0], u[i], sc[0], sc[1]);
          dequant_fragment<2>(a[i][1], u[i], sc[2], sc[3]);"""
_PRODUCTS = """        hopper::wgmma_fence();
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const uint64_t desc = hopper::desc_k_major(xs + (k0 + i) * 32);
          hopper::wgmma_rs_k<NW>(acc[0], a[i][0], desc, 1);
          hopper::wgmma_rs_k<NW>(acc[1], a[i][1], desc, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();"""
_STAGE_START = "      // KG k steps at a time"
_STAGE_END = "      hopper::fence_acc(acc[0]);\n      hopper::fence_acc(acc[1]);\n      __syncwarp();"


def _ablated(name: str, src: str) -> str:
    for marker in (_LOADS, _DEQUANT, _PRODUCTS, _STAGE_START, _STAGE_END):
        if src.count(marker) != 1:
            raise RuntimeError(f"int8_matmul.cu changed: {marker[:40]!r} not "
                               "found once; update sweep_int8's copies")
    if name == "base":
        return src
    if name == "stream":
        return src[:src.index(_STAGE_START)] + src[src.index(_STAGE_END):]
    if name == "no_dequant":
        return src.replace(_DEQUANT, """#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[i][0][r] = u[i][r];
            a[i][1][r] = u[i][r] ^ 0x01010101u;
          }""")
    if name == "no_products":
        return src.replace(_PRODUCTS, """#pragma unroll
        for (int i = 0; i < KG; ++i) {
#pragma unroll
          for (int T = 0; T < 2; ++T)
            acc[T][0] += __uint_as_float(
                (a[i][T][0] ^ a[i][T][1] ^ a[i][T][2] ^ a[i][T][3]) & 0x3fffffffu);
        }""")
    raise ValueError(f"unknown copy {name!r}: base, stream, no_dequant, "
                     "no_products or MAX_SPLIT:SMS:SMEM_LIMIT")


def _build(name: str):
    out = build.BUILD_DIR / "sweep_int8" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    src = out / build.SOURCES["int8_matmul"]
    src.write_text(_ablated(name, src.read_text()))
    lib = out / "libint8_matmul.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return lib, r.stdout + r.stderr


def _times(x_ws: dict) -> dict:
    return {f"{m}x{k}x{n}": cs.graph_ms(
        lambda q, s: im.int8_matmul(x, q, s), ws)
        for (m, k, n), (x, ws) in x_ws.items()}


def _plan(spec: str, gen) -> dict:
    max_split, sms, smem = (int(v) for v in spec.split(":"))
    im.MAX_SPLIT, im.SMEM_LIMIT = max_split, smem
    im._sms = lambda device: sms
    out = {"plan": spec, "shapes": []}
    for (k, n), m in itertools.product(SHAPES, cs.INT8_MS):
        plan = im.launch_plan(m, k, n, sms)
        case = cs.compare_int8(im, gen, m, k, n, torch.bfloat16)
        copies = max(2, -(-240_000_000 // (k * n)))
        x, ws = cs.int8_operands(gen, m, k, n, torch.bfloat16, copies)
        ms = [cs.graph_ms(lambda q, s: im.int8_matmul(x, q, s), ws)
              for _ in range(3)]
        bound, _ = cs.int8_bound_ms(m, k, n, torch.bfloat16)
        out["shapes"].append({
            "m": m, "k": k, "n": n, **dataclasses.asdict(plan),
            "max_err_over_tol": case["max_err_over_tol"], "ms": ms,
            "bound_ms": bound, "bound_share": bound / min(ms)})
        del x, ws
        torch.cuda.empty_cache()
    return out


def _copies(names, gen) -> None:
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(_build, names)))
    print(json.dumps({"ptxas": cs.ptxas_report(
        {name: log for name, (_, log) in built.items()})}), flush=True)
    x_ws = {}
    for (k, n), m in itertools.product(SHAPES, cs.INT8_MS):
        copies = max(2, -(-240_000_000 // (k * n)))
        x_ws[(m, k, n)] = cs.int8_operands(gen, m, k, n, torch.bfloat16,
                                           copies)
    for turn in range(2):
        for name in names:
            fn = ctypes.CDLL(str(built[name][0])).int8_matmul
            fn.argtypes = im._ARGTYPES[("int8_matmul", "int8_matmul")]
            fn.restype = ctypes.c_int
            im._fns["int8_matmul"] = fn
            if name == "base":
                for m, k, n in x_ws:
                    cs.compare_int8(im, gen, m, k, n, torch.bfloat16)
            print(json.dumps({"copy": name, "turn": turn,
                              "ms": _times(x_ws)}), flush=True)
    im._fns.pop("int8_matmul")


def main(args) -> int:
    if not torch.cuda.is_available() or not args:
        print("usage (on a CUDA card, from the repo root): python3 -m "
              "ray_tpu_torch.ops.sweep_int8 [MAX_SPLIT:SMS:SMEM_LIMIT | base "
              "| stream | no_dequant | no_products] ...", file=sys.stderr)
        return 1
    specs = [a for a in args if ":" in a]
    names = [a for a in args if ":" not in a]
    for name in names:
        _ablated(name, (build.CSRC / build.SOURCES["int8_matmul"]).read_text())
    saved = im.MAX_SPLIT, im.SMEM_LIMIT, im._sms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.inference_mode():
            if specs:
                build.build(["int8_matmul"], verbose=True)  # ptxas's report
                print(json.dumps({"ptxas": cs.ptxas_report(
                    build.BUILD_LOGS)}), flush=True)
                for spec in specs:
                    print(json.dumps(_plan(spec, gen)), flush=True)
            im.MAX_SPLIT, im.SMEM_LIMIT, im._sms = saved
            if names:
                _copies(names, gen)
    finally:
        im.MAX_SPLIT, im.SMEM_LIMIT, im._sms = saved
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
