"""Times the bf16 dQ kernel under other configurations, on the card.

    python3 -m ray_tpu_torch.ops.sweep_dq 128,64,3,2 128,64,4,2 128,64,4,1

Each argument is a ``DqSmem<DP, BN, NS, NWG>`` configuration (head dim
padded, kv rows per ring stage, ring stages, consumer warpgroups) put in
place of the D <= 128 row of ``with_dq_config`` in a copy of
``csrc/flash_bwd.cu``. The copies are built with ``build.py``'s flags (one
``nvcc`` each, all at once, under the git-ignored ``_build/sweep/``), and
each is launched through ``flash_bwd_dq_kernel`` at bench_400m's attention
shape [8, 2048, 8, 128] bf16 causal: its dQ and delta held against
``flash_bwd_dq_reference`` and ``flash_attention_delta``, its time by CUDA
events (20 launches after warm-up, three times), and ptxas's registers and
spills. Prints one JSON line per configuration and the card's name.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ray_tpu_torch.ops import build
from ray_tpu_torch.ops import flash_attention as fa

SHAPE = (8, 2048, 8, 128)
_ROW = re.compile(r"if \(D <= 128\) return f\(DqSmem<[0-9, ]+>\{\}\);")


def _build(i: int, config: str):
    out = build.BUILD_DIR / "sweep" / f"{i}_{config.replace(',', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    src = out / build.SOURCES["flash_bwd"]
    text, n = _ROW.subn(f"if (D <= 128) return f(DqSmem<{config}>{{}});",
                        src.read_text())
    if n != 1:
        raise RuntimeError("with_dq_config's D <= 128 row not found")
    src.write_text(text)
    lib = out / "libflash_bwd.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {config}:\n{r.stdout}{r.stderr}")
    return lib, r.stdout + r.stderr


def _ptxas(log: str) -> dict:
    """{head dim padded: [registers, spill stores]} of the bf16 dQ kernels
    in nvcc's log (ptxas reports a kernel's spills before its registers)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_bwd_dq_bf16_kernel"
                      r"ILi(\d+)E", line)
        if "Compiling entry function" in line:
            cur = out.setdefault(int(m.group(1)), [None, None]) if m else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if cur is not None and m:
            cur[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur[0] = int(m.group(1))
    return out


def _ms(fn, iters: int = 20) -> float:
    for _ in range(2):
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


def main(configs) -> int:
    if not torch.cuda.is_available() or not configs:
        print("usage (on a CUDA card): python3 -m ray_tpu_torch.ops.sweep_dq "
              "DP,BN,NS,NWG ...", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(configs)) as ex:
        built = list(ex.map(_build, range(len(configs)), configs))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        want, want_delta = fa.flash_bwd_dq_reference(q, k, v, o, lse, do)
        for config, (lib, log) in zip(configs, built):
            fn = ctypes.CDLL(str(lib)).flash_bwd_dq
            fn.argtypes = fa._ARGTYPES[("flash_bwd", "flash_bwd_dq")]
            fn.restype = ctypes.c_int
            fa._fns["flash_bwd_dq"] = fn
            dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, do, lse)
            torch.cuda.synchronize()
            err = (dq.float() - want.float()).abs()
            print(json.dumps({
                "config": config,
                "dq_max_abs_err": err.max().item(),
                "dq_within_2e-2": bool(
                    (err <= 2e-2 + 2e-2 * want.float().abs()).all()),
                "delta_max_abs_err": (delta - want_delta).abs().max().item(),
                "ms": [_ms(lambda: fa.flash_bwd_dq_kernel(
                    q, k, v, o, do, lse)) for _ in range(3)],
                "registers_spills_by_head_dim": _ptxas(log)}), flush=True)
    fa._fns.pop("flash_bwd_dq")
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
