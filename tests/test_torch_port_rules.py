"""The port's package rules: ray_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package, entry points run on CUDA unless the
caller asks for another device, and chip_smoke.py fails without a card."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.data import iterator
from ray_tpu_torch.models import convert, generation, quant, transformer
from ray_tpu_torch.parallel import train_step
from ray_tpu_torch.serve import llm

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                                  "ray_tpu_torch.")]


def _banned(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "ray_tpu" or name.startswith("ray_tpu."))


def _no_cuda_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(REPO)
    return env


def test_every_port_module_imports_without_jax_or_ray_tpu():
    """A fresh interpreter (this one has jax loaded by conftest) imports
    every port module and chip_smoke.py; no jax* and no ray_tpu(.*) module
    may be loaded."""
    mods = _port_modules() + ["chip_smoke"]
    assert {"ray_tpu_torch.serve.llm",
            "ray_tpu_torch.parallel.train_step",
            "ray_tpu_torch.ops.int8_matmul",
            "ray_tpu_torch.ops.decode_attention",
            "ray_tpu_torch.data.iterator",
            "ray_tpu_torch.train.sharded_checkpoint",
            "ray_tpu_torch.ops.moe",
            "ray_tpu_torch.ops.ring_attention",
            "ray_tpu_torch.ops.ulysses_attention",
            "ray_tpu_torch.parallel.pipeline"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_scan_covers_every_kernel_module():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"ray_tpu_torch/ops/int8_matmul.py",
            "ray_tpu_torch/ops/flash_attention.py",
            "ray_tpu_torch/ops/decode_attention.py",
            "ray_tpu_torch/data/iterator.py",
            "ray_tpu_torch/train/sharded_checkpoint.py",
            "ray_tpu_torch/ops/moe.py",
            "ray_tpu_torch/ops/ring_attention.py",
            "ray_tpu_torch/ops/ulysses_attention.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_ray_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(map(_banned, names)), (path, node.lineno, names)


def _tiny():
    return transformer.TransformerConfig.tiny()


ENTRY_POINTS = {
    "init_params": lambda: transformer.init_params(_tiny(), 0),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {"w": np.zeros(2, np.float32)}),
    "init_kv_cache": lambda: generation.init_kv_cache(_tiny(), 1, 8),
    "init_params_int8": lambda: quant.init_params_int8(_tiny(), 0),
    "generate": lambda: generation.generate(
        transformer.init_params(_tiny(), 0, device="cpu"),
        np.ones((1, 4), np.int64), _tiny(), max_new_tokens=2),
    "LLMEngine": lambda: llm.LLMEngine(
        transformer.init_params(_tiny(), 0, device="cpu"), _tiny()),
    "make_sharded_state": lambda: train_step.make_sharded_state(
        _tiny(), train_step.default_optimizer(), 0),
    "device_batches": lambda: iterator.device_batches(lambda: iter([]), 1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone_without_the_program(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _no_cuda_env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
