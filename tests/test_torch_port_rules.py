"""The port's package rules: ray_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package, entry points run on CUDA unless the
caller asks for another device, and chip_smoke.py fails without a card."""

import ast
import functools
import json
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
from ray_tpu_torch import rllib
from ray_tpu_torch._private import ray_perf
from ray_tpu_torch.data import iterator
from ray_tpu_torch.models import convert, generation, quant, transformer
from ray_tpu_torch.parallel import projection, train_step
from ray_tpu_torch.rllib import models as rl_models
from ray_tpu_torch.rllib import rollout_worker, sac
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
            "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch._private.gcs",
            "ray_tpu_torch._private.raylet",
            "ray_tpu_torch._private.core_worker",
            "ray_tpu_torch._private.worker",
            "ray_tpu_torch._private.worker_main",
            "ray_tpu_torch.util.placement_group",
            "ray_tpu_torch.cluster_utils",
            "ray_tpu_torch.mesh.plan",
            "ray_tpu_torch.mesh.group",
            "ray_tpu_torch.mesh.heal",
            "ray_tpu_torch.util.collective",
            "ray_tpu_torch.autoscaler",
            "ray_tpu_torch.cloud_provider",
            "ray_tpu_torch.cloud_rest",
            "ray_tpu_torch.data.dataset",
            "ray_tpu_torch.data.streaming",
            "ray_tpu_torch.data.shuffle",
            "ray_tpu_torch.data.io",
            "ray_tpu_torch.data.prefetch",
            "ray_tpu_torch.tune.tuner",
            "ray_tpu_torch._private.test_utils",
            "ray_tpu_torch.rllib",
            "ray_tpu_torch.rllib.appo",
            "ray_tpu_torch.rllib.common",
            "ray_tpu_torch.rllib.dqn",
            "ray_tpu_torch.rllib.envs",
            "ray_tpu_torch.rllib.impala",
            "ray_tpu_torch.rllib.learner_group",
            "ray_tpu_torch.rllib.models",
            "ray_tpu_torch.rllib.multi_agent",
            "ray_tpu_torch.rllib.offline",
            "ray_tpu_torch.rllib.ppo",
            "ray_tpu_torch.rllib.rollout_worker",
            "ray_tpu_torch.rllib.sac",
            "ray_tpu_torch._private.gcs_standby",
            "ray_tpu_torch.dashboard",
            "ray_tpu_torch.job_submission",
            "ray_tpu_torch.scripts",
            "ray_tpu_torch.workflow",
            "ray_tpu_torch.util.actor_pool",
            "ray_tpu_torch.util.queue",
            "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.joblib",
            "ray_tpu_torch.util.metrics",
            "ray_tpu_torch.util.state",
            "ray_tpu_torch._private.ray_perf",
            "ray_tpu_torch.parallel.projection"} <= set(mods)
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
            "ray_tpu_torch/ops/ulysses_attention.py",
            "ray_tpu_torch/_private/core_worker.py",
            "ray_tpu_torch/_private/worker_main.py",
            "ray_tpu_torch/_private/raylet.py",
            "ray_tpu_torch/_private/gcs.py",
            "ray_tpu_torch/mesh/plan.py",
            "ray_tpu_torch/mesh/group.py",
            "ray_tpu_torch/util/collective.py",
            "ray_tpu_torch/data/streaming.py",
            "ray_tpu_torch/tune/tuner.py",
            "ray_tpu_torch/rllib/learner_group.py",
            "ray_tpu_torch/rllib/ppo.py",
            "ray_tpu_torch/rllib/impala.py",
            "ray_tpu_torch/rllib/appo.py",
            "ray_tpu_torch/rllib/dqn.py",
            "ray_tpu_torch/rllib/sac.py",
            "ray_tpu_torch/rllib/multi_agent.py",
            "ray_tpu_torch/rllib/offline.py",
            "ray_tpu_torch/rllib/rollout_worker.py",
            "ray_tpu_torch/rllib/models.py",
            "ray_tpu_torch/_private/gcs_standby.py",
            "ray_tpu_torch/dashboard.py",
            "ray_tpu_torch/job_submission.py",
            "ray_tpu_torch/scripts.py",
            "ray_tpu_torch/workflow.py",
            "ray_tpu_torch/util/actor_pool.py",
            "ray_tpu_torch/util/queue.py",
            "ray_tpu_torch/util/multiprocessing.py",
            "ray_tpu_torch/util/joblib.py",
            "ray_tpu_torch/util/metrics.py",
            "ray_tpu_torch/util/state.py",
            "ray_tpu_torch/_private/ray_perf.py",
            "ray_tpu_torch/parallel/projection.py"} <= names


def test_importing_the_package_loads_no_torch():
    """The runtime half is what a CPU worker imports: a fresh interpreter's
    `import ray_tpu_torch` (and the worker entry module, and a gang's
    controller side: `mesh`, `cloud_rest`) loads neither torch nor jax nor
    ray_tpu."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch._private.worker_main\n"
        "import ray_tpu_torch.mesh, ray_tpu_torch.cloud_rest\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_data_and_tune_loads_no_torch():
    """Data and Tune run on CPU workers and drivers: a fresh interpreter's
    `import ray_tpu_torch.data, ray_tpu_torch.tune` (and Train's session,
    which a trial reports through) loads neither torch nor jax nor
    ray_tpu. The device pump imports torch only when it is called."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.data, ray_tpu_torch.tune\n"
        "import ray_tpu_torch.data.preprocessors, ray_tpu_torch.train\n"
        "from ray_tpu_torch.data import device_batches, DataIterator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_platform_planes_loads_no_torch():
    """A job's supervisor, the CLI, the dashboard and a workflow's driver
    run on CPU processes: a fresh interpreter's import of the state and
    metrics APIs, job submission, the CLI, the dashboard, workflows, the
    util pools and queue and the standby's module loads neither torch nor
    jax nor ray_tpu."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.util.metrics\n"
        "import ray_tpu_torch.job_submission, ray_tpu_torch.scripts\n"
        "import ray_tpu_torch.dashboard, ray_tpu_torch.workflow\n"
        "import ray_tpu_torch.util.multiprocessing\n"
        "from ray_tpu_torch.util import ActorPool, Queue\n"
        "import ray_tpu_torch._private.gcs_standby\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_ray_perf_loads_no_torch():
    """The microbenchmarks' module, like the reference's, imports only
    numpy besides the runtime: a fresh interpreter's import of it loads
    neither torch nor jax nor ray_tpu (a gang leg's subprocess imports
    torch where it runs a torch step)."""
    code = (
        "import sys\n"
        "import ray_tpu_torch._private.ray_perf\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_standbys_main_loads_no_torch():
    """``python -m ray_tpu_torch._private.gcs_standby``, started by a
    cluster with ``gcs_standby`` and synced to its primary, maps no torch
    library (nor does the primary). The cluster runs in a fresh
    interpreter, so this process keeps no thread of it."""
    code = (
        "import json, sys, time\n"
        "from ray_tpu_torch._private import rpc\n"
        "from ray_tpu_torch.cluster_utils import Cluster\n"
        "def maps_torch(pid):\n"
        "    with open(f'/proc/{pid}/maps') as f:\n"
        "        return sorted({l.split()[-1] for l in f\n"
        "                       if '/torch/' in l or 'libtorch' in l})\n"
        "c = Cluster(initialize_head=True,\n"
        "            head_node_args={'resources': {'CPU': 1}},\n"
        "            system_config={'gcs_storage_backend': 'file',\n"
        "                           'gcs_standby': True})\n"
        "try:\n"
        "    cli = rpc.Client.connect(c._impl.gcs_primary_addr)\n"
        "    deadline = time.monotonic() + 60\n"
        "    while cli.call('internal_state', None, timeout=10)"
        "['standbys'] < 1:\n"
        "        assert time.monotonic() < deadline, 'never synced'\n"
        "        time.sleep(0.2)\n"
        "    cli.close()\n"
        "    sb, primary = c._impl.standby_proc, c._impl.gcs_proc\n"
        "    print(json.dumps({'args': sb.args, 'alive': sb.poll() is None,\n"
        "                      'standby': maps_torch(sb.pid),\n"
        "                      'primary': maps_torch(primary.pid)}))\n"
        "finally:\n"
        "    c.shutdown()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "ray_tpu_torch._private.gcs_standby" in got["args"]
    assert got["alive"] and got["standby"] == [] and got["primary"] == []


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
    # RLlib: each algorithm's learner, LearnerGroup, the networks' init and
    # an env runner built without a device
    "PPOConfig.build": lambda: rllib.PPOConfig().build(),
    "IMPALAConfig.build": lambda: rllib.IMPALAConfig().build(),
    "APPOConfig.build": lambda: rllib.APPOConfig().build(),
    "DQNConfig.build": lambda: rllib.DQNConfig().build(),
    "SACConfig.build": lambda: rllib.SACConfig().build(),
    "MultiAgentPPOConfig.build": lambda: rllib.MultiAgentPPOConfig().build(),
    "BCConfig.build": lambda: rllib.BCConfig().build(None),
    "LearnerGroup": lambda: rllib.LearnerGroup(
        lambda params, batch: 0.0, {"w": np.zeros(2, np.float32)},
        functools.partial(torch.optim.Adam, lr=1e-3)),
    "init_actor_critic": lambda: rl_models.init_actor_critic(0, 4, 2),
    "init_q_network": lambda: rl_models.init_q_network(0, 4, 2),
    "init_sac_networks": lambda: sac.init_sac_networks(0, 4, 2),
    "RolloutWorker": lambda: rollout_worker.RolloutWorker(
        "MinAtar-Breakout", 8, 0.99, 0.95),
    # the projection's probe and the microbenchmarks' gang legs
    "run_probe": lambda: projection.run_probe(),
    "run_mesh_group_bench": lambda: ray_perf.run_mesh_group_bench(),
    "run_mesh_heal_bench": lambda: ray_perf.run_mesh_heal_bench(),
    "run_data_plane_bench": lambda: ray_perf.run_data_plane_bench(),
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


@pytest.mark.parametrize("phase", ["micro", "projection"])
def test_chip_smoke_accepts_the_phase_and_fails_without_a_card(phase):
    """``chip_smoke.py micro`` and ``projection`` are phases it knows (an
    unknown one is a usage error, exit 2, card or not); without a card
    each exits 1, printing no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", phase], cwd=REPO,
                          env=_no_cuda_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr, (
        proc.stdout + proc.stderr)
    assert '"ok": true' not in proc.stdout
    bad = subprocess.run([sys.executable, "chip_smoke.py", phase + "_x"],
                         cwd=REPO, env=_no_cuda_env(), capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode == 2 and "usage" in bad.stderr


def test_chip_smoke_fails_alone_without_the_program(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _no_cuda_env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
