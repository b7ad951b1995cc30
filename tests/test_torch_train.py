"""The port's Train library (ray_tpu_torch/train/), the flows of
tests/test_train.py on the port's runtime with ``use_gpu=False``: gloo
worker groups on the CPU.

- MNIST-shaped DP on 4 workers (DDP over the group), keep-N 2 on disk;
- single-worker report and resume; restart from a checkpoint; failures
  exhausted; the CheckpointManager's scoring;
- a worker group gang-placed by STRICT_SPREAD on a two-node Cluster;
- a hard-killed rank: the group restarts from the checkpoint with a fresh
  rendezvous (the reference marks its own slow; this one takes well under
  a minute here, so it is not);
- the flagship through the trainer, the parity test: JAX initializes the
  ``tiny`` weights (flash attention), 2 gloo workers load them through
  ``params_from_numpy``, each takes its local half of a numpy-seeded
  global batch through ``session.distribute_batch``, and they take 3 steps
  at dp 2. Their losses match the JAX package's ``make_train_step`` on the
  same global batch over a dp 2 mesh: rtol 1e-5 in float32 (the same math
  with the batch's sums split over ranks), 5e-3 in bfloat16 (the
  reference's, tests/test_model.py:138), as
  tests/test_torch_sharded_train.py states them.

This box has no pytest-timeout: every ``get`` in the library and here has
its own limit, and a rank that dies is reaped by the driver (the group's
collectives are bounded by ``mesh_bootstrap_timeout_s``).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainingFailedError,
)

CPU = {"use_gpu": False}


@pytest.fixture
def rt_train():
    ray_tpu_torch.init(num_cpus=6, object_store_memory=256 * 1024 * 1024,
                       system_config={"mesh_bootstrap_timeout_s": 60.0})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_exports_and_defaults():
    import ray_tpu_torch.train as train

    for name in ("TorchTrainer", "DataParallelTrainer", "ScalingConfig",
                 "RunConfig", "CheckpointConfig", "FailureConfig",
                 "Checkpoint", "CheckpointManager", "Result",
                 "TrainingFailedError", "session", "save_sharded",
                 "upload_sharded_checkpoint", "download_sharded_checkpoint"):
        assert hasattr(train, name), name
    assert DataParallelTrainer is TorchTrainer
    assert ScalingConfig().worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(**CPU).worker_resources() == {"CPU": 1.0}


def _make_mnist_dp_loop():
    """Nested def => cloudpickled by value (test modules are not importable
    from worker processes)."""

    def _mnist_dp_loop(config):
        """Synthetic MNIST-shaped classifier, DP over the group (DDP)."""
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel

        from ray_tpu_torch.models.convert import params_to_numpy
        from ray_tpu_torch.train import Checkpoint, session

        torch.set_num_threads(1)
        assert dist.get_world_size() == config["expect_ranks"]
        assert session.get_device() == torch.device("cpu")
        rank = session.get_world_rank()
        # teacher-labeled synthetic 8x8 digits; each worker holds its shard
        rng = np.random.RandomState(100 + rank)
        teacher = np.random.RandomState(0).randn(64, 10).astype(np.float32)
        x_local = rng.randn(32, 64).astype(np.float32)
        y_local = (x_local @ teacher).argmax(-1).astype(np.int64)
        torch.manual_seed(0)  # every rank starts from the same weights
        model = DistributedDataParallel(torch.nn.Sequential(
            torch.nn.Linear(64, 32), torch.nn.ReLU(),
            torch.nn.Linear(32, 10, bias=False)))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        x, y = torch.from_numpy(x_local), torch.from_numpy(y_local)

        start = session.get_checkpoint()
        first_step = 0 if start is None else start.to_dict()["step"] + 1
        losses = []
        for i in range(first_step, first_step + config["steps"]):
            loss = torch.nn.functional.cross_entropy(model(x), y)
            opt.zero_grad()
            loss.backward()  # DDP averages the grads over the ranks
            opt.step()
            global_loss = loss.detach().clone()
            dist.all_reduce(global_loss)
            losses.append(global_loss.item() / dist.get_world_size())
            params = {k: v for k, v in model.module.state_dict().items()}
            ckpt = Checkpoint.from_dict(
                {"step": i, "params": params_to_numpy(params)})
            session.report({"loss": losses[-1], "step": i}, checkpoint=ckpt)
        assert losses[-1] < losses[0]

    return _mnist_dp_loop


def test_mnist_dp_4_workers(rt_train, tmp_path):
    """BASELINE 'MNIST DP 4 workers': 4 gloo ranks, one CPU device each."""
    trainer = TorchTrainer(
        _make_mnist_dp_loop(),
        train_loop_config={"steps": 8, "expect_ranks": 4},
        scaling_config=ScalingConfig(num_workers=4, **CPU),
        run_config=RunConfig(
            name="mnist_dp", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=2),
        ),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 7
    assert result.checkpoint is not None
    saved = result.checkpoint.to_dict()
    assert saved["step"] == 7
    assert saved["params"]["0.weight"].shape == (32, 64)
    # keep-N enforced on disk
    assert trainer._ckpt_manager.num_checkpoints == 2
    assert len(list(tmp_path.glob("mnist_dp/checkpoint_*"))) == 2


def test_single_worker_report_and_resume(rt_train, tmp_path):
    def loop(config):
        from ray_tpu_torch.train import Checkpoint, session

        start = session.get_checkpoint()
        base = 0 if start is None else start.to_dict()["i"] + 1
        for i in range(base, base + 3):
            session.report(
                {"i": i}, checkpoint=Checkpoint.from_dict({"i": i})
            )

    run = RunConfig(name="resume", storage_path=str(tmp_path))
    r1 = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1, **CPU),
                      run_config=run).fit()
    assert r1.metrics["i"] == 2
    # A second fit in the same experiment dir resumes from the checkpoint.
    r2 = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1, **CPU),
                      run_config=run).fit()
    assert r2.metrics["i"] == 5


def test_failure_restart_from_checkpoint(rt_train, tmp_path):
    def flaky_loop(config):
        from ray_tpu_torch.train import Checkpoint, session

        start = session.get_checkpoint()
        if start is None:
            # first attempt: checkpoint progress, then die
            session.report(
                {"i": 0}, checkpoint=Checkpoint.from_dict({"i": 0})
            )
            raise RuntimeError("simulated worker failure")
        i = start.to_dict()["i"]
        session.report({"i": i + 1, "resumed": True},
                       checkpoint=Checkpoint.from_dict({"i": i + 1}))

    result = TorchTrainer(
        flaky_loop,
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(
            name="flaky", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    ).fit()
    assert result.metrics["resumed"] is True
    assert result.metrics["i"] == 1


def test_failure_exhausted_raises(rt_train, tmp_path):
    def bad_loop(config):
        raise ValueError("always broken")

    with pytest.raises(TrainingFailedError, match="always broken") as ei:
        TorchTrainer(
            bad_loop,
            scaling_config=ScalingConfig(num_workers=1, **CPU),
            run_config=RunConfig(name="bad", storage_path=str(tmp_path)),
        ).fit()
    assert "bad_loop" in str(ei.value)  # the worker's traceback


def test_checkpoint_manager_keep_n_scoring(tmp_path):
    mgr = CheckpointManager(
        str(tmp_path),
        CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="acc"),
    )
    for i, acc in enumerate([0.1, 0.9, 0.5, 0.2]):
        mgr.register(Checkpoint.from_dict({"i": i}), {"acc": acc})
    assert mgr.num_checkpoints == 2
    assert mgr.best_checkpoint.to_dict()["i"] == 1  # acc=0.9 survived
    assert mgr.latest_checkpoint.to_dict()["i"] == 3  # latest always kept


def test_worker_group_gang_placed_via_pg():
    """Trainer worker group reserved atomically via a placement group:
    STRICT_SPREAD puts one train worker on each simulated node."""
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 3}})
    c.add_node(num_cpus=3)
    c.connect()
    try:
        def loop(config):
            import ray_tpu_torch
            from ray_tpu_torch.train import session

            session.report({
                "node": ray_tpu_torch.get_runtime_context().get_node_id(),
                "rank": session.get_world_rank(),
            })

        nodes = {}

        class Collect(TorchTrainer):
            def _drain(self, group):
                # the standard drain, capturing every rank's report
                import ray_tpu_torch.train.trainer as tr
                last = {}
                done = [False] * group.num_workers
                while not all(done):
                    polls = group.poll_all(timeout=10.0)
                    for rank, p in enumerate(polls):
                        for ev in p["events"]:
                            nodes[rank] = ev["metrics"]["node"]
                            last = ev["metrics"]
                        if p["done"]:
                            if p["error"] is not None:
                                raise tr.TrainingFailedError(str(p["error"]))
                            done[rank] = True
                return last

        Collect(
            loop,
            scaling_config=ScalingConfig(
                num_workers=2, placement_strategy="STRICT_SPREAD", **CPU
            ),
        ).fit()
        assert len(nodes) == 2
        assert nodes[0] != nodes[1], f"workers not spread: {nodes}"
    finally:
        c.shutdown()


def test_two_process_all_reduce_and_hard_kill_recovery(rt_train, tmp_path):
    """Two gloo ranks, a cross-process reduction, then rank 1 dies HARD
    (os._exit, no exception path) while rank 0 waits in a collective for
    it; FailureConfig restarts the group from the checkpoint with a fresh
    rendezvous (a new coordinator store)."""

    def loop(config):
        import os
        import time as _t

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train import Checkpoint, session

        assert dist.get_world_size() == 2
        rank = session.get_world_rank()
        # each process contributes rank+1; both must see the global sum
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        total = float(t.item())
        assert total == 3.0, total
        start = session.get_checkpoint()
        resumed = start is not None
        if not resumed:
            session.report(
                {"phase": 0},
                checkpoint=Checkpoint.from_dict({"ok": 1}),
            )
            if rank == 1:
                # give the driver a beat to drain rank 0's checkpoint
                # report before the group is torn down
                _t.sleep(3)
                os._exit(1)  # hard death: no Python exception machinery
            dist.barrier()  # waits on the dead rank until it is reaped
        session.report({"sum": total, "resumed": resumed})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        run_config=RunConfig(
            name="twoproc_kill", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    ).fit()
    assert result.metrics["sum"] == 3.0
    assert result.metrics["resumed"] is True


# ------------------------------------------------------------ flagship ----

FLAGSHIP_STEPS = 3
FLAGSHIP_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}
_FLAGSHIP_KW = {"float32": {}, "bfloat16": {"remat": True,
                                            "remat_policy": "dots"}}


def _flagship_batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _make_flagship_loop():
    """Nested def => cloudpickled by value."""

    def _flagship_loop(config):
        """Each rank: the JAX weights through params_from_numpy, its half of the
        global batch through distribute_batch, 3 steps at dp 2 per dtype."""
        import torch

        from ray_tpu_torch.models import transformer as ttf
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel import mesh as tmesh
        from ray_tpu_torch.parallel import train_step as tts
        from ray_tpu_torch.train import session

        torch.set_num_threads(1)
        mesh = session.make_mesh(tmesh.MeshConfig(dp=2))
        rank, world = session.get_world_rank(), session.get_world_size()
        rows = len(config["batch"]["tokens"]) // world
        local = {k: v[rank * rows:(rank + 1) * rows]
                 for k, v in config["batch"].items()}
        out = {}
        for dtype, kw in config["dtypes"].items():
            cfg = ttf.TransformerConfig.tiny(dtype=getattr(torch, dtype),
                                             max_seq_len=32, attn_impl="flash",
                                             **kw)
            opt = tts.default_optimizer()
            params = params_from_numpy(config["init"], device=session.get_device())
            state, sh = tts.make_sharded_state(cfg, opt, 0, params=params,
                                               mesh=mesh)
            step = tts.make_train_step(cfg, opt, mesh=mesh, state_shardings=sh)
            _, placements = tts.batch_sharding(mesh)
            losses = []
            for _ in range(config["steps"]):
                batch = session.distribute_batch(local, mesh, spec=placements)
                assert tuple(batch["tokens"].shape) == config["batch"][
                    "tokens"].shape
                state, m = step(state, batch)
                losses.append(m["loss"].item())
            out[dtype] = losses
        session.report({"losses": out, "rank": rank})

    return _flagship_loop


def test_flagship_transformer_via_trainer(rt_train, tmp_path):
    jcfgs = {d: jtf.TransformerConfig.tiny(
        dtype=getattr(jnp, d), max_seq_len=32, attn_impl="flash", **kw)
        for d, kw in _FLAGSHIP_KW.items()}
    batch = _flagship_batch(jcfgs["float32"].vocab_size)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(dp=2), devices=jax.devices()[:2])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfgs["float32"], mesh, opt,
                                       jax.random.key(0))
    init = jax.tree.map(np.array, state.params)  # copies: state is donated
    result = {}

    def fit():  # the trainer runs while JAX compiles its steps here
        try:
            result["r"] = TorchTrainer(
                _make_flagship_loop(),
                train_loop_config={"init": init, "batch": batch,
                                   "steps": FLAGSHIP_STEPS,
                                   "dtypes": _FLAGSHIP_KW},
                scaling_config=ScalingConfig(num_workers=2, **CPU),
                run_config=RunConfig(name="flagship",
                                     storage_path=str(tmp_path)),
            ).fit()
        except BaseException as e:  # re-raised below
            result["e"] = e

    thread = threading.Thread(target=fit, daemon=True)
    thread.start()
    want = {}
    for dtype, jcfg in jcfgs.items():
        st, s_sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0))
        step = jts.make_train_step(jcfg, mesh, opt, s_sh)
        jb = {k: jax.device_put(jnp.asarray(v), jts.batch_sharding(mesh))
              for k, v in batch.items()}
        want[dtype] = []
        for _ in range(FLAGSHIP_STEPS):
            st, m = step(st, jb)
            want[dtype].append(float(m["loss"]))
    thread.join(timeout=600)
    assert not thread.is_alive(), "the trainer did not finish in 600 s"
    if "e" in result:
        raise result["e"]
    got = result["r"].metrics
    assert got["rank"] == 0
    for dtype, rtol in FLAGSHIP_RTOL.items():
        np.testing.assert_allclose(got["losses"][dtype], want[dtype],
                                   rtol=rtol, err_msg=dtype)
    assert got["losses"]["float32"][-1] < got["losses"]["float32"][0]


def test_coordinator_picks_another_port_when_one_is_taken(monkeypatch):
    """A port taken between ``pick_free_port`` and the store's bind
    (EADDRINUSE) is picked again; the store then serves a client."""
    import datetime
    import socket

    import torch.distributed as dist

    from ray_tpu_torch._private import node
    from ray_tpu_torch.train.worker_group import _TrainWorker

    taken = socket.socket()
    taken.bind(("", 0))
    taken.listen()
    ports = [taken.getsockname()[1], node.pick_free_port()]
    monkeypatch.setattr(node, "pick_free_port", lambda: ports.pop(0))
    worker = _TrainWorker()
    try:
        coordinator = worker.coordinator_info()
        host, port = coordinator.rsplit(":", 1)
        assert ports == [] and int(port) != taken.getsockname()[1]
        client = dist.TCPStore(host, int(port), is_master=False,
                               timeout=datetime.timedelta(seconds=10))
        client.set("k", "v")
        assert worker._store.get("k") == b"v"
    finally:
        taken.close()
        worker._store = None
