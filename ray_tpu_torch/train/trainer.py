"""TorchTrainer: the Train-equivalent entry point (PyTorch port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``).

Parity: reference ``python/ray/train/data_parallel_trainer.py:58`` (
``DataParallelTrainer.fit``/``training_loop:432``) and
``train/_internal/backend_executor.py:45``. The driver gang-starts a
WorkerGroup, joins it into one ``torch.distributed`` process group (the
reference's torch backend, ``train/torch/config.py:69``), ships
``train_loop_per_worker`` to every worker, then drains ``session.report``
events — persisting rank-0 checkpoints through a keep-N CheckpointManager
and restarting the whole group from the latest checkpoint on failure
(FailureConfig), the reference's recovery semantics.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RayTpuError):
    """All restart attempts exhausted (parity: train.base_trainer
    TrainingFailedError)."""


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

        name = self.run_config.name or f"torchtrainer_{int(time.time())}"
        # default: beside the port's sessions, apart from the reference's
        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "raytpu_torch", "results")
        self.experiment_path = os.path.join(base, name)
        self._ckpt_manager = CheckpointManager(
            self.experiment_path, self.run_config.checkpoint_config
        )

    # ------------------------------------------------------------------

    def fit(self) -> Result:
        failure: FailureConfig = self.run_config.failure_config
        max_failures = failure.max_failures
        attempt = 0
        start_ckpt = (
            self.resume_from_checkpoint or self._ckpt_manager.latest_checkpoint
        )
        while True:
            try:
                metrics = self._run_attempt(start_ckpt)
                return Result(
                    metrics=metrics,
                    checkpoint=self._ckpt_manager.latest_checkpoint,
                    path=self.experiment_path,
                )
            except Exception as e:  # worker/actor failure
                attempt += 1
                if max_failures >= 0 and attempt > max_failures:
                    raise TrainingFailedError(
                        f"training failed after {attempt - 1} restart(s): {e}"
                    ) from e
                # restart from the latest persisted checkpoint (fall back to
                # the user's resume checkpoint if none was registered yet)
                start_ckpt = (
                    self._ckpt_manager.latest_checkpoint
                    or self.resume_from_checkpoint
                )

    # ------------------------------------------------------------------

    def _run_attempt(self, start_checkpoint: Optional[Checkpoint]) -> Dict:
        sc = self.scaling_config
        group = WorkerGroup(
            sc.num_workers,
            sc.worker_resources(),
            use_gpu=sc.use_gpu,
            placement_strategy=sc.placement_strategy,
        )
        shard_lists = {}
        try:
            group.bootstrap_distributed()
            # One streaming execution per dataset, split across the workers
            # (blocks flow worker-side through the coordinator actor).
            shard_lists = {
                name: ds.streaming_split(sc.num_workers)
                for name, ds in self.datasets.items()
            }
            contexts = [
                TrainContext(
                    world_rank=i,
                    world_size=sc.num_workers,
                    experiment_name=os.path.basename(self.experiment_path),
                    mesh_config=sc.mesh,
                    dataset_shards={
                        name: shards[i]
                        for name, shards in shard_lists.items()
                    },
                )
                for i in range(sc.num_workers)
            ]
            ckpt_data = start_checkpoint.to_dict() if start_checkpoint else None
            group.start_training(
                self.train_loop_per_worker,
                self.train_loop_config,
                contexts,
                ckpt_data,
            )
            return self._drain(group)
        finally:
            for shards in shard_lists.values():
                if shards:
                    shards[0].stop()  # reap the split coordinator actor
            group.shutdown()

    def _drain(self, group: WorkerGroup) -> Dict:
        last_metrics: Dict = {}
        done = [False] * group.num_workers
        while not all(done):
            polls = group.poll_all(timeout=10.0)
            for rank, p in enumerate(polls):
                for ev in p["events"]:
                    if rank == 0 and ev["type"] == "report":
                        last_metrics = ev["metrics"]
                        if ev.get("checkpoint") is not None:
                            self._ckpt_manager.register(
                                Checkpoint.from_dict(ev["checkpoint"]),
                                ev["metrics"],
                            )
                if p["done"]:
                    if p["error"] is not None:
                        err = p["error"]
                        tb = p.get("error_tb")
                        raise TrainingFailedError(
                            f"worker {rank} failed: {err!r}\n{tb or ''}"
                        ) from err
                    done[rank] = True
        return last_metrics


# The reference exposes DataParallelTrainer; every TorchTrainer is
# data-parallel-capable via the mesh, so this is an alias.
DataParallelTrainer = TorchTrainer
