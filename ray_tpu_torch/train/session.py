"""Worker-side training session (PyTorch port of
``ray_tpu/train/session.py``).

Parity: reference ``python/ray/train/_internal/session.py:84`` — the user's
``train_loop_per_worker`` runs on a thread inside the TrainWorker actor; each
``session.report(metrics, checkpoint=...)`` enqueues an event that the driver
drains via the actor's ``poll()`` method. The session also hands the loop
what JAX gives the reference's loop implicitly: the worker's device
(``get_device``), a mesh over the group's ranks (``make_mesh``) and a
``distribute_batch`` helper that turns each rank's local numpy slice into
DTensors of the global batch (the multi-process data-loading idiom).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    experiment_name: str
    mesh_config: Optional[Any] = None  # parallel.MeshConfig
    dataset_shards: Optional[Dict[str, Any]] = None  # name -> DataIterator
    device: str = "cpu"  # the worker's torch device, set by the worker


class _TrainSession:
    """One per training attempt inside a TrainWorker.

    ``sync_reports``: bound the event queue to 1 so ``report`` blocks until
    the driver consumes it — required for schedulers (ASHA/PBT) that must
    be able to stop a trial *between* iterations (reference tune function-
    trainable semantics). Train fit loops leave it unbounded."""

    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint],
                 sync_reports: bool = False):
        self.context = context
        self.start_checkpoint = checkpoint
        self.sync_reports = sync_reports
        self.events: "queue.Queue[Dict]" = queue.Queue()
        # sync mode: report() blocks until the driver explicitly acks (the
        # scheduler decided CONTINUE) — a true rendezvous, so a STOP kills
        # the trial BEFORE it computes another iteration.
        self.report_ack = threading.Event()
        self.iteration = 0
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self.iteration += 1
        # Only rank 0's checkpoint is persisted by the driver; shipping the
        # other ranks' identical payloads through the object plane would be
        # pure waste, so drop them at the source.
        ship_ckpt = checkpoint if self.context.world_rank == 0 else None
        self.events.put(
            {
                "type": "report",
                "iteration": self.iteration,
                "metrics": dict(metrics),
                "checkpoint": ship_ckpt.to_dict() if ship_ckpt else None,
            }
        )
        if self.sync_reports:
            self.report_ack.wait()
            self.report_ack.clear()


_session_lock = threading.Lock()
_session: Optional[_TrainSession] = None


def _set_session(s: Optional[_TrainSession]):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — session.* APIs are only valid "
            "inside train_loop_per_worker"
        )
    return _session


# -- public worker-side API (parity: ray.train.session / ray.air.session) --

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().start_checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_world_rank() -> int:
    return _get_session().context.world_rank


def get_world_size() -> int:
    return _get_session().context.world_size


def get_device():
    """This worker's ``torch.device``: ``cuda:0``, the one card its lease
    makes visible, or the CPU for a ``use_gpu=False`` group. The reference's
    loop gets its devices from JAX (``jax.local_devices()``); a torch rank
    owns one device, and this is it."""
    import torch

    return torch.device(_get_session().context.device)


def get_dataset_shard(name: str = "train"):
    """This worker's streaming shard of ``TorchTrainer(datasets={name: ds})``
    (parity: ray.train session.get_dataset_shard / ``get_dataset_shard:958``).
    Returns a ``ray_tpu_torch.data.DataIterator``; its
    ``iter_device_batches()`` lands batches on this worker's card."""
    shards = _get_session().context.dataset_shards or {}
    if name not in shards:
        raise KeyError(
            f"no dataset {name!r} was passed to TorchTrainer(datasets=...)"
        )
    return shards[name]


def make_mesh(mesh_config=None):
    """The device mesh over every rank of the worker group, on the worker's
    device type, factored per ``mesh_config`` (default: the ScalingConfig's
    MeshConfig, else pure DP). Call inside the loop: the group's process
    group is up by then. A thin alias onto :func:`ray_tpu_torch.mesh.make_mesh`,
    the one mesh construction path."""
    from ray_tpu_torch.mesh import make_mesh as _make_mesh
    from ray_tpu_torch.parallel.mesh import MeshConfig

    cfg = mesh_config or _get_session().context.mesh_config or MeshConfig()
    return _make_mesh(cfg, device_type=get_device().type)


def distribute_batch(batch, mesh, spec=None):
    """Each rank's local numpy slice -> DTensors of the global batch.

    Each worker passes only its own slice of the global batch (ranks that
    share a batch coordinate, as tp peers do, pass the same slice); the
    result is a DTensor per array whose local shard is that slice and whose
    global shape is the slices' concatenation, on the mesh's device. No
    collective runs. ``spec`` is a placement per mesh axis, by default the
    batch over (dp, ep) as ``parallel.train_step.batch_sharding``.
    This is ``jax.make_array_from_process_local_data``; ``data.
    device_batches(sharding=)``, by contrast, takes a global batch that
    every rank draws alike."""
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch.data.iterator import (
        _as_tensor,
        _contiguous_stride,
        _tree_map,
    )
    from ray_tpu_torch.parallel.mesh import (
        DEFAULT_RULES,
        logical_to_placements,
        mesh_device,
    )

    if spec is None:
        spec = logical_to_placements(mesh, DEFAULT_RULES, ("batch",))
    placements = tuple(spec)
    dev = mesh_device(mesh)

    def one(x):
        local = _as_tensor(x).to(dev)
        shape = list(local.shape)
        for i, p in enumerate(placements):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(local, mesh, placements, shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    return _tree_map(one, batch)
