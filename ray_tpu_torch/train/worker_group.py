"""Gang-started group of training worker actors (PyTorch port of
``ray_tpu/train/worker_group.py``).

Parity: reference ``python/ray/train/_internal/worker_group.py:100`` +
``backend_executor.py:45`` and its torch backend
(``train/torch/config.py:69``): the group's bootstrap is
``torch.distributed.init_process_group`` in every worker (NCCL on the
card, gloo on the CPU) at a TCP store that rank 0 holds, after which the
ranks form one process group and a train step is SPMD over a mesh of them.
A GPU worker's lease names its card: the raylet starts it with only that
card visible, so its device is ``cuda:0``.
"""

from __future__ import annotations

import datetime
import errno
import inspect
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _set_session, _TrainSession

_PORT_ATTEMPTS = 8  # coordinator ports tried before giving up


class _TrainWorker:
    """Actor body: owns this worker's device and runs the user train loop
    on a thread while serving ``poll`` from the driver."""

    def __init__(self):
        self._session: Optional[_TrainSession] = None
        self._thread: Optional[threading.Thread] = None
        self._device = "cpu"
        self._store = None  # rank 0's TCP store, held while the group lives
        # a failed init_runtime whose caller did not wait for it (a tune
        # trial): the train loop raises it instead of running on the CPU
        self._init_error: Optional[BaseException] = None

    # -- bootstrap --

    def init_runtime(self, use_gpu: bool) -> str:
        """Record this worker's device: ``cuda:0`` under the lease's
        CUDA_VISIBLE_DEVICES when ``use_gpu``, else the CPU."""
        import torch

        if use_gpu:
            if not torch.cuda.is_available():
                self._init_error = RuntimeError(
                    "use_gpu=True but this worker sees no CUDA device "
                    "(its lease's CUDA_VISIBLE_DEVICES names no usable card)"
                )
                raise self._init_error
            self._device = "cuda:0"
            torch.cuda.set_device(0)
        else:
            self._device = "cpu"
        return self._device

    def coordinator_info(self) -> str:
        """Bind the group's TCP store on this node and return its address.
        The port is picked free and bound at once; a port taken in between
        (EADDRINUSE) is picked again."""
        import torch.distributed as dist

        from ray_tpu_torch._private.node import node_ip_address, pick_free_port

        host, attempt = node_ip_address(), 0
        while True:
            attempt += 1
            port = pick_free_port()
            try:
                self._store = dist.TCPStore(
                    host, port, is_master=True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=60))
                return f"{host}:{port}"
            except (RuntimeError, OSError) as e:
                in_use = (getattr(e, "errno", None) == errno.EADDRINUSE
                          or "address already in use" in str(e).lower())
                if not in_use or attempt == _PORT_ATTEMPTS:
                    raise

    def setup_distributed(self, coordinator: str, world_size: int,
                          rank: int, timeout_s: float) -> Dict[str, Any]:
        """Join the group: NCCL on the card, gloo on the CPU, through the
        TCP store at ``coordinator``; every collective is bounded by
        ``timeout_s``, so a lost rank cannot hang the others forever."""
        import torch
        import torch.distributed as dist

        cuda = self._device.startswith("cuda")
        if cuda:
            torch.cuda.set_device(0)
        kwargs = {"backend": "nccl" if cuda else "gloo", "rank": rank,
                  "world_size": world_size,
                  "timeout": datetime.timedelta(seconds=timeout_s)}
        if rank == 0:
            if self._store is None:
                raise RuntimeError("coordinator_info was not called on rank 0")
            store = self._store
        else:
            host, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), is_master=False,
                                  timeout=kwargs["timeout"])
        dist.init_process_group(store=store, **kwargs)
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "backend": dist.get_backend(), "device": self._device}

    # -- training --

    def start_training(self, train_fn, train_loop_config,
                       context: TrainContext,
                       checkpoint_data: Optional[Dict],
                       sync_reports: bool = False) -> int:
        ckpt = Checkpoint.from_dict(checkpoint_data) if checkpoint_data else None
        context.device = self._device
        sess = _TrainSession(context, ckpt, sync_reports=sync_reports)
        self._session = sess
        _set_session(sess)
        device = self._device

        init_error = self._init_error

        def run():
            try:
                if init_error is not None:
                    raise init_error
                if device.startswith("cuda"):
                    import torch

                    torch.cuda.set_device(0)  # the current device is per thread
                sig = inspect.signature(train_fn)
                if len(sig.parameters) >= 1:
                    train_fn(train_loop_config)
                else:
                    train_fn()
            except BaseException as e:  # noqa: BLE001 — reported to driver
                e._raytpu_tb = traceback.format_exc()
                sess.error = e
            finally:
                sess.finished.set()

        self._thread = threading.Thread(
            target=run, name="train_loop", daemon=True
        )
        self._thread.start()
        return 1

    def poll(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Block until >=1 event, completion, or timeout; drain everything."""
        sess = self._session
        if sess is None:
            raise RuntimeError("start_training not called")
        events: List[Dict] = []
        deadline = time.monotonic() + timeout
        # Sync-report sessions (tune trials) hand over ONE event per poll;
        # the producer stays blocked until the driver acks (ack_report), so
        # the scheduler can stop the trial before its next iteration.
        # Unbounded sessions (train fit loops) drain everything.
        sync = sess.sync_reports

        def drain():
            while not (sync and events):
                try:
                    events.append(sess.events.get_nowait())
                except queue.Empty:
                    return

        drain()
        # Wait for an event OR completion, whichever first — never sit out
        # the full timeout after the loop has finished.
        while not events and not sess.finished.is_set():
            try:
                events.append(
                    sess.events.get(
                        timeout=min(0.1, max(0.0, deadline - time.monotonic()))
                    )
                )
            except queue.Empty:
                if time.monotonic() >= deadline:
                    break
        drain()
        done = sess.finished.is_set() and sess.events.empty()
        err = sess.error if done else None
        return {
            "events": events,
            "done": done,
            "error": err,
            "error_tb": getattr(err, "_raytpu_tb", None) if err else None,
        }

    def ack_report(self) -> int:
        """Sync-report rendezvous: release the train thread blocked in
        session.report (the scheduler decided the trial continues)."""
        if self._session is not None:
            self._session.report_ack.set()
        return 1

    def shutdown_session(self) -> int:
        if self._thread is not None:
            self._thread.join(timeout=5)
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self._store = None
        _set_session(None)
        self._session = None
        return 1


class WorkerGroup:
    """Driver-side handle on N gang-started _TrainWorker actors."""

    def __init__(self, num_workers: int, resources: Dict[str, float],
                 use_gpu: bool = True,
                 placement_strategy: Optional[str] = None):
        self.num_workers = num_workers
        self.pg = None
        self.workers = []
        try:
            self._create(num_workers, resources, use_gpu, placement_strategy)
        except BaseException:
            # Failed init must not leak the placement group / actors.
            self.shutdown(graceful=False)
            raise

    def _create(self, num_workers, resources, use_gpu, placement_strategy):
        opts = {"resources": dict(resources), "max_restarts": 0}
        if resources.get("GPU"):
            opts["num_gpus"] = resources["GPU"]
        actor_cls = ray_tpu_torch.remote(**opts)(_TrainWorker)
        if placement_strategy is not None:
            # Gang-reserve one bundle per worker (2PC in the GCS), then pin
            # worker i into bundle i — atomic multi-node placement, the
            # reference Train + PG pattern.
            from ray_tpu_torch.util.placement_group import placement_group
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy,
            )

            self.pg = placement_group(
                [dict(resources) for _ in range(num_workers)],
                strategy=placement_strategy,
            )
            if not self.pg.wait(timeout_seconds=120):
                raise TimeoutError(
                    "placement group for the worker group was not placed"
                )
            self.workers = [
                actor_cls.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        self.pg, placement_group_bundle_index=i
                    )
                ).remote()
                for i in range(num_workers)
            ]
        else:
            self.workers = [actor_cls.remote() for _ in range(num_workers)]
        ray_tpu_torch.get(
            [w.init_runtime.remote(use_gpu) for w in self.workers],
            timeout=120,
        )

    def bootstrap_distributed(self) -> List[Dict[str, Any]]:
        """Join every worker into one process group (a barrier); a fresh
        coordinator each time, so a restarted group meets anew."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        timeout = GLOBAL_CONFIG.mesh_bootstrap_timeout_s
        coordinator = ray_tpu_torch.get(
            self.workers[0].coordinator_info.remote(), timeout=60
        )
        return ray_tpu_torch.get(
            [
                w.setup_distributed.remote(coordinator, self.num_workers, i,
                                           timeout)
                for i, w in enumerate(self.workers)
            ],
            timeout=timeout,
        )

    def start_training(self, train_fn, train_loop_config, contexts,
                       checkpoint_data) -> None:
        ray_tpu_torch.get(
            [
                w.start_training.remote(
                    train_fn, train_loop_config, ctx, checkpoint_data
                )
                for w, ctx in zip(self.workers, contexts)
            ],
            timeout=120,
        )

    def poll_all(self, timeout: float = 10.0) -> List[Dict[str, Any]]:
        return ray_tpu_torch.get(
            [w.poll.remote(timeout=timeout) for w in self.workers],
            timeout=timeout + 60,
        )

    def shutdown(self, graceful: bool = True) -> None:
        if graceful:
            try:
                ray_tpu_torch.get(
                    [w.shutdown_session.remote() for w in self.workers],
                    timeout=10,
                )
            except Exception:
                pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )

            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
