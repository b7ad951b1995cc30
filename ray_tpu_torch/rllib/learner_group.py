"""LearnerGroup: data-parallel learners (PyTorch port of
``ray_tpu/rllib/learner_group.py``).

Parity: reference ``rllib/core/learner/learner_group.py:61`` — multi-GPU
DDP across learner ACTORS with torch. The JAX package runs one pjit'd
update dp-sharded over N devices of the driver; here the learners are
processes, one card each:

- ``num_learners == 1``: the update runs in the caller's process on its
  ``device`` (CUDA by default).
- ``num_learners > 1``: one learner actor per card (``num_gpus=1``; with
  ``device="cpu"``, CPU actors), joined by ``torch.distributed`` (NCCL on
  the cards, gloo on the CPU) through a TCP store that rank 0 holds, as
  ``train/worker_group.py`` joins its workers. Each rank takes
  ``lead / num_learners`` trajectories of a batch; the gradients are
  averaged by one all-reduce before every optimizer step, so the update
  equals one learner's on the whole batch up to reduction order.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rllib.models import (grads_of, host_tree, to_device,
                                        trainable, tree_leaves)
from ray_tpu_torch.train.worker_group import _TrainWorker

# bounds every call to the learner actors, and every collective among them
LEARNER_TIMEOUT_S = 300.0


class _Learner:
    """The parameters and optimizer of one learner on ``device``. When a
    process group of more than one rank is up, ``update`` averages the
    gradients (and the reported loss) over it."""

    def __init__(self, loss_fn: Callable, params, optimizer: Callable,
                 device: torch.device):
        self.device = device
        self.loss_fn = loss_fn
        self.params = trainable(params, device)
        self.leaves = tree_leaves(self.params)
        self.opt = optimizer(self.leaves)

    def update(self, batch: Dict[str, np.ndarray], epochs: int) -> float:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        dev_batch = to_device(batch, self.device)
        for _ in range(max(1, epochs)):
            loss = self.loss_fn(self.params, dev_batch)
            grads = grads_of(loss, self.leaves)
            if world > 1:
                flat = torch.cat([g.reshape(-1) for g in grads])
                dist.all_reduce(flat)
                grads = (flat / world).split([g.numel() for g in grads])
            for p, g in zip(self.leaves, grads):
                p.grad = g.view_as(p)
            self.opt.step()
        loss = loss.detach()
        if world > 1:
            dist.all_reduce(loss)
            loss = loss / world
        return float(loss)


class _LearnerActor(_TrainWorker):
    """Actor body of one rank: Train's worker bootstrap (its card,
    ``coordinator_info``, ``setup_distributed``) around a ``_Learner``."""

    def build(self, loss_fn: Callable, params, optimizer: Callable) -> Dict:
        self._learner = _Learner(loss_fn, params, optimizer,
                                 torch.device(self._device))
        info = {"device": self._device, "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
        if self._device.startswith("cuda"):
            info["uuid"] = str(torch.cuda.get_device_properties(0).uuid)
        return info

    def update(self, batch: Dict[str, np.ndarray], epochs: int) -> float:
        return self._learner.update(batch, epochs)

    def params_host(self):
        return params_to_numpy(self._learner.params)


class LearnerGroup:
    """``num_learners`` data-parallel learners of one update rule.

    ``loss_fn(params, batch) -> scalar`` must be a mean over the batch's
    leading axis (so sharding the batch and averaging the gradients equals
    the one-learner gradient, up to float reduction order). ``optimizer``
    makes the optimizer from a list of parameters, e.g.
    ``functools.partial(torch.optim.Adam, lr=6e-4)``; ``params`` is a tree
    of numpy arrays or tensors, copied."""

    def __init__(self, loss_fn: Callable, params, optimizer: Callable,
                 num_learners: int = 1, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_learners = num_learners
        self.learner_info = []
        self._actors = []
        if num_learners == 1:
            self._local = _Learner(loss_fn, params, optimizer, self.device)
            return
        self._local = None
        cuda = self.device.type == "cuda"
        cls = rt.remote(num_cpus=1, num_gpus=1 if cuda else 0)(_LearnerActor)
        self._actors = [cls.remote() for _ in range(num_learners)]
        try:
            self._call("init_runtime", [(cuda,)] * num_learners)
            coordinator = rt.get(self._actors[0].coordinator_info.remote(),
                                 timeout=LEARNER_TIMEOUT_S)
            self._call("setup_distributed",
                       [(coordinator, num_learners, r, LEARNER_TIMEOUT_S)
                        for r in range(num_learners)])
            params_ref = rt.put(host_tree(params))
            self.learner_info = self._call(
                "build", [(loss_fn, params_ref, optimizer)] * num_learners)
        except BaseException:
            self.shutdown()
            raise

    def _call(self, method: str, args) -> list:
        return rt.get([getattr(a, method).remote(*x)
                       for a, x in zip(self._actors, args)],
                      timeout=LEARNER_TIMEOUT_S)

    def update(self, batch: Dict[str, np.ndarray], epochs: int = 1) -> float:
        """``epochs`` SGD steps on a batch whose leading axis is divisible
        by num_learners. The batch crosses host->device ONCE per learner
        and the loss syncs once. Returns the (global) loss of the final
        epoch."""
        lead = next(iter(batch.values())).shape[0]
        if lead % self.num_learners:
            raise ValueError(
                f"batch leading axis {lead} not divisible by "
                f"num_learners={self.num_learners}"
            )
        if self._local is not None:
            return self._local.update(batch, epochs)
        per = lead // self.num_learners
        shards = [({k: v[r * per:(r + 1) * per] for k, v in batch.items()},
                   epochs) for r in range(self.num_learners)]
        return self._call("update", shards)[0]

    @property
    def params(self):
        """The parameters of the one in-process learner (on its device)."""
        if self._local is None:
            raise RuntimeError("the parameters live in the learner actors; "
                               "use get_params_host()")
        return self._local.params

    def get_params_host(self):
        """Host copy of the current weights (for sampler broadcast): a tree
        of numpy arrays (rank 0's; every rank holds the same)."""
        if self._local is not None:
            return params_to_numpy(self._local.params)
        return rt.get(self._actors[0].params_host.remote(),
                      timeout=LEARNER_TIMEOUT_S)

    def shutdown(self) -> None:
        """Kill the learner actors (and with them their process group)."""
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self._actors)
        self._actors = []
