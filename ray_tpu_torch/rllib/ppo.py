"""PPO: synchronous sampling fan-out + a learner on the card (PyTorch port
of ``ray_tpu/rllib/ppo.py``).

Parity: reference ``rllib/algorithms/ppo/ppo.py:420`` (``training_step``:
synchronous_parallel_sample over the WorkerSet → GAE → minibatch SGD) and
``core/learner/learner.py:229``. The learner's clipped-surrogate update is
``sgd_epochs`` × minibatches of Adam steps on the learner's device (where
the JAX package scans them in one jitted program); each epoch's
permutation comes from an explicit ``torch.Generator`` and is an input of
the update. Rollouts come from CPU env-runner actors (rollout_worker.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rllib.models import (
    adam,
    apply_actor_critic,
    init_actor_critic,
    sgd_step,
    to_device,
    trainable,
)


@dataclasses.dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_workers: int = 2
    rollout_len: int = 512  # per worker per iteration
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    lr: float = 3e-4
    sgd_epochs: int = 8
    minibatch: int = 256
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "PPO":
        """The algorithm, its learner on ``device`` (CUDA by default)."""
        return PPO(self, device=device)


def ppo_loss(params, batch: Dict[str, torch.Tensor], c):
    """The clipped surrogate, value and entropy terms over a minibatch:
    (total, {"policy_loss", "vf_loss", "entropy"})."""
    logits, value = apply_actor_critic(params, batch["obs"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - c.clip, 1 + c.clip) * adv,
    ).mean()
    vf = ((value - batch["returns"]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg + c.vf_coef * vf - c.entropy_coef * entropy
    return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}


def ppo_update(params, opt: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], perms: torch.Tensor, c
               ) -> Dict[str, torch.Tensor]:
    """One epoch per row of ``perms`` ([epochs, n] indices into the batch),
    each ``n // minibatch`` Adam steps on consecutive slices of its
    permutation (the tail past the last whole minibatch is dropped). Returns
    the last minibatch's loss terms (detached)."""
    n = batch["obs"].shape[0]
    mb_size = min(c.minibatch, n)
    nmb = max(1, n // mb_size)
    for perm in perms:
        for idx in perm[: nmb * mb_size].reshape(nmb, mb_size):
            mb = {k: v[idx] for k, v in batch.items()}
            loss, aux = ppo_loss(params, mb, c)
            sgd_step(opt, loss)
    return {k: v.detach() for k, v in aux.items()}


class PPO:
    """``algo = PPOConfig(...).build(); algo.train()`` — each train() call is
    one sampling+SGD iteration returning reference-shaped result metrics."""

    def __init__(self, config: PPOConfig, device: DeviceLike = None):
        from ray_tpu_torch.rllib.common import (make_rollout_workers,
                                                probe_env_spec)

        self.config = config
        self.device = resolve_device(device)
        obs_dim, num_actions = probe_env_spec(config.env)
        self.params = trainable(init_actor_critic(
            config.seed, obs_dim, num_actions, config.hidden, device="cpu"),
            self.device)
        self.opt = adam(self.params, config.lr)
        self._update = self._make_update()
        self._perm_gen = torch.Generator().manual_seed(config.seed + 1)
        self.workers = make_rollout_workers(
            config.env, config.num_workers, config.rollout_len,
            config.gamma, config.lam, config.seed,
        )
        self._iter = 0
        self._recent_returns: List[float] = []

    # ------------------------------------------------------------------

    def _make_update(self):
        """``update(params, opt, perms, batch) -> aux``: the SGD epochs."""
        c = self.config

        def update(params, opt, perms, batch):
            return ppo_update(params, opt, batch, perms, c)

        return update

    def _perms(self, n: int) -> torch.Tensor:
        return torch.stack([
            torch.randperm(n, generator=self._perm_gen)
            for _ in range(self.config.sgd_epochs)
        ]).to(self.device)

    def _broadcast(self):
        """The weights to the workers: one host copy, ``put`` once."""
        return rt.put(params_to_numpy(self.params))

    def _sample(self, params_ref) -> List[Dict[str, np.ndarray]]:
        return rt.get([w.sample.remote(params_ref) for w in self.workers],
                      timeout=600)

    # ------------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        """One iteration (parity: Algorithm.train / PPO.training_step)."""
        self._iter += 1
        # synchronous parallel sample (weights broadcast via the object plane)
        batches = self._sample(self._broadcast())
        batch = {
            k: np.concatenate([b[k] for b in batches])
            for k in ("obs", "actions", "logp", "advantages", "returns")
        }
        for b in batches:
            self._recent_returns.extend(b["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        # advantage normalization (standard PPO practice)
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)

        n = batch["obs"].shape[0]
        aux = self._update(self.params, self.opt, self._perms(n),
                           to_device(batch, self.device))
        values = torch.stack(list(aux.values())).tolist()
        return {
            "training_iteration": self._iter,
            "episode_reward_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "num_env_steps_sampled": (
                self._iter * self.config.num_workers * self.config.rollout_len
            ),
            "info": dict(zip(aux, values)),
        }

    def stop(self):
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self.workers)
