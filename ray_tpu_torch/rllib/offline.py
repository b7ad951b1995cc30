"""Offline RL: dataset-backed experience input + behavioral cloning
(PyTorch port of ``ray_tpu/rllib/offline.py``).

Parity: reference ``rllib/offline/`` — the JSON sample reader/writer
(``offline/json_reader.py`` / ``json_writer.py``: episodes as JSONL rows
of obs/action/reward batches) and the canonical offline algorithm family
representative, behavioral cloning (``rllib/algorithms/bc/bc.py`` —
supervised max-likelihood on logged actions; the simplest member of the
MARWIL family the reference derives it from).  Input rides the port's
``ray_tpu_torch.data`` (a Dataset of transition rows, ``read_json``), so
logged experience shares the streaming/shuffle machinery with every other
ingest path. A training iteration's minibatch Adam steps run on the
learner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.models import (
    adam,
    apply_actor_critic,
    init_actor_critic,
    sgd_step,
    to_device,
    trainable,
)


# ------------------------------------------------------------- IO layer ----

def write_experience_json(rows: List[Dict[str, Any]], path: str) -> int:
    """Log transitions as JSONL (reference json_writer shape): each row
    has obs (list), action (int), reward (float), done (bool)."""
    import json

    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps({
                "obs": np.asarray(row["obs"], np.float32).tolist(),
                "action": int(row["action"]),
                "reward": float(row.get("reward", 0.0)),
                "done": bool(row.get("done", False)),
            }) + "\n")
    return len(rows)


def read_experience(paths, parallelism: int = 8):
    """JSONL experience file(s) -> ray_tpu_torch.data Dataset of
    transitions."""
    import ray_tpu_torch.data as rd

    return rd.read_json(paths, parallelism=parallelism)


def collect_experience(env_name: str, policy_fn, n_steps: int,
                       seed: int = 0) -> List[Dict[str, Any]]:
    """Roll a policy (obs -> action int) to produce offline rows."""
    from ray_tpu_torch.rllib.envs import make_env

    env = make_env(env_name)
    obs, _ = env.reset(seed=seed)
    out = []
    for _ in range(n_steps):
        action = int(policy_fn(np.asarray(obs, np.float32).reshape(-1)))
        nxt, reward, terminated, truncated, _ = env.step(action)
        out.append({
            "obs": np.asarray(obs, np.float32).reshape(-1),
            "action": action,
            "reward": float(reward),
            "done": bool(terminated or truncated),
        })
        obs = env.reset()[0] if (terminated or truncated) else nxt
    env.close()
    return out


# ------------------------------------------------------------------ BC ----

def bc_loss(params, mb: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Negative log-likelihood of the logged actions."""
    logits, _ = apply_actor_critic(params, mb["obs"])
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, mb["actions"].long()[:, None])[:, 0].mean()


def bc_update(params, opt: torch.optim.Optimizer,
              batches: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One Adam step per minibatch of ``batches`` ([nmb, mb, ...]); returns
    the mean loss."""
    losses = []
    for i in range(batches["obs"].shape[0]):
        loss = bc_loss(params, {k: v[i] for k, v in batches.items()})
        sgd_step(opt, loss)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


@dataclasses.dataclass
class BCConfig:
    """Behavioral cloning over an offline Dataset (reference
    algorithms/bc)."""

    obs_dim: int = 0          # 0: infer from the first row
    num_actions: int = 0
    lr: float = 1e-3
    epochs_per_iter: int = 4
    minibatch: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, dataset, device: DeviceLike = None) -> "BC":
        """The algorithm over ``dataset``, its learner on ``device`` (CUDA
        by default)."""
        return BC(self, dataset, device=device)


class BC:
    """``BCConfig(...).build(ds).train()`` — each iteration is
    ``epochs_per_iter`` passes of minibatch SGD over the logged
    (obs, action) pairs; ``evaluate(env)`` rolls the cloned policy."""

    def __init__(self, config: BCConfig, dataset, device: DeviceLike = None):
        self.device = resolve_device(device)
        rows = dataset.take_all()
        if not rows:
            raise ValueError("offline dataset is empty")
        self.obs = np.stack([
            np.asarray(r["obs"], np.float32) for r in rows
        ])
        self.actions = np.asarray([r["action"] for r in rows], np.int32)
        obs_dim = config.obs_dim or self.obs.shape[1]
        num_actions = config.num_actions or int(self.actions.max()) + 1
        self.config = config
        self.num_actions = num_actions
        self.params = trainable(init_actor_critic(
            config.seed, obs_dim, num_actions, config.hidden, device="cpu"),
            self.device)
        self.opt = adam(self.params, config.lr)
        self._rng = np.random.default_rng(config.seed + 1)
        self._update = bc_update
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        c = self.config
        self._iter += 1
        n = len(self.obs)
        mb = min(c.minibatch, n)
        nmb = max(1, n // mb)
        obs_b, act_b = [], []
        for _ in range(c.epochs_per_iter):
            perm = self._np_perm(n)[: nmb * mb].reshape(nmb, mb)
            obs_b.append(self.obs[perm])
            act_b.append(self.actions[perm])
        batches = to_device({
            "obs": np.concatenate(obs_b),
            "actions": np.concatenate(act_b),
        }, self.device)
        loss = self._update(self.params, self.opt, batches)
        return {
            "training_iteration": self._iter,
            "num_samples": n,
            "info": {"bc_loss": float(loss)},
        }

    def _np_perm(self, n):
        return self._rng.permutation(n)

    def compute_action(self, obs) -> int:
        x = torch.from_numpy(np.asarray(obs, np.float32).reshape(1, -1))
        with torch.inference_mode():
            logits, _ = apply_actor_critic(self.params, x.to(self.device))
        return int(logits[0].argmax())

    def evaluate(self, env_name: str, episodes: int = 5,
                 seed: int = 0) -> float:
        """Mean episode return of the cloned policy."""
        from ray_tpu_torch.rllib.envs import make_env

        env = make_env(env_name)
        total = 0.0
        for ep in range(episodes):
            obs, _ = env.reset(seed=seed + ep)
            done = False
            while not done:
                obs, r, term, trunc, _ = env.step(
                    self.compute_action(obs)
                )
                total += float(r)
                done = term or trunc
        env.close()
        return total / episodes

    def stop(self):
        pass
