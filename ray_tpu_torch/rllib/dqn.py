"""DQN: off-policy Q-learning with replay, target network, double-Q
(PyTorch port of ``ray_tpu/rllib/dqn.py``).

Parity: reference ``rllib/algorithms/dqn/dqn.py`` (``training_step``:
sample via the WorkerSet → store in the replay buffer → N SGD steps on
sampled minibatches → periodic target-network sync) with the standard
Rainbow-lite refinements the reference enables by default: double-Q action
selection and Huber TD loss (δ = 1). One iteration's minibatch loop runs
on the learner's device, the hard target copy on
``step % target_update_freq == 0`` inside it; epsilon-greedy env stepping
stays on the host CPU inside env-runner actors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rllib.models import (
    adam,
    apply_q_network,
    init_q_network,
    sgd_step,
    to_device,
    trainable,
    tree_leaves,
    tree_map,
)


@dataclasses.dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_workers: int = 2
    rollout_len: int = 128  # env steps per worker per iteration
    gamma: float = 0.99
    lr: float = 1e-3
    buffer_size: int = 50_000
    learning_starts: int = 1_000  # min buffer size before SGD
    train_batches: int = 32  # minibatch updates per iteration
    batch_size: int = 64
    target_update_freq: int = 500  # in SGD steps (hard sync)
    eps_start: float = 1.0
    eps_end: float = 0.02
    eps_decay_steps: int = 5_000  # env steps to anneal epsilon over
    double_q: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "DQN":
        """The algorithm, its learner on ``device`` (CUDA by default)."""
        return DQN(self, device=device)


class _ReplayBuffer:
    """Uniform circular replay (reference ReplayBuffer, utils/replay_buffers)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.terminals = np.zeros((capacity,), np.float32)
        self.size = 0
        self._pos = 0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["actions"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"].reshape(n, -1)
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.next_obs[idx] = batch["next_obs"].reshape(n, -1)
        self.terminals[idx] = batch["terminals"]
        self._pos = int((self._pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "terminals": self.terminals[idx],
        }


class _TransitionWorker:
    """Actor body: epsilon-greedy env stepping, returns raw transitions
    (off-policy — no GAE; the learner owns all value estimation). Its Q
    forward runs on ``device`` (the algorithm passes the CPU)."""

    def __init__(self, env_name: str, rollout_len: int, seed: int,
                 device: DeviceLike = None):
        from ray_tpu_torch.rllib.envs import make_env

        self.device = resolve_device(device)
        self.env = make_env(env_name)
        self.rollout_len = rollout_len
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def sample(self, params, eps: float) -> Dict[str, np.ndarray]:
        params = params_from_numpy(params, device=self.device)
        T = self.rollout_len
        obs_dim = int(np.prod(np.shape(self.obs)))
        out = {
            "obs": np.zeros((T, obs_dim), np.float32),
            "actions": np.zeros((T,), np.int32),
            "rewards": np.zeros((T,), np.float32),
            "next_obs": np.zeros((T, obs_dim), np.float32),
            "terminals": np.zeros((T,), np.float32),
        }
        for t in range(T):
            flat = np.asarray(self.obs, np.float32).reshape(-1)
            if self.rng.random() < eps:
                action = int(self.rng.integers(self.env.action_space.n))
            else:
                with torch.inference_mode():
                    q = apply_q_network(
                        params, torch.from_numpy(flat[None]).to(self.device))
                action = int(q[0].argmax())
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            out["obs"][t] = flat
            out["actions"][t] = action
            out["rewards"][t] = reward
            out["next_obs"][t] = np.asarray(nxt, np.float32).reshape(-1)
            # only TRUE termination zeroes the bootstrap; truncation keeps it
            out["terminals"][t] = float(terminated)
            self._episode_return += float(reward)
            if terminated or truncated:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                nxt, _ = self.env.reset()
            self.obs = nxt
        completed, self._completed = self._completed, []
        out["episode_returns"] = np.asarray(completed, np.float32)
        return out


def td_loss(params, target_params, mb: Dict[str, torch.Tensor], c
            ) -> torch.Tensor:
    """Huber TD loss of Q(s, a) against r + γ (1 - terminal) V(s'), V from
    the target network at the online network's argmax (double-Q) or at
    its own max."""
    q = apply_q_network(params, mb["obs"])
    q_sa = q.gather(-1, mb["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_target = apply_q_network(target_params, mb["next_obs"])
        if c.double_q:
            # double-Q: online net picks the action, target net rates it
            best = apply_q_network(params, mb["next_obs"]).argmax(-1)
            next_v = q_next_target.gather(-1, best[:, None])[:, 0]
        else:
            next_v = q_next_target.max(-1).values
        target = mb["rewards"] + c.gamma * (1.0 - mb["terminals"]) * next_v
    return F.huber_loss(q_sa, target, delta=1.0)


def dqn_update(params, target_params, opt: torch.optim.Optimizer,
               sgd_step0: int, batches: Dict[str, torch.Tensor], c
               ) -> Tuple[int, torch.Tensor]:
    """One Adam step per minibatch of ``batches`` ([train_batches,
    batch_size, ...]), the target network copied from the online one
    whenever the step count reaches a multiple of ``target_update_freq``.
    Returns (step count, mean loss)."""
    step, losses = sgd_step0, []
    for i in range(next(iter(batches.values())).shape[0]):
        mb = {k: v[i] for k, v in batches.items()}
        loss = td_loss(params, target_params, mb, c)
        sgd_step(opt, loss)
        losses.append(loss.detach())
        step += 1
        if step % c.target_update_freq == 0:
            with torch.no_grad():
                for t, p in zip(tree_leaves(target_params),
                                tree_leaves(params)):
                    t.copy_(p)
    return step, torch.stack(losses).mean()


class DQN:
    """``algo = DQNConfig(...).build(); algo.train()`` — one iteration =
    parallel sampling + ``train_batches`` replay minibatch updates."""

    def __init__(self, config: DQNConfig, device: DeviceLike = None):
        from ray_tpu_torch.rllib.common import probe_env_spec

        self.config = config
        self.device = resolve_device(device)
        obs_dim, num_actions = probe_env_spec(config.env)
        params = init_q_network(config.seed, obs_dim, num_actions,
                                config.hidden, device="cpu")
        self.params = trainable(params, self.device)
        self.target_params = tree_map(lambda t: t.detach().clone(),
                                      self.params)
        self.opt = adam(self.params, config.lr)
        self.buffer = _ReplayBuffer(config.buffer_size, obs_dim)
        self._np_rng = np.random.default_rng(config.seed + 7)
        self._update = self._make_update()
        cls = rt.remote(num_cpus=1)(_TransitionWorker)
        self.workers = [
            cls.remote(config.env, config.rollout_len,
                       config.seed + 1000 * (i + 1), device="cpu")
            for i in range(config.num_workers)
        ]
        self._iter = 0
        self._env_steps = 0
        self._sgd_steps = 0
        self._recent_returns: List[float] = []

    def _make_update(self):
        """``update(params, target_params, opt, sgd_step0, batches) ->
        (step, mean loss)``: the iteration's SGD loop."""
        c = self.config

        def update(params, target_params, opt, sgd_step0, batches):
            return dqn_update(params, target_params, opt, sgd_step0,
                              batches, c)

        return update

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._env_steps / max(1, c.eps_decay_steps))
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    def train(self) -> Dict[str, Any]:
        c = self.config
        self._iter += 1
        eps = self._epsilon()
        params_ref = rt.put(params_to_numpy(self.params))
        batches = rt.get(
            [w.sample.remote(params_ref, eps) for w in self.workers],
            timeout=600,
        )
        for b in batches:
            self.buffer.add_batch(b)
            self._recent_returns.extend(b["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        self._env_steps += c.num_workers * c.rollout_len

        mean_loss = float("nan")
        if self.buffer.size >= c.learning_starts:
            mbs = [
                self.buffer.sample(self._np_rng, c.batch_size)
                for _ in range(c.train_batches)
            ]
            stacked = to_device(
                {k: np.stack([m[k] for m in mbs]) for k in mbs[0]},
                self.device)
            self._sgd_steps, loss = self._update(
                self.params, self.target_params, self.opt,
                self._sgd_steps, stacked,
            )
            mean_loss = float(loss)

        return {
            "training_iteration": self._iter,
            "episode_reward_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "num_env_steps_sampled": self._env_steps,
            "epsilon": eps,
            "info": {"mean_td_loss": mean_loss,
                     "buffer_size": self.buffer.size},
        }

    def stop(self):
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self.workers)
