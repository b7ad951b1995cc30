"""SAC: off-policy continuous control — twin critics, squashed Gaussian
policy, automatic entropy tuning (PyTorch port of ``ray_tpu/rllib/sac.py``).

Parity: reference ``rllib/algorithms/sac/sac.py`` (+ ``sac_tf_policy.py``
loss structure: twin Q networks with min-Q bootstrap, reparameterized
tanh-Gaussian actor, learned alpha against a target entropy, polyak
target updates). One iteration's minibatch loop — critic, actor and alpha
updates plus the polyak step — runs on the learner's device; env stepping
stays on the host CPU inside env-runner actors.

As the JAX package computes it, ONE Adam steps the whole ``{pi, q1, q2}``
tree: each part's leaves take their own loss's gradient (the critics'
from the critic loss, the actor's from the actor loss) and nothing of the
other's. The temperature has its own Adam. The sampling noise is an input
of ``sample_squashed`` (and of ``sac_update``), drawn by the caller from an
explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.models import (
    GeneratorLike,
    _mlp_apply,
    _mlp_params,
    _on,
    adam,
    generator,
    grads_of,
    to_device,
    trainable,
    tree_leaves,
    tree_map,
)


# ---------------------------------------------------------------- envs ----
class PointGoal2D:
    """Continuous-control proxy env (this image has no MuJoCo): a point
    mass on [-1, 1]^2 must reach a fixed goal; actions are velocity
    commands in [-1, 1]^2, reward is negative distance to goal with a
    small action penalty.  A random policy hovers near -0.7/step; a
    learned one approaches ~-0.05/step — a crisp learning signal for the
    SAC reward-threshold test."""

    MAX_STEPS = 60

    def __init__(self):
        self.action_space = _envs._BoxSpace((2,))
        self.action_space.low = -np.ones(2, np.float32)
        self.action_space.high = np.ones(2, np.float32)
        self.observation_space = _envs._BoxSpace((4,))
        self._rng = np.random.default_rng(0)
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = self._rng.uniform(-1.0, 1.0, 2).astype(np.float32)
        self.goal = self._rng.uniform(-0.6, 0.6, 2).astype(np.float32)
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self.pos = np.clip(self.pos + 0.15 * a, -1.0, 1.0)
        d = float(np.linalg.norm(self.pos - self.goal))
        reward = -d - 0.05 * float(np.sum(a * a))
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        return self._obs(), reward, False, truncated, {}

    def _obs(self):
        return np.concatenate([self.pos, self.goal]).astype(np.float32)

    def close(self):
        pass


_envs._REGISTRY.setdefault("PointGoal2D-v0", PointGoal2D)


def probe_continuous_env_spec(env_name: str) -> Tuple[int, int]:
    """(obs_dim, act_dim) for a continuous-action env."""
    probe = _envs.make_env(env_name)
    try:
        if hasattr(probe.action_space, "n"):
            raise ValueError(f"{env_name}: SAC needs a continuous env")
        return (
            int(np.prod(probe.observation_space.shape)),
            int(np.prod(probe.action_space.shape)),
        )
    finally:
        probe.close()


# ------------------------------------------------------------- networks ----
def init_sac_networks(rng: GeneratorLike, obs_dim: int, act_dim: int,
                      hidden=(128, 128), device: DeviceLike = None) -> Dict:
    """Actor (mu, log_std heads) + twin critics Q(s, a), on ``device`` (CUDA
    by default)."""
    gen = generator(rng)
    return _on({
        "pi": _mlp_params(gen, [obs_dim, *hidden], 2 * act_dim, 0.01),
        "q1": _mlp_params(gen, [obs_dim + act_dim, *hidden], 1, 1.0),
        "q2": _mlp_params(gen, [obs_dim + act_dim, *hidden], 1, 1.0),
    }, device)


def apply_actor(params, obs):
    """obs [B, D] -> (mu [B, A], log_std [B, A]), log_std clamped."""
    mu, log_std = _mlp_apply(params["pi"], obs).chunk(2, dim=-1)
    return mu, torch.clamp(log_std, -10.0, 2.0)


def apply_critic(params, key, obs, act):
    return _mlp_apply(params[key], torch.cat([obs, act], -1))[..., 0]


def sample_squashed(noise, mu, log_std):
    """Reparameterized tanh-Gaussian sample at standard-normal ``noise``
    (shaped like ``mu``) -> (action in (-1,1), logp). log(1 - tanh(u)^2)
    computed via the softplus identity for stability."""
    std = torch.exp(log_std)
    u = mu + std * noise
    logp_u = (
        -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
    ).sum(-1)
    a = torch.tanh(u)
    logp = logp_u - (
        2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u))
    ).sum(-1)
    return a, logp


# --------------------------------------------------------------- config ----
@dataclasses.dataclass
class SACConfig:
    env: str = "PointGoal2D-v0"
    num_workers: int = 2
    rollout_len: int = 256
    gamma: float = 0.99
    lr: float = 1e-3
    alpha_lr: float = 1e-3
    tau: float = 0.01  # polyak target update rate
    buffer_size: int = 100_000
    learning_starts: int = 1_000
    # ~1 gradient step per sampled env step (num_workers * rollout_len /
    # train_batches ≈ 2) — the standard SAC update-to-data ratio; at 0.1
    # the policy visibly stalls
    train_batches: int = 256  # minibatch updates per iteration
    batch_size: int = 128
    target_entropy: Optional[float] = None  # default: -act_dim
    hidden: tuple = (128, 128)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "SAC":
        """The algorithm, its learner on ``device`` (CUDA by default)."""
        return SAC(self, device=device)


class _ContinuousReplay:
    """Uniform circular replay with float action vectors."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, act_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.terminals = np.zeros((capacity,), np.float32)
        self.size = 0
        self._pos = 0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["actions"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.next_obs[idx] = batch["next_obs"]
        self.terminals[idx] = batch["terminals"]
        self._pos = int((self._pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng, n):
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "terminals": self.terminals[idx],
        }


class _SacWorker:
    """Actor body: steps the env with the current squashed-Gaussian policy
    (uniform random before ``learning_starts`` env steps, the standard SAC
    warmup) and returns raw transitions. Its policy forward runs on
    ``device`` (the algorithm passes the CPU), its noise from a generator
    seeded with ``seed``."""

    def __init__(self, env_name: str, rollout_len: int, seed: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.env = _envs.make_env(env_name)
        self.rollout_len = rollout_len
        self.act_dim = int(np.prod(self.env.action_space.shape))
        self.rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def _act(self, params, flat: np.ndarray) -> np.ndarray:
        noise = torch.randn(1, self.act_dim, generator=self._gen)
        with torch.inference_mode():
            mu, log_std = apply_actor(
                params, torch.from_numpy(flat[None]).to(self.device))
            a, _ = sample_squashed(noise.to(self.device), mu, log_std)
        return a[0].cpu().numpy().astype(np.float32)

    def sample(self, params, random_actions: bool) -> Dict[str, np.ndarray]:
        params = params_from_numpy(params, device=self.device)
        T = self.rollout_len
        obs_dim = int(np.prod(np.shape(self.obs)))
        out = {
            "obs": np.zeros((T, obs_dim), np.float32),
            "actions": np.zeros((T, self.act_dim), np.float32),
            "rewards": np.zeros((T,), np.float32),
            "next_obs": np.zeros((T, obs_dim), np.float32),
            "terminals": np.zeros((T,), np.float32),
        }
        for t in range(T):
            flat = np.asarray(self.obs, np.float32).reshape(-1)
            if random_actions:
                action = self.rng.uniform(-1, 1, self.act_dim).astype(
                    np.float32
                )
            else:
                action = self._act(params, flat)
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            out["obs"][t] = flat
            out["actions"][t] = action
            out["rewards"][t] = reward
            out["next_obs"][t] = np.asarray(nxt, np.float32).reshape(-1)
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


# --------------------------------------------------------------- update ----
def critic_loss(params, target_q, log_alpha, mb, noise, c) -> torch.Tensor:
    """Twin-Q regression on r + γ (1 - terminal) (min target Q - α logp),
    the target's next action drawn at ``noise``; no gradient in the
    target."""
    with torch.no_grad():
        mu, log_std = apply_actor(params, mb["next_obs"])
        a2, logp2 = sample_squashed(noise, mu, log_std)
        q1t = apply_critic(target_q, "q1", mb["next_obs"], a2)
        q2t = apply_critic(target_q, "q2", mb["next_obs"], a2)
        v_next = torch.minimum(q1t, q2t) - torch.exp(log_alpha) * logp2
        y = mb["rewards"] + c.gamma * (1 - mb["terminals"]) * v_next
    q1 = apply_critic(params, "q1", mb["obs"], mb["actions"])
    q2 = apply_critic(params, "q2", mb["obs"], mb["actions"])
    return ((q1 - y) ** 2 + (q2 - y) ** 2).mean()


def actor_loss(params, log_alpha, mb, noise):
    """(α logp - min Q) at the actor's action drawn at ``noise``; and logp."""
    mu, log_std = apply_actor(params, mb["obs"])
    a, logp = sample_squashed(noise, mu, log_std)
    q = torch.minimum(
        apply_critic(params, "q1", mb["obs"], a),
        apply_critic(params, "q2", mb["obs"], a),
    )
    return (torch.exp(log_alpha) * logp - q).mean(), logp


def sac_grads(params, target_q, log_alpha, mb, noise, c):
    """The gradient tree ONE Adam steps, as the JAX package builds it: the
    critic loss's gradients on ``q1``/``q2``, the actor loss's on ``pi``
    (each part's other gradients masked out). Returns (grads, one per leaf
    of ``params`` in order, critic loss, actor loss, logp)."""
    la = log_alpha.detach()
    closs = critic_loss(params, target_q, la, mb, noise[0], c)
    q_leaves = tree_leaves([params["q1"], params["q2"]])
    aloss, logp = actor_loss(params, la, mb, noise[1])
    pi_leaves = tree_leaves(params["pi"])
    by_leaf = {**dict(zip(q_leaves, grads_of(closs, q_leaves))),
               **dict(zip(pi_leaves, grads_of(aloss, pi_leaves)))}
    grads = [by_leaf[p] for p in tree_leaves(params)]
    return grads, closs.detach(), aloss.detach(), logp.detach()


def sac_update(state: Dict, batches: Dict[str, torch.Tensor],
               noise: torch.Tensor, c, target_entropy: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SAC step per minibatch of ``batches`` ([S, batch_size, ...]),
    in place on ``state`` (``params``, ``target_q``, ``log_alpha``, ``opt``
    over every leaf of ``params``, ``alpha_opt``); ``noise`` [S, 2,
    batch_size, act_dim] is each step's (critic, actor) draw. Returns the
    mean critic and actor losses."""
    params, target_q = state["params"], state["target_q"]
    log_alpha = state["log_alpha"]
    closses, alosses = [], []
    for i in range(noise.shape[0]):
        mb = {k: v[i] for k, v in batches.items()}
        grads, closs, aloss, logp = sac_grads(params, target_q, log_alpha,
                                              mb, noise[i], c)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        state["opt"].step()
        # -- temperature: d/dla of -(la * (logp + H)).mean() --
        log_alpha.grad = -(logp + target_entropy).mean()
        state["alpha_opt"].step()
        # -- polyak --
        with torch.no_grad():
            for t, s in zip(tree_leaves(target_q),
                            tree_leaves([params["q1"], params["q2"]])):
                t.copy_((1 - c.tau) * t + c.tau * s)
        closses.append(closs)
        alosses.append(aloss)
    return torch.stack(closses).mean(), torch.stack(alosses).mean()


class SAC:
    """``algo = SACConfig(...).build(); algo.train()`` — one iteration =
    parallel sampling + ``train_batches`` SGD steps on the learner."""

    def __init__(self, config: SACConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        obs_dim, act_dim = probe_continuous_env_spec(config.env)
        self.act_dim = act_dim
        self.target_entropy = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(act_dim)
        )
        self.state = init_sac_state(config, obs_dim, act_dim, self.device)
        self._update = self._make_update()
        self.buffer = _ContinuousReplay(config.buffer_size, obs_dim, act_dim)
        self._np_rng = np.random.default_rng(config.seed + 7)
        self._noise_gen = torch.Generator().manual_seed(config.seed + 3)
        cls = rt.remote(num_cpus=1)(_SacWorker)
        self.workers = [
            cls.remote(config.env, config.rollout_len,
                       config.seed + 1000 * (i + 1), device="cpu")
            for i in range(config.num_workers)
        ]
        self._iter = 0
        self._env_steps = 0
        self._recent_returns: List[float] = []

    @property
    def params(self):
        return self.state["params"]

    def _make_update(self):
        """``update(state, batches, noise) -> (critic loss, actor loss)``:
        the iteration's SAC steps."""
        c, target_entropy = self.config, self.target_entropy

        def update(state, batches, noise):
            return sac_update(state, batches, noise, c, target_entropy)

        return update

    def train(self) -> Dict[str, Any]:
        c = self.config
        self._iter += 1
        warmup = self.buffer.size < c.learning_starts
        params_ref = rt.put(params_to_numpy(self.params))
        batches = rt.get(
            [w.sample.remote(params_ref, warmup) for w in self.workers],
            timeout=600,
        )
        for b in batches:
            self.buffer.add_batch(b)
            self._recent_returns.extend(b["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        self._env_steps += c.num_workers * c.rollout_len

        closs = aloss = float("nan")
        if self.buffer.size >= c.learning_starts:
            mbs = [
                self.buffer.sample(self._np_rng, c.batch_size)
                for _ in range(c.train_batches)
            ]
            stacked = to_device(
                {k: np.stack([m[k] for m in mbs]) for k in mbs[0]},
                self.device)
            noise = torch.randn(c.train_batches, 2, c.batch_size,
                                self.act_dim, generator=self._noise_gen)
            cl, al = self._update(self.state, stacked,
                                  noise.to(self.device))
            closs, aloss = torch.stack([cl, al]).tolist()

        return {
            "training_iteration": self._iter,
            "episode_reward_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "num_env_steps_sampled": self._env_steps,
            "info": {
                "critic_loss": closs,
                "actor_loss": aloss,
                "alpha": math.exp(float(self.state["log_alpha"].detach())),
                "buffer_size": self.buffer.size,
            },
        }

    def stop(self):
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self.workers)


def init_sac_state(config: SACConfig, obs_dim: int, act_dim: int,
                   device: torch.device, params=None) -> Dict:
    """The learner's state on ``device``: the networks (from ``params``, a
    tree of arrays or tensors, or from ``config.seed``), the polyak targets
    (copies of the critics), ``log_alpha`` = 0, one Adam over every leaf of
    the networks and one over ``log_alpha``."""
    if params is None:
        params = init_sac_networks(config.seed, obs_dim, act_dim,
                                   config.hidden, device="cpu")
    params = trainable(params, device)
    target_q = tree_map(lambda t: t.detach().clone(),
                        {"q1": params["q1"], "q2": params["q2"]})
    log_alpha = torch.zeros((), dtype=params["pi"][0]["w"].dtype,
                            device=device, requires_grad=True)
    return {"params": params, "target_q": target_q, "log_alpha": log_alpha,
            "opt": adam(params, config.lr),
            "alpha_opt": torch.optim.Adam([log_alpha], lr=config.alpha_lr)}
