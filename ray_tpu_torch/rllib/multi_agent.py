"""Multi-agent RL: the MultiAgentEnv contract, a multi-agent rollout
worker, and multi-agent PPO over a dict of policies (PyTorch port of
``ray_tpu/rllib/multi_agent.py``).

Parity: reference ``rllib/env/multi_agent_env.py`` (dict-keyed
obs/reward/termination with the ``"__all__"`` sentinel),
``rllib/policy/policy_map.py`` + ``policy_mapping_fn`` (agent→policy
routing, including shared policies), and the multi-agent sample
collection in ``rllib/evaluation/sampler.py``.  Scope (as the JAX
package's): every agent acts every step and episodes end for all agents
together — the common self-play / parameter-sharing shapes; per-agent
early exit is out of scope.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.models import (
    adam,
    apply_actor_critic,
    init_actor_critic,
    to_device,
    trainable,
)


class MultiAgentEnv:
    """Dict-keyed env API (reference multi_agent_env.py):

    ``reset() -> (obs_dict, info_dict)``
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``
    where ``terminateds``/``truncateds`` carry the ``"__all__"`` key."""

    agent_ids: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


class TwoAgentTarget(MultiAgentEnv):
    """Cooperative proxy env for multi-agent tests: two point agents on a
    1-D line each steer (left/stay/right) toward their own target; the
    TEAM reward per agent is its own progress, so independent learners
    with separate (or shared) policies both work. A random policy earns
    ~-8 per episode; a learned one approaches ~-2."""

    N_STEPS = 24
    agent_ids = ["a0", "a1"]

    def __init__(self):
        self.action_space = _envs._DiscreteSpace(3)
        self.observation_space = _envs._BoxSpace((2,))
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = {a: float(self._rng.uniform(-1, 1)) for a in self.agent_ids}
        self.tgt = {
            a: float(self._rng.uniform(-0.7, 0.7)) for a in self.agent_ids
        }
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return {
            a: np.array([self.pos[a], self.tgt[a]], np.float32)
            for a in self.agent_ids
        }

    def step(self, action_dict):
        rewards = {}
        for a in self.agent_ids:
            act = int(action_dict[a]) - 1  # {-1, 0, +1}
            self.pos[a] = float(np.clip(self.pos[a] + 0.12 * act, -1, 1))
            rewards[a] = -abs(self.pos[a] - self.tgt[a])
        self._t += 1
        done = self._t >= self.N_STEPS
        terminateds = {a: False for a in self.agent_ids}
        terminateds["__all__"] = False
        truncateds = {a: done for a in self.agent_ids}
        truncateds["__all__"] = done
        return self._obs(), rewards, terminateds, truncateds, {}


_envs._REGISTRY.setdefault("TwoAgentTarget-v0", TwoAgentTarget)


class MultiAgentRolloutWorker:
    """Actor body: steps a MultiAgentEnv with per-policy parameters and
    returns one GAE-processed train batch PER POLICY (agents sharing a
    policy contribute to the same batch — parameter sharing for free). The
    policy forward runs on ``device`` (the algorithm passes the CPU)."""

    def __init__(self, env_name: str, rollout_len: int, gamma: float,
                 lam: float, policy_mapping: Dict[str, str], seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.env = _envs.make_env(env_name)
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.policy_mapping = dict(policy_mapping)
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def _apply(self, params, obs):
        """(logits [A] float64, value) of one agent's observation."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        with torch.inference_mode():
            logits, value = apply_actor_critic(params, x)
        return logits[0].cpu().numpy().astype(np.float64), float(value[0])

    def sample(self, params_by_policy) -> Dict[str, Dict[str, np.ndarray]]:
        params_by_policy = params_from_numpy(params_by_policy,
                                             device=self.device)
        T = self.rollout_len
        agents = self.env.agent_ids
        buf = {
            a: {
                "obs": [], "actions": [], "logp": [], "values": [],
                "rewards": [], "cuts": [],
            }
            for a in agents
        }
        for _ in range(T):
            actions = {}
            for a in agents:
                pol = self.policy_mapping[a]
                logits, value = self._apply(params_by_policy[pol], self.obs[a])
                p = np.exp(logits - logits.max())
                p /= p.sum()
                act = int(self.rng.choice(len(p), p=p))
                actions[a] = act
                buf[a]["obs"].append(np.asarray(self.obs[a], np.float32))
                buf[a]["actions"].append(act)
                buf[a]["logp"].append(float(np.log(p[act] + 1e-12)))
                buf[a]["values"].append(value)
            nxt, rewards, terms, truncs, _ = self.env.step(actions)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            self._episode_return += float(
                np.mean([rewards[a] for a in agents])
            )
            for a in agents:
                buf[a]["rewards"].append(float(rewards[a]))
                buf[a]["cuts"].append(float(done))
            if done:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                nxt, _ = self.env.reset()
            self.obs = nxt

        # per-agent GAE (terminated==0 here: the proxy env only truncates;
        # mid-rollout cut still restarts the GAE recursion)
        out: Dict[str, Dict[str, List[np.ndarray]]] = {}
        for a in agents:
            b = buf[a]
            vals = np.asarray(b["values"], np.float32)
            rews = np.asarray(b["rewards"], np.float32)
            cuts = np.asarray(b["cuts"], np.float32)
            next_val = np.zeros(T, np.float32)
            next_val[:-1] = vals[1:] * (1.0 - cuts[:-1])
            pol = self.policy_mapping[a]
            if cuts[-1] == 0.0:
                next_val[-1] = self._apply(params_by_policy[pol],
                                           self.obs[a])[1]
            adv = np.zeros(T, np.float32)
            last = 0.0
            for t in reversed(range(T)):
                delta = rews[t] + self.gamma * next_val[t] - vals[t]
                last = delta + self.gamma * self.lam * (1 - cuts[t]) * last
                adv[t] = last
            dst = out.setdefault(pol, {
                "obs": [], "actions": [], "logp": [], "advantages": [],
                "returns": [],
            })
            dst["obs"].append(np.stack(b["obs"]))
            dst["actions"].append(np.asarray(b["actions"], np.int32))
            dst["logp"].append(np.asarray(b["logp"], np.float32))
            dst["advantages"].append(adv)
            dst["returns"].append(adv + vals)
        completed, self._completed = self._completed, []
        return {
            "batches": {
                pol: {k: np.concatenate(v) for k, v in d.items()}
                for pol, d in out.items()
            },
            "episode_returns": np.asarray(completed, np.float32),
        }


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env: str = "TwoAgentTarget-v0"
    policies: Optional[List[str]] = None  # default: one shared policy
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    num_workers: int = 2
    rollout_len: int = 384
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    lr: float = 3e-4
    sgd_epochs: int = 6
    minibatch: int = 256
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "MultiAgentPPO":
        """The algorithm, its learners on ``device`` (CUDA by default)."""
        return MultiAgentPPO(self, device=device)


class MultiAgentPPO:
    """Independent PPO per policy over multi-agent rollouts (reference:
    the default multi-agent training path — one Learner update per policy
    on that policy's sample batch; shared policies train on the union of
    their agents' experience)."""

    def __init__(self, config: MultiAgentPPOConfig, device: DeviceLike = None):
        from ray_tpu_torch.rllib.ppo import PPOConfig, ppo_update

        self.config = config
        self.device = resolve_device(device)
        probe = _envs.make_env(config.env)
        try:
            agents = list(probe.agent_ids)
            obs_dim = int(np.prod(probe.observation_space.shape))
            num_actions = int(probe.action_space.n)
        finally:
            probe.close()
        mapping_fn = config.policy_mapping_fn or (lambda aid: "shared")
        self.policy_mapping = {a: mapping_fn(a) for a in agents}
        self.policies = sorted(
            config.policies or set(self.policy_mapping.values())
        )
        for a, p in self.policy_mapping.items():
            if p not in self.policies:
                raise ValueError(f"agent {a} maps to unknown policy {p}")
        self.params = {}
        for i, pol in enumerate(self.policies):
            self.params[pol] = trainable(init_actor_critic(
                config.seed + i, obs_dim, num_actions, config.hidden,
                device="cpu"), self.device)
        self.opt = {pol: adam(self.params[pol], config.lr)
                    for pol in self.policies}
        # reuse the single-agent clipped-surrogate update: the multi-agent
        # trainer is N independent PPO updates (reference semantics)
        sa_cfg = PPOConfig(
            clip=config.clip, lr=config.lr, sgd_epochs=config.sgd_epochs,
            minibatch=config.minibatch, entropy_coef=config.entropy_coef,
            vf_coef=config.vf_coef,
        )

        def update(params, opt, perms, batch):
            return ppo_update(params, opt, batch, perms, sa_cfg)

        self._update = update
        self._perm_gen = torch.Generator().manual_seed(config.seed + 11)
        cls = rt.remote(num_cpus=1)(MultiAgentRolloutWorker)
        self.workers = [
            cls.remote(
                config.env, config.rollout_len, config.gamma, config.lam,
                self.policy_mapping, seed=config.seed + 1000 * (i + 1),
                device="cpu",
            )
            for i in range(config.num_workers)
        ]
        self._iter = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        self._iter += 1
        params_ref = rt.put({pol: params_to_numpy(p)
                             for pol, p in self.params.items()})
        results = rt.get(
            [w.sample.remote(params_ref) for w in self.workers], timeout=600
        )
        for r in results:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        infos = {}
        for pol in self.policies:
            parts = [
                r["batches"][pol] for r in results if pol in r["batches"]
            ]
            if not parts:
                continue
            batch = {
                k: np.concatenate([p[k] for p in parts])
                for k in parts[0]
            }
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            n = batch["obs"].shape[0]
            perms = torch.stack([
                torch.randperm(n, generator=self._perm_gen)
                for _ in range(self.config.sgd_epochs)
            ]).to(self.device)
            aux = self._update(self.params[pol], self.opt[pol], perms,
                               to_device(batch, self.device))
            infos[pol] = dict(zip(aux, torch.stack(list(aux.values()))
                                  .tolist()))
        return {
            "training_iteration": self._iter,
            "episode_reward_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "num_env_steps_sampled": (
                self._iter * self.config.num_workers * self.config.rollout_len
            ),
            "info": infos,
        }

    def stop(self):
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self.workers)
