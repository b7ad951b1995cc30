"""Env-runner actor: collects on-policy rollouts with GAE post-processing
(PyTorch port of ``ray_tpu/rllib/rollout_worker.py``).

Parity: reference ``rllib/evaluation/rollout_worker.py:159`` (``sample():660``
→ ``sampler.py`` env loop) plus the GAE postprocessor
(``evaluation/postprocessing.py:158``). Env stepping and the tiny per-step
policy forward stay on the host CPU inside these actors; only the learner's
batched update runs on the card. The algorithms start this actor on a CPU
lease with ``device="cpu"``: its process sees every card, and it must
never create a CUDA context, so nothing here touches one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib.models import apply_actor_critic


class RolloutWorker:
    """Actor body. One (gymnasium) env per worker; ``sample(params)`` runs
    ``rollout_len`` steps with the given policy (a host tree of numpy
    arrays) and returns a GAE-processed train batch of numpy arrays."""

    def __init__(self, env_name: str, rollout_len: int, gamma: float,
                 lam: float, seed: int = 0, device: DeviceLike = None):
        from ray_tpu_torch.rllib.envs import make_env

        self.device = resolve_device(device)
        self.env = make_env(env_name)
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def _apply(self, params, obs):
        """(logits [A] float64, value) of one observation."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        with torch.inference_mode():
            logits, value = apply_actor_critic(params, x)
        return logits[0].cpu().numpy().astype(np.float64), float(value[0])

    def sample(self, params) -> Dict[str, np.ndarray]:
        params = params_from_numpy(params, device=self.device)
        T = self.rollout_len
        obs_buf = np.zeros((T, *np.shape(self.obs)), np.float32)
        act_buf = np.zeros((T,), np.int32)
        logp_buf = np.zeros((T,), np.float32)
        val_buf = np.zeros((T,), np.float32)
        rew_buf = np.zeros((T,), np.float32)
        term_buf = np.zeros((T,), np.float32)  # true termination: V(next)=0
        cut_buf = np.zeros((T,), np.float32)  # episode boundary: cut GAE
        next_val = np.zeros((T,), np.float32)  # V(s_{t+1}) within-episode

        for t in range(T):
            logits, value = self._apply(params, self.obs)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            action = int(self.rng.choice(len(p), p=p))
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = np.log(p[action] + 1e-12)
            val_buf[t] = value
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            rew_buf[t] = reward
            self._episode_return += float(reward)
            term_buf[t] = float(terminated)
            cut_buf[t] = float(terminated or truncated)
            if truncated and not terminated:
                # bootstrap the truncated episode with V of its real final
                # state — NOT the next episode's first state
                next_val[t] = self._apply(params, nxt)[1]
            if terminated or truncated:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                nxt, _ = self.env.reset()
            self.obs = nxt
            if t > 0 and cut_buf[t - 1] == 0.0:
                next_val[t - 1] = val_buf[t]

        # bootstrap value for the final (possibly mid-episode) state
        if cut_buf[T - 1] == 0.0:
            next_val[T - 1] = self._apply(params, self.obs)[1]

        adv = np.zeros((T,), np.float32)
        last_gae = 0.0
        for t in reversed(range(T)):
            delta = (
                rew_buf[t]
                + self.gamma * next_val[t] * (1.0 - term_buf[t])
                - val_buf[t]
            )
            last_gae = (
                delta + self.gamma * self.lam * (1.0 - cut_buf[t]) * last_gae
            )
            adv[t] = last_gae
        returns = adv + val_buf
        completed, self._completed = self._completed, []
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "advantages": adv,
            "returns": returns,
            "rewards": rew_buf,
            # within-episode V(x_{t+1}) — truncation steps carry the real
            # pre-reset state's value (computed above), terminals are masked
            # by consumers via `terminals`
            "next_values": next_val,
            "terminals": term_buf,  # true ends (bootstrap = 0)
            "cuts": cut_buf,  # any boundary (terminal OR truncation)
            "episode_returns": np.asarray(completed, np.float32),
        }
