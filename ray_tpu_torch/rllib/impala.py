"""IMPALA: asynchronous sample pipelining with V-trace off-policy correction
(PyTorch port of ``ray_tpu/rllib/impala.py``).

Parity: reference ``rllib/algorithms/impala/impala.py:68`` (async sample
broker :685) — env-runner actors collect with (possibly stale) behavior
policies and never barrier with each other: the driver consumes whichever
rollout finishes first, updates the learner, ships fresh weights to THAT
worker only, and resubmits it. The importance-weight mismatch is corrected
by V-trace (Espeholt et al.; PAPERS.md): a reverse loop over T on tensors,
vectorised over the trajectories (the JAX package's reverse ``lax.scan``
under ``vmap``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.models import apply_actor_critic, init_actor_critic


def vtrace(
    behavior_logp,  # [..., T]
    target_logp,  # [..., T]
    rewards,  # [..., T]
    values,  # [..., T]  V(x_t)
    next_values,  # [..., T]  V(x_{t+1}) WITHIN-episode (truncations carry
    #                         the pre-reset state's value; rollout_worker
    #                         computes it)
    terminals,  # [..., T] 1.0 where the episode truly ENDED (no bootstrap)
    cuts,  # [..., T] 1.0 at any episode boundary (terminal OR truncation)
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
):
    """Returns (vs [..., T], pg_advantages [..., T]), over any leading
    (trajectory) dims. Truncated episodes bootstrap with their real
    next-state value (the recursion still cuts there); true terminals
    bootstrap with zero."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    boot = next_values * (1.0 - terminals)
    deltas = rho * (rewards + gamma * boot - values)
    cont = 1.0 - cuts  # the backward recursion never crosses a boundary
    acc = torch.zeros_like(deltas[..., 0])
    out = []
    for t in reversed(range(deltas.shape[-1])):
        acc = deltas[..., t] + gamma * c[..., t] * cont[..., t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1], dim=-1)
    # vs_{t+1}: the next step's corrected value inside an episode; the
    # bootstrap value at boundaries (zero if terminal)
    vs_next = torch.cat([vs[..., 1:], boot[..., -1:]], dim=-1)
    vs_next = torch.where(cuts > 0, boot, vs_next)
    pg_adv = rho * (rewards + gamma * vs_next - values)
    return vs, pg_adv


def forward_vtrace(params, batch, config):
    """Shared forward + V-trace block for the IMPALA-family losses
    (IMPALA's plain pg, APPO's clipped surrogate — appo.py): returns
    (target_logp, logp_all, values, vs, pg_adv) over [B, T]; vs and pg_adv
    carry no gradient."""
    c = config
    B, T = batch["actions"].shape
    obs = batch["obs"].reshape(B * T, -1)
    logits, values = apply_actor_critic(params, obs)
    logits = logits.reshape(B, T, -1)
    values = values.reshape(B, T)
    logp_all = F.log_softmax(logits, dim=-1)
    target_logp = logp_all.gather(
        -1, batch["actions"].long()[..., None])[..., 0]
    with torch.no_grad():
        vs, pg_adv = vtrace(
            batch["logp"], target_logp.detach(), batch["rewards"],
            values.detach(), batch["next_values"], batch["terminals"],
            batch["cuts"], c.gamma, c.rho_bar, c.c_bar,
        )
    return target_logp, logp_all, values, vs, pg_adv


def make_impala_loss(config: "IMPALAConfig"):
    """Batched IMPALA loss over [B, T] rollouts: V-trace over the
    trajectory axis, means over B*T — the leading axis is shardable, so
    the SAME loss runs on one learner or split across a LearnerGroup."""
    c = config

    def loss_fn(params, batch):
        target_logp, logp_all, values, vs, pg_adv = forward_vtrace(
            params, batch, c
        )
        pg = -(target_logp * pg_adv).mean()
        vf = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        return pg + c.vf_coef * vf - c.entropy_coef * entropy

    return loss_fn


@dataclasses.dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_workers: int = 2
    rollout_len: int = 256
    gamma: float = 0.99
    lr: float = 6e-4
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    rho_bar: float = 1.0
    c_bar: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    # learners in the data-parallel LearnerGroup; each update consumes
    # num_learners completed rollouts (reference: IMPALA multi-learner,
    # learner_group.py:61)
    num_learners: int = 1

    def build(self, device: DeviceLike = None) -> "IMPALA":
        """The algorithm, its learners on ``device``'s kind (CUDA by
        default: the caller's card for one learner, one card per learner
        actor for more)."""
        return IMPALA(self, device=device)


class IMPALA:
    """``algo.train()`` = consume asynchronously completed rollouts in
    groups of ``num_learners``, one data-parallel V-trace SGD step per
    group, weight refresh for the consumed workers."""

    def __init__(self, config: IMPALAConfig, device: DeviceLike = None):
        from ray_tpu_torch.rllib.common import (make_rollout_workers,
                                                probe_env_spec)
        from ray_tpu_torch.rllib.learner_group import LearnerGroup

        self.config = config
        self.device = resolve_device(device)
        if config.num_workers < config.num_learners:
            raise ValueError(
                "need num_workers >= num_learners (one rollout per learner "
                "shard per update)"
            )
        obs_dim, num_actions = probe_env_spec(config.env)
        params = init_actor_critic(config.seed, obs_dim, num_actions,
                                   config.hidden, device="cpu")
        self.learners = LearnerGroup(
            self._make_loss(), params,
            functools.partial(torch.optim.Adam, lr=config.lr),
            num_learners=config.num_learners, device=self.device,
        )
        self.workers = make_rollout_workers(
            config.env, config.num_workers, config.rollout_len,
            config.gamma, 1.0, config.seed,
        )
        # async pipeline state: one in-flight rollout per worker
        self._inflight: Dict[Any, int] = {}
        params_ref = rt.put(self.learners.get_params_host())
        for i, w in enumerate(self.workers):
            self._inflight[w.sample.remote(params_ref)] = i
        self._iter = 0
        self.num_async_updates = 0
        self.num_env_steps = 0
        self._recent: List[float] = []
        self.last_loss = float("nan")

    def _make_loss(self):
        """Loss factory hook (APPO overrides with the clipped surrogate)."""
        return make_impala_loss(self.config)

    def _update(self, batch: Dict[str, np.ndarray]) -> float:
        """One consumed group -> learner update(s); APPO loops epochs."""
        return self.learners.update(batch)

    def _stack(self, rollouts: List[Dict]) -> Dict[str, np.ndarray]:
        keys = ("obs", "actions", "logp", "rewards", "next_values",
                "terminals", "cuts")
        return {k: np.stack([r[k] for r in rollouts]) for k in keys}

    def train(self) -> Dict[str, Any]:
        """One iteration: ``(num_workers // num_learners) * num_learners``
        rollouts consumed, in groups of num_learners (whichever finish
        first — no global barrier; with non-divisible configs the
        remainder worker keeps sampling and is consumed next round)."""
        c = self.config
        self._iter += 1
        groups = max(1, c.num_workers // c.num_learners)
        for _ in range(groups):
            got, widxs = [], []
            try:
                while len(got) < c.num_learners:
                    ready, _ = rt.wait(
                        list(self._inflight),
                        num_returns=min(
                            c.num_learners - len(got), len(self._inflight)
                        ),
                        timeout=300,
                    )
                    if not ready:
                        raise TimeoutError(
                            "no rollout completed within 300s"
                        )
                    for ref in ready:
                        widxs.append(self._inflight.pop(ref))
                        got.append(rt.get(ref, timeout=300))
            except BaseException:
                # leave the pipeline retryable: resubmit any workers whose
                # rollouts were popped before the failure
                params_ref = rt.put(self.learners.get_params_host())
                for widx in widxs:
                    self._inflight[
                        self.workers[widx].sample.remote(params_ref)
                    ] = widx
                raise
            for rollout in got:
                self._recent.extend(rollout["episode_returns"].tolist())
                self.num_env_steps += len(rollout["actions"])
            self._recent = self._recent[-100:]
            self.last_loss = self._update(self._stack(got))
            self.num_async_updates += 1
            # refresh ONLY the consumed workers, resubmit them (async)
            params_ref = rt.put(self.learners.get_params_host())
            for widx in widxs:
                self._inflight[
                    self.workers[widx].sample.remote(params_ref)
                ] = widx
        return {
            "training_iteration": self._iter,
            "episode_reward_mean": (
                float(np.mean(self._recent)) if self._recent
                else float("nan")
            ),
            "num_async_updates": self.num_async_updates,
            "num_env_steps": self.num_env_steps,
            "loss": self.last_loss,
            "num_learners": c.num_learners,
        }

    def stop(self):
        from ray_tpu_torch.rllib.common import stop_workers

        stop_workers(self.workers)
        self.learners.shutdown()
