"""APPO: asynchronous PPO — IMPALA's pipeline with a clipped surrogate
(PyTorch port of ``ray_tpu/rllib/appo.py``).

Parity: reference ``rllib/algorithms/appo/appo.py`` (and the torch
learner's loss, ``appo_torch_learner.py``): the async rollout broker and
V-trace off-policy correction are IMPALA's (inherited unchanged); the
policy-gradient term swaps to PPO's clipped importance-ratio surrogate
on the V-trace advantages, and each consumed rollout group takes
``num_sgd_epochs`` SGD passes instead of one, in one
``LearnerGroup.update(..., epochs=)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, forward_vtrace


def make_appo_loss(config: "APPOConfig"):
    """PPO-clip surrogate over V-trace-corrected advantages ([B, T]);
    the forward + V-trace block is shared with IMPALA
    (impala.forward_vtrace) — only the pg term differs."""
    c = config

    def loss_fn(params, batch):
        target_logp, logp_all, values, vs, pg_adv = forward_vtrace(
            params, batch, c
        )
        # PPO clip on the importance ratio (vs the BEHAVIOR policy that
        # collected the rollout — later SGD epochs move the target away,
        # which is exactly what the clip bounds)
        ratio = torch.exp(target_logp - batch["logp"])
        clipped = torch.clamp(ratio, 1.0 - c.clip_eps, 1.0 + c.clip_eps)
        pg = -torch.minimum(ratio * pg_adv, clipped * pg_adv).mean()
        vf = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        return pg + c.vf_coef * vf - c.entropy_coef * entropy

    return loss_fn


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_eps: float = 0.3
    num_sgd_epochs: int = 2

    def build(self, device: DeviceLike = None) -> "APPO":
        return APPO(self, device=device)


class APPO(IMPALA):
    """IMPALA's async sample broker, PPO's update rule."""

    def _make_loss(self):
        return make_appo_loss(self.config)

    def _update(self, batch: Dict[str, np.ndarray]) -> float:
        # one host->device transfer + one loss sync for ALL epochs
        return self.learners.update(batch,
                                    epochs=self.config.num_sgd_epochs)
