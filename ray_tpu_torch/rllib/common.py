"""Shared plumbing for the RL algorithms (PyTorch port of
``ray_tpu/rllib/common.py``)."""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

import ray_tpu_torch as rt

logger = logging.getLogger(__name__)


def probe_env_spec(env_name: str) -> Tuple[int, int]:
    """(obs_dim, num_actions) for a discrete-action env (in-repo MinAtar
    names or gymnasium)."""
    from ray_tpu_torch.rllib.envs import make_env

    probe = make_env(env_name)
    try:
        if not hasattr(probe.action_space, "n"):
            raise ValueError(
                f"{env_name}: only discrete action spaces are supported"
            )
        return (
            int(np.prod(probe.observation_space.shape)),
            int(probe.action_space.n),
        )
    finally:
        probe.close()


def make_rollout_workers(env: str, num_workers: int, rollout_len: int,
                         gamma: float, lam: float, seed: int) -> List:
    """CPU env-runner actors; their policy forward runs on the CPU and they
    never touch a card (a CPU lease leaves every card visible to them)."""
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

    cls = rt.remote(num_cpus=1)(RolloutWorker)
    return [
        cls.remote(env, rollout_len, gamma, lam, seed=seed + 1000 * (i + 1),
                   device="cpu")
        for i in range(num_workers)
    ]


def stop_workers(workers: List) -> None:
    """Kill every actor; one that is already gone (or a session that is) is
    logged and the rest are still killed."""
    for w in workers:
        try:
            rt.kill(w)
        except Exception:  # noqa: BLE001 — teardown goes on past one actor
            logger.warning("could not kill %r", w, exc_info=True)
