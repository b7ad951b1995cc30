"""ray_tpu_torch.rllib — the RLlib-equivalent of the PyTorch port (CPU
sampling actors + a learner on the card).

    from ray_tpu_torch.rllib import PPOConfig
    algo = PPOConfig(env="CartPole-v1", num_workers=2).build()
    while algo.train()["episode_reward_mean"] < 450:
        ...

Parity: reference ``rllib/algorithms/ppo/``; sampling plane =
``rollout_worker.py`` env-runner actors on CPU leases (their policy
forward on the CPU; they never touch a card), learning plane = the
algorithm's update on its learner's device: ``Config.build(device=None)``,
CUDA by default, raising without a card (``device="cpu"`` asks for the
CPU). ``LearnerGroup`` spreads IMPALA's and APPO's update over learner
actors, one card each, joined by ``torch.distributed``.
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.learner_group import LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BC,
    BCConfig,
    collect_experience,
    read_experience,
    write_experience_json,
)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.sac import SAC, SACConfig  # noqa: F401

__all__ = ["APPO", "APPOConfig", "PPO", "PPOConfig", "IMPALA", "IMPALAConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "BC", "BCConfig", "MultiAgentEnv", "MultiAgentPPO",
           "MultiAgentPPOConfig", "LearnerGroup"]
