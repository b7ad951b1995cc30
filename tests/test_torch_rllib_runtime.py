"""The RLlib port on the port's runtime, on the CPU: env-runner actors, the
learner in process (``device="cpu"``), and LearnerGroup over gloo learner
actors.

- ``LearnerGroup`` at dp 2 (two CPU learner actors joined by
  ``torch.distributed`` on gloo) equals dp 1 on the same batch, and dp 1
  equals the JAX package's dp 1 LearnerGroup (the reference's criterion,
  tests/test_rllib.py:252-281, with its tolerances).
- The port's counterparts of the reference's runtime RLlib tests
  (tests/test_rllib.py, test_appo.py, test_rllib_sac_ma.py and the RL half
  of test_offline_webdataset.py), with the same thresholds and the same
  ``slow`` marks: DQN on CartPole and IMPALA with two learners on MinAtar
  stay in tier 1, the learning runs of PPO, IMPALA, APPO, SAC and
  two-agent PPO are ``slow``, as there.

Every ``get`` and ``wait`` here, and in the algorithms, has a timeout.
"""

import functools

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt


@pytest.fixture
def rt_rl():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield rt
    rt.shutdown()


def _impala_batch(T=32):
    rng = np.random.default_rng(0)
    return {
        "obs": rng.random((2, T, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (2, T)).astype(np.int32),
        "logp": (-0.7 * np.ones((2, T))).astype(np.float32),
        "rewards": rng.random((2, T)).astype(np.float32),
        "next_values": rng.random((2, T)).astype(np.float32),
        "terminals": np.zeros((2, T), np.float32),
        "cuts": np.zeros((2, T), np.float32),
    }


def test_learner_group_dp2_matches_dp1(rt_rl):
    """The dp 2 update (two gloo learner actors, gradients all-reduced)
    gives the same loss and params as dp 1 on the same batch; dp 1 gives
    the JAX package's dp 1 update."""
    import jax
    import optax

    from ray_tpu.rllib.impala import IMPALAConfig as JConfig
    from ray_tpu.rllib.impala import make_impala_loss as jloss
    from ray_tpu.rllib.learner_group import LearnerGroup as JGroup
    from ray_tpu.rllib.models import init_actor_critic as jinit
    from ray_tpu_torch.rllib.impala import IMPALAConfig, make_impala_loss
    from ray_tpu_torch.rllib.learner_group import LearnerGroup

    jparams = jinit(jax.random.key(0), 4, 2, (32, 32))
    params = jax.tree.map(np.asarray, jparams)
    batch = _impala_batch()
    cfg = IMPALAConfig(rollout_len=32)
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    g1 = LearnerGroup(make_impala_loss(cfg), params, adam, num_learners=1,
                      device="cpu")
    g2 = LearnerGroup(make_impala_loss(cfg), params, adam, num_learners=2,
                      device="cpu")
    try:
        assert [i["device"] for i in g2.learner_info] == ["cpu", "cpu"]
        assert len({i["pid"] for i in g2.learner_info}) == 2
        l1 = g1.update(batch)
        l2 = g2.update(batch)
        assert abs(l1 - l2) < 1e-4 * max(1.0, abs(l1)), (l1, l2)
        p1, p2 = g1.get_params_host(), g2.get_params_host()
        for a, b in zip(jax.tree_util.tree_leaves(p1),
                        jax.tree_util.tree_leaves(p2)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        jg = JGroup(jloss(JConfig(rollout_len=32)), jparams,
                    optax.adam(1e-3), num_learners=1)
        jl = jg.update(batch)
        assert abs(l1 - jl) < 1e-4 * max(1.0, abs(jl)), (l1, jl)
        for a, b in zip(jax.tree_util.tree_leaves(p1),
                        jax.tree_util.tree_leaves(jg.get_params_host())):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    finally:
        g2.shutdown()


def test_impala_multi_learner_minatar(rt_rl):
    """IMPALA with num_learners=2 on the MinAtar proxy: updates run on two
    learner actors, env-steps accumulate, and the pipeline stays async."""
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = IMPALAConfig(
        env="MinAtar-Breakout", num_workers=2, num_learners=2,
        rollout_len=128, seed=1,
    ).build(device="cpu")
    try:
        for _ in range(3):
            m = algo.train()
        assert m["num_learners"] == 2
        assert m["num_async_updates"] >= 3
        assert m["num_env_steps"] >= 3 * 2 * 128
        assert np.isfinite(m["loss"])
    finally:
        algo.stop()


def test_dqn_cartpole_learns(rt_rl):
    from ray_tpu_torch.rllib import DQNConfig

    algo = DQNConfig(
        env="CartPole-v1",
        num_workers=2,
        rollout_len=256,
        learning_starts=512,
        train_batches=64,
        batch_size=64,
        lr=1e-3,
        eps_decay_steps=4000,
        target_update_freq=250,
        seed=0,
    ).build(device="cpu")
    best = -np.inf
    try:
        for _ in range(70):
            result = algo.train()
            mean = result["episode_reward_mean"]
            if np.isfinite(mean):
                best = max(best, mean)
            if best >= 150:
                break
        # DQN on CartPole: 150+ shows real learning (random play is ~20;
        # PPO owns the 450 bar)
        assert best >= 150, f"DQN plateaued at {best}"
    finally:
        algo.stop()


def test_experience_jsonl_roundtrip(rt_rl, tmp_path):
    from ray_tpu_torch.rllib.offline import (read_experience,
                                             write_experience_json)

    rows = [
        {"obs": [0.1 * i, -0.1 * i], "action": i % 3, "reward": 1.0,
         "done": i == 9}
        for i in range(10)
    ]
    path = str(tmp_path / "exp.jsonl")
    assert write_experience_json(rows, path) == 10
    back = read_experience(path).take_all()
    assert len(back) == 10
    assert back[3]["action"] == 0
    assert back[9]["done"] is True


def test_bc_clones_expert_policy(rt_rl, tmp_path):
    """The 'done' bar for the offline family: BC trained on expert logs
    reproduces the expert's actions and outperforms a random policy on
    the env."""
    from ray_tpu_torch.rllib.envs import make_env
    from ray_tpu_torch.rllib.offline import (
        BCConfig,
        collect_experience,
        read_experience,
        write_experience_json,
    )

    # expert for MinAtar-Breakout: track the ball with the paddle
    def expert(flat_obs):
        n = 10
        planes = flat_obs.reshape(3, n, n)
        paddle_cols = np.where(planes[0][n - 1] > 0)[0]
        ball = np.argwhere(planes[1] > 0)
        if len(ball) == 0 or len(paddle_cols) == 0:
            return 1
        bx = ball[0][1]
        px = int(paddle_cols.mean())
        return 0 if bx < px else (2 if bx > px else 1)

    rows = collect_experience("MinAtar-Breakout", expert, 3000, seed=0)
    path = str(tmp_path / "expert.jsonl")
    write_experience_json(rows, path)

    algo = BCConfig(seed=0).build(read_experience(path), device="cpu")
    for _ in range(15):
        m = algo.train()
    assert m["info"]["bc_loss"] < 0.25, m  # actions cloned

    # cloned policy ~matches the expert's env performance, beats random
    score = algo.evaluate("MinAtar-Breakout", episodes=5, seed=7)
    rng = np.random.default_rng(0)
    rand_score = 0.0
    env = make_env("MinAtar-Breakout")
    for ep in range(5):
        obs, _ = env.reset(seed=7 + ep)
        done = False
        while not done:
            obs, r, term, trunc, _ = env.step(int(rng.integers(3)))
            rand_score += float(r)
            done = term or trunc
    rand_score /= 5
    assert score > rand_score + 1.0, (score, rand_score)


# ------------------------------------------------- slow, as in the reference

@pytest.mark.slow  # learn-to-threshold run, slow in the reference too
def test_ppo_cartpole_reaches_450(rt_rl):
    from ray_tpu_torch.rllib import PPOConfig

    algo = PPOConfig(
        env="CartPole-v1",
        num_workers=2,
        rollout_len=1024,
        sgd_epochs=10,
        minibatch=256,
        lr=1e-3,
        seed=0,
    ).build(device="cpu")
    best = -np.inf
    try:
        for _ in range(80):
            result = algo.train()
            mean = result["episode_reward_mean"]
            if np.isfinite(mean):
                best = max(best, mean)
            if best >= 450:
                break
        assert best >= 450, f"PPO plateaued at {best}"
    finally:
        algo.stop()


@pytest.mark.slow  # learn-to-threshold run (see the note on the ppo test)
def test_impala_learns_cartpole_async(rt_rl):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = IMPALAConfig(
        env="CartPole-v1", num_workers=2, rollout_len=512, lr=6e-4, seed=0,
    ).build(device="cpu")
    best = -np.inf
    try:
        for _ in range(120):
            r = algo.train()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 300:
                break
        # IMPALA is noisier than PPO; 300+ on CartPole demonstrates learning
        assert best >= 300, f"IMPALA plateaued at {best}"
        # asynchrony: one update per completed rollout, no global barrier
        assert r["num_async_updates"] >= 2 * algo.config.num_workers
    finally:
        algo.stop()


@pytest.mark.slow
def test_appo_learns_cartpole_async(rt_rl):
    from ray_tpu_torch.rllib import APPOConfig

    algo = APPOConfig(
        env="CartPole-v1", num_workers=2, rollout_len=512, lr=6e-4,
        seed=0, clip_eps=0.3, num_sgd_epochs=2,
    ).build(device="cpu")
    best = -np.inf
    try:
        for _ in range(120):
            r = algo.train()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 300:
                break
        assert best >= 300, f"APPO plateaued at {best}"
        assert r["num_async_updates"] >= 2 * algo.config.num_workers
    finally:
        algo.stop()


@pytest.mark.slow
def test_sac_learns_point_goal(rt_rl):
    """The 'done' bar: SAC crosses a reward threshold a random policy
    cannot reach (random ~-40/episode on PointGoal2D; learned > -15)."""
    from ray_tpu_torch.rllib.sac import SACConfig

    algo = SACConfig(
        env="PointGoal2D-v0", num_workers=2, rollout_len=256,
        learning_starts=512, hidden=(64, 64), seed=0,
    ).build(device="cpu")
    try:
        best = -1e9
        for _ in range(40):
            m = algo.train()
            r = m["episode_reward_mean"]
            if np.isfinite(r):
                best = max(best, r)
            if best > -15.0:
                break
        assert best > -15.0, f"SAC plateaued at {best:.1f}"
    finally:
        algo.stop()


@pytest.mark.slow
def test_two_agent_ppo_learns(rt_rl):
    """2-agent PPO (per-agent policies) improves the team reward well
    past random (~-19/episode random; learned > -9)."""
    from ray_tpu_torch.rllib.multi_agent import MultiAgentPPOConfig

    algo = MultiAgentPPOConfig(
        env="TwoAgentTarget-v0",
        policy_mapping_fn=lambda aid: f"pol_{aid}",
        num_workers=2, rollout_len=384, sgd_epochs=6, seed=0,
    ).build(device="cpu")
    try:
        best = -1e9
        for _ in range(30):
            m = algo.train()
            r = m["episode_reward_mean"]
            if np.isfinite(r):
                best = max(best, r)
            if best > -9.0:
                break
        assert best > -9.0, f"multi-agent PPO plateaued at {best:.1f}"
        assert set(m["info"]) <= {"pol_a0", "pol_a1"}
    finally:
        algo.stop()
