"""The RLlib port (ray_tpu_torch/rllib/) against the JAX package's
(ray_tpu/rllib/) on the same numpy inputs, in process on the CPU.

Weights are the JAX package's own init, carried across as numpy
(``params_from_numpy``); the JAX losses are the reference's own (taken from
its update closures where they are not module-level). Tolerances (fp32):
forwards rtol 1e-5 (atol 1e-7, for outputs that cancel to near zero);
losses rtol 1e-5; gradients rtol 1e-4 / atol 1e-6;
parameters after one update and after K updates rtol 1e-5 / atol 1e-6.

Adam's first step moves each weight by about ±lr whatever its gradient's
size, so a gradient within float noise of zero could flip sign between the
packages and move a weight by up to 2·lr apart. The inputs here are
continuous draws (no exactly-zero feature), and each update test first
checks that no nonzero element of the JAX gradient at the start is within
1e-5 of its leaf's largest: float noise in a sum of B products is some
B·2^-24 of that largest (4e-6 at B = 64), so such an element could flip. Only then are the
parameters held to atol 1e-6. (An exactly-zero gradient is zero in both.)

Also here, the port's counterparts of the reference's in-process RLlib
tests (tests/test_rllib.py, test_appo.py, test_rllib_sac_ma.py), with the
same thresholds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import appo as japp
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import impala as jimp
from ray_tpu.rllib import models as jm
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.learner_group import LearnerGroup as JLearnerGroup
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rllib import appo as tapp
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import impala as timp
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib.learner_group import LearnerGroup

CPU = torch.device("cpu")
FWD_RTOL, FWD_ATOL = 1e-5, 1e-7
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
NOISE_FLOOR = 1e-5  # relative to the leaf's largest; module docstring


# ---------------------------------------------------------------- helpers

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(jtree):
    """A JAX tree -> the same tree of CPU tensors."""
    return params_from_numpy(_np(jtree), device="cpu")


def _trainable(jtree):
    return tm.trainable(_np(jtree), CPU)


def _assert_close(got, want, rtol, atol, path="params"):
    """``got`` (tensors or numpy) against ``want`` (a JAX or numpy tree),
    walked by key so that dict order does not matter."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], rtol, atol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, rtol, atol, f"{path}[{i}]")
    else:
        if isinstance(got, torch.Tensor):
            got = got.detach().numpy()
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol, err_msg=path)


def _grads(loss, params):
    """The gradient of ``loss`` as a tree shaped like ``params``."""
    gs = iter(tm.grads_of(loss, tm.tree_leaves(params)))
    return tm.tree_map(lambda _: next(gs), params)


def _clear_of_noise(jgrads):
    """The inputs' precondition: no nonzero JAX gradient element within
    NOISE_FLOOR of zero, relative to the largest of its leaf."""
    for g in jax.tree.leaves(jgrads):
        a = np.abs(np.asarray(g))
        near = (a > 0) & (a <= NOISE_FLOOR * a.max())
        assert not near.any(), (
            f"an input put a gradient within float noise of zero: {a[near]}"
            f" (leaf max {a.max()})")


def _closure(fn, name):
    """The reference's function ``name`` that ``fn`` closes over."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ inputs

def _ppo_batch(n, obs_dim, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp": (np.log(0.5) + 0.3 * rng.normal(size=n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }


def _vtrace_batch(B, T, obs_dim, seed):
    """[B, T] rollouts with truncations (cut, not terminal) and terminals."""
    rng = np.random.default_rng(seed)
    cuts = (rng.random((B, T)) < 0.15).astype(np.float32)
    terminals = cuts * (rng.random((B, T)) < 0.5)
    return {
        "obs": rng.normal(size=(B, T, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
        "logp": (np.log(0.5) + 0.5 * rng.normal(size=(B, T))
                 ).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "next_values": rng.normal(size=(B, T)).astype(np.float32),
        "terminals": terminals.astype(np.float32),
        "cuts": cuts,
    }


def _dqn_batches(S, bs, obs_dim, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(S, bs, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, (S, bs)).astype(np.int32),
        "rewards": rng.normal(size=(S, bs)).astype(np.float32),
        "next_obs": rng.normal(size=(S, bs, obs_dim)).astype(np.float32),
        "terminals": (rng.random((S, bs)) < 0.2).astype(np.float32),
    }


def _sac_batches(S, bs, obs_dim, act_dim, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(S, bs, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (S, bs, act_dim)).astype(np.float32),
        "rewards": rng.normal(size=(S, bs)).astype(np.float32),
        "next_obs": rng.normal(size=(S, bs, obs_dim)).astype(np.float32),
        "terminals": (rng.random((S, bs)) < 0.2).astype(np.float32),
    }


def _sac_noise(key, S, bs, act_dim):
    """The JAX update's draws: per step ``rng, k1, k2 = split(rng, 3)``, the
    critic's next action at normal(k1), the actor's at normal(k2)."""
    out = []
    for _ in range(S):
        key, k1, k2 = jax.random.split(key, 3)
        out.append([np.asarray(jax.random.normal(k1, (bs, act_dim))),
                    np.asarray(jax.random.normal(k2, (bs, act_dim)))])
    return torch.from_numpy(np.asarray(out, np.float32))


# ------------------------------------------------------------------ models

def test_actor_critic_forward_matches():
    params = jm.init_actor_critic(jax.random.key(0), 6, 3, (32, 16))
    obs = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    jl, jv = jm.apply_actor_critic(params, jnp.asarray(obs))
    tl, tv = tm.apply_actor_critic(_t(params), torch.from_numpy(obs))
    _assert_close(tl, jl, FWD_RTOL, FWD_ATOL)
    _assert_close(tv, jv, FWD_RTOL, FWD_ATOL)


def test_q_network_forward_matches():
    params = jm.init_q_network(jax.random.key(1), 5, 4, (16, 16))
    obs = np.random.default_rng(1).normal(size=(12, 5)).astype(np.float32)
    _assert_close(tm.apply_q_network(_t(params), torch.from_numpy(obs)),
                  jm.apply_q_network(params, jnp.asarray(obs)), FWD_RTOL, FWD_ATOL)


def test_sac_actor_and_critic_forward_match():
    params = jsac.init_sac_networks(jax.random.key(2), 4, 2, (32, 32))
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(9, 4)).astype(np.float32)
    act = rng.uniform(-1, 1, (9, 2)).astype(np.float32)
    tp = _t(params)
    jmu, jls = jsac.apply_actor(params, jnp.asarray(obs))
    tmu, tls = tsac.apply_actor(tp, torch.from_numpy(obs))
    _assert_close(tmu, jmu, FWD_RTOL, FWD_ATOL)
    _assert_close(tls, jls, FWD_RTOL, FWD_ATOL)
    for key in ("q1", "q2"):
        _assert_close(
            tsac.apply_critic(tp, key, torch.from_numpy(obs),
                              torch.from_numpy(act)),
            jsac.apply_critic(params, key, jnp.asarray(obs),
                              jnp.asarray(act)), FWD_RTOL, FWD_ATOL)


def test_params_cross_both_ways_and_init_is_seeded():
    """Lists of layers cross through convert; one seed gives one init."""
    params = jm.init_actor_critic(jax.random.key(0), 4, 2)
    back = params_to_numpy(_t(params))
    _assert_close(back, params, 0, 0)
    a = tm.init_actor_critic(7, 4, 2, device="cpu")
    b = tm.init_actor_critic(torch.Generator().manual_seed(7), 4, 2,
                             device="cpu")
    _assert_close(a, params_to_numpy(b), 0, 0)
    assert tm.tree_map(lambda t: tuple(t.shape), a) == jax.tree.map(
        lambda x: tuple(x.shape), params)


# ------------------------------------------------------ losses, gradients

def _jax_ppo(cfg):
    shell = object.__new__(jppo.PPO)
    shell.config = cfg
    shell.opt = optax.adam(cfg.lr)
    return shell._make_update()


def test_ppo_loss_and_grads_match():
    cfg = jppo.PPOConfig()
    params = jm.init_actor_critic(jax.random.key(0), 4, 2, (16, 16))
    batch = _ppo_batch(64, 4, 0)
    loss_fn = _closure(_jax_ppo(cfg), "loss_fn")
    (jl, jaux), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        params, _jb(batch))
    tp = _trainable(params)
    tl, taux = tppo.ppo_loss(tp, _tb(batch), cfg)
    _assert_close(tl, jl, LOSS_RTOL, 0)
    _assert_close(taux, jaux, LOSS_RTOL, 0)
    _assert_close(_grads(tl, tp), jg, GRAD_RTOL, GRAD_ATOL)


def test_vtrace_matches_over_truncations_and_terminals():
    b = _vtrace_batch(3, 24, 4, 1)
    rng = np.random.default_rng(5)
    target = (b["logp"] + 0.4 * rng.normal(size=b["logp"].shape)
              ).astype(np.float32)
    values = rng.normal(size=b["logp"].shape).astype(np.float32)
    args = (b["logp"], target, b["rewards"], values, b["next_values"],
            b["terminals"], b["cuts"])
    assert b["cuts"].sum() > 0 and b["terminals"].sum() > 0
    assert (b["cuts"] > b["terminals"]).any()  # a truncation, not an end
    jvs, jpg = jax.vmap(lambda *a: jimp.vtrace(*a, 0.9, 1.0, 1.0))(
        *map(jnp.asarray, args))
    tvs, tpg = timp.vtrace(*map(torch.from_numpy, args), 0.9, 1.0, 1.0)
    _assert_close(tvs, jvs, LOSS_RTOL, 1e-6)
    _assert_close(tpg, jpg, LOSS_RTOL, 1e-6)


def test_forward_vtrace_matches():
    cfg = jimp.IMPALAConfig(gamma=0.95)
    params = jm.init_actor_critic(jax.random.key(3), 4, 2, (16,))
    b = _vtrace_batch(2, 16, 4, 2)
    jout = jimp.forward_vtrace(params, _jb(b), cfg)
    tout = timp.forward_vtrace(_t(params), _tb(b), cfg)
    for got, want in zip(tout, jout):
        _assert_close(got, want, LOSS_RTOL, 1e-6)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_and_appo_losses_and_grads_match(algo):
    cfg = (japp.APPOConfig(clip_eps=0.2) if algo == "appo"
           else jimp.IMPALAConfig())
    jloss = (japp.make_appo_loss if algo == "appo"
             else jimp.make_impala_loss)(cfg)
    tloss = (tapp.make_appo_loss if algo == "appo"
             else timp.make_impala_loss)(cfg)
    params = jm.init_actor_critic(jax.random.key(4), 4, 2, (16, 16))
    b = _vtrace_batch(2, 16, 4, 3)
    jl, jg = jax.value_and_grad(jloss)(params, _jb(b))
    tp = _trainable(params)
    tl = tloss(tp, _tb(b))
    _assert_close(tl, jl, LOSS_RTOL, 0)
    _assert_close(_grads(tl, tp), jg, GRAD_RTOL, GRAD_ATOL)


def _jax_dqn(cfg):
    shell = object.__new__(jdqn.DQN)
    shell.config = cfg
    shell.opt = optax.adam(cfg.lr)
    return shell._make_update()


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_td_loss_and_grads_match(double_q):
    cfg = jdqn.DQNConfig(double_q=double_q)
    params = jm.init_q_network(jax.random.key(5), 4, 2, (16, 16))
    target = jm.init_q_network(jax.random.key(6), 4, 2, (16, 16))
    mb = {k: v[0] for k, v in _dqn_batches(1, 32, 4, 4).items()}
    td = _closure(_jax_dqn(cfg), "td_loss")
    jl, jg = jax.value_and_grad(td)(params, target, _jb(mb))
    tp = _trainable(params)
    tl = tdqn.td_loss(tp, _t(target), _tb(mb), cfg)
    _assert_close(tl, jl, LOSS_RTOL, 0)
    _assert_close(_grads(tl, tp), jg, GRAD_RTOL, GRAD_ATOL)


def _jax_sac(cfg, target_entropy):
    shell = object.__new__(jsac.SAC)
    shell.config = cfg
    shell.target_entropy = target_entropy
    shell.opt = optax.adam(cfg.lr)
    shell.alpha_opt = optax.adam(cfg.alpha_lr)
    return shell._make_update()


def test_sac_losses_and_grads_match_with_injected_noise():
    cfg = jsac.SACConfig(hidden=(32,))
    params = jsac.init_sac_networks(jax.random.key(7), 4, 2, cfg.hidden)
    target = {"q1": params["q1"], "q2": params["q2"]}
    log_alpha = jnp.asarray(0.3, jnp.float32)
    mb = {k: v[0] for k, v in _sac_batches(1, 32, 4, 2, 5).items()}
    update = _jax_sac(cfg, -2.0)
    critic_loss = _closure(update, "critic_loss")
    actor_loss = _closure(update, "actor_loss")
    k1, k2 = jax.random.split(jax.random.key(8))
    n1 = jax.random.normal(k1, (32, 2))
    n2 = jax.random.normal(k2, (32, 2))
    jcl, jcg = jax.value_and_grad(critic_loss)(params, target, log_alpha,
                                               _jb(mb), k1)
    (jal, jlogp), jag = jax.value_and_grad(actor_loss, has_aux=True)(
        params, log_alpha, _jb(mb), k2)
    jalpha_grad = jax.grad(lambda la: -(
        la * jax.lax.stop_gradient(jlogp - 2.0)).mean())(log_alpha)

    tp = _trainable(params)
    tla = torch.tensor(0.3)
    tmb = _tb(mb)
    tcl = tsac.critic_loss(tp, _t(target), tla, tmb,
                           torch.from_numpy(np.array(n1)), cfg)
    tal, tlogp = tsac.actor_loss(tp, tla, tmb,
                                 torch.from_numpy(np.array(n2)))
    _assert_close(tcl, jcl, LOSS_RTOL, 0)
    _assert_close(tal, jal, LOSS_RTOL, 0)
    _assert_close(tlogp, jlogp, LOSS_RTOL, 1e-6)
    _assert_close(_grads(tcl, tp), jcg, GRAD_RTOL, GRAD_ATOL)
    _assert_close(_grads(tal, tp), jag, GRAD_RTOL, GRAD_ATOL)
    # the temperature's gradient, as sac_update sets it
    _assert_close(-(tlogp.detach() - 2.0).mean(), jalpha_grad,
                  GRAD_RTOL, GRAD_ATOL)


def test_bc_loss_and_grads_match():
    params = jm.init_actor_critic(jax.random.key(9), 6, 3, (16, 16))
    rng = np.random.default_rng(6)
    mb = {"obs": rng.normal(size=(40, 6)).astype(np.float32),
          "actions": rng.integers(0, 3, 40).astype(np.int32)}
    shell = object.__new__(joff.BC)
    shell.opt = optax.adam(1e-3)
    loss_fn = _closure(shell._make_update(), "loss_fn")
    jl, jg = jax.value_and_grad(loss_fn)(params, _jb(mb))
    tp = _trainable(params)
    tl = toff.bc_loss(tp, _tb(mb))
    _assert_close(tl, jl, LOSS_RTOL, 0)
    _assert_close(_grads(tl, tp), jg, GRAD_RTOL, GRAD_ATOL)


# ------------------------------------------------- whole updates, 1 and K

def test_ppo_update_matches_one_and_k_updates():
    cfg = jppo.PPOConfig(sgd_epochs=2, minibatch=16, lr=3e-4)
    params = jm.init_actor_critic(jax.random.key(0), 4, 2, (16, 16))
    update = jax.jit(_jax_ppo(cfg))
    opt = optax.adam(cfg.lr)
    jp, js = params, opt.init(params)
    tp = _trainable(params)
    topt = tm.adam(tp, cfg.lr)
    key = jax.random.key(11)
    for k in range(3):
        batch = _ppo_batch(64, 4, 20 + k)
        if k == 0:
            loss_fn = _closure(_jax_ppo(cfg), "loss_fn")
            _clear_of_noise(jax.grad(lambda p: loss_fn(p, _jb(batch))[0])(jp))
        key, sub = jax.random.split(key)
        perms = np.stack([np.asarray(jax.random.permutation(kk, 64))
                          for kk in jax.random.split(sub, cfg.sgd_epochs)])
        jp, js, jaux = update(jp, js, sub, _jb(batch))
        taux = tppo.ppo_update(tp, topt, _tb(batch),
                               torch.from_numpy(perms), cfg)
        _assert_close(taux, jaux, 1e-4, 1e-6)
        _assert_close(tp, jp, PARAM_RTOL, PARAM_ATOL, f"params after {k + 1}")


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_learner_group_update_matches_one_and_k_updates(algo):
    """IMPALA's one-learner update (and APPO's, two epochs a call) against
    the JAX package's dp 1 LearnerGroup."""
    cfg = (japp.APPOConfig() if algo == "appo" else jimp.IMPALAConfig())
    epochs = cfg.num_sgd_epochs if algo == "appo" else 1
    jloss = (japp.make_appo_loss if algo == "appo"
             else jimp.make_impala_loss)(cfg)
    tloss = (tapp.make_appo_loss if algo == "appo"
             else timp.make_impala_loss)(cfg)
    params = jm.init_actor_critic(jax.random.key(12), 4, 2, (16, 16))
    batches = [_vtrace_batch(2, 16, 4, 30 + k) for k in range(3)]
    _clear_of_noise(jax.grad(jloss)(params, _jb(batches[0])))
    jg = JLearnerGroup(jloss, params, optax.adam(cfg.lr), num_learners=1)
    tg = LearnerGroup(tloss, _np(params),
                      functools.partial(torch.optim.Adam, lr=cfg.lr),
                      num_learners=1, device="cpu")
    for k, b in enumerate(batches):
        jl = jg.update(b, epochs=epochs)
        tl = tg.update(b, epochs=epochs)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
        _assert_close(tg.get_params_host(), jg.get_params_host(),
                      PARAM_RTOL, PARAM_ATOL, f"params after {k + 1}")


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_with_target_syncs(double_q):
    cfg = jdqn.DQNConfig(double_q=double_q, target_update_freq=2)
    params = jm.init_q_network(jax.random.key(13), 4, 2, (16, 16))
    target = jax.tree.map(lambda x: x, params)
    update = jax.jit(_jax_dqn(cfg))
    opt = optax.adam(cfg.lr)
    jp, jt, js, jstep = params, target, opt.init(params), 0
    tp = _trainable(params)
    tt = _t(target)
    topt = tm.adam(tp, cfg.lr)
    tstep = 0
    for k in range(3):
        b = _dqn_batches(3, 32, 4, 40 + k)  # 3 steps: syncs at 2, 4, 6
        if k == 0:
            td = _closure(_jax_dqn(cfg), "td_loss")
            _clear_of_noise(jax.grad(td)(
                jp, jt, {kk: jnp.asarray(v[0]) for kk, v in b.items()}))
        jp, jt, js, jstep, jl = update(jp, jt, js,
                                       jnp.asarray(jstep, jnp.int32), _jb(b))
        tstep, tl = tdqn.dqn_update(tp, tt, topt, tstep, _tb(b), cfg)
        assert tstep == int(jstep) == 3 * (k + 1)
        _assert_close(tl, jl, 1e-4, 1e-6)
        _assert_close(tp, jp, PARAM_RTOL, PARAM_ATOL, f"params after {k + 1}")
        _assert_close(tt, jt, PARAM_RTOL, PARAM_ATOL, f"target after {k + 1}")


def _sac_both(S, seed_key):
    cfg = jsac.SACConfig(train_batches=S, batch_size=32, hidden=(32,))
    params = jsac.init_sac_networks(jax.random.key(seed_key), 4, 2,
                                    cfg.hidden)
    jstate = [params, {"q1": params["q1"], "q2": params["q2"]},
              jnp.zeros(()), optax.adam(cfg.lr).init(params),
              optax.adam(cfg.alpha_lr).init(jnp.zeros(()))]
    tstate = tsac.init_sac_state(cfg, 4, 2, CPU, params=_np(params))
    return cfg, jstate, tstate


def _sac_step_both(cfg, update, jstate, tstate, batches, key):
    S = cfg.train_batches
    *jstate, jcl, jal = update(*jstate, key, _jb(batches))
    tcl, tal = tsac.sac_update(tstate, _tb(batches),
                               _sac_noise(key, S, 32, 2), cfg, -2.0)
    _assert_close(tcl, jcl, 1e-4, 1e-6)
    _assert_close(tal, jal, 1e-4, 1e-6)
    return jstate


def test_sac_update_matches_one_and_k_updates():
    cfg, jstate, tstate = _sac_both(4, 14)
    update = jax.jit(_jax_sac(cfg, -2.0))
    for k in range(3):
        b = _sac_batches(4, 32, 4, 2, 50 + k)
        jstate = _sac_step_both(cfg, update, jstate, tstate, b,
                                jax.random.key(60 + k))
        where = f"after {k + 1}"
        _assert_close(tstate["params"], jstate[0], PARAM_RTOL, PARAM_ATOL,
                      f"params {where}")
        _assert_close(tstate["target_q"], jstate[1], PARAM_RTOL, PARAM_ATOL,
                      f"targets {where}")
        _assert_close(tstate["log_alpha"], jstate[2], PARAM_RTOL, PARAM_ATOL,
                      f"log_alpha {where}")


def test_sac_steps_one_adam_over_masked_gradients():
    """The reference steps ONE Adam over {pi, q1, q2}: the critics take the
    critic loss's gradient only, the actor the actor loss's only. The actor
    loss does reach the critics here (the masking matters), one optimizer
    holds every leaf, and one step equals the JAX package's."""
    cfg, jstate, tstate = _sac_both(1, 15)
    b = _sac_batches(1, 32, 4, 2, 70)
    key = jax.random.key(71)
    noise = _sac_noise(key, 1, 32, 2)
    tp = tstate["params"]
    mb = {k: v[0] for k, v in _tb(b).items()}
    aloss, _ = tsac.actor_loss(tp, torch.zeros(()), mb, noise[0, 1])
    leak = torch.autograd.grad(aloss, tm.tree_leaves(tp["q1"]))
    assert max(float(g.abs().max()) for g in leak) > 1e-3
    grads, *_ = tsac.sac_grads(tp, tstate["target_q"], tstate["log_alpha"],
                               mb, noise[0], cfg)
    assert len(grads) == len(tm.tree_leaves(tp))
    jstate = _sac_step_both(cfg, jax.jit(_jax_sac(cfg, -2.0)), jstate,
                            tstate, b, key)
    opt = tstate["opt"]
    assert [p for g in opt.param_groups for p in g["params"]] == \
        tm.tree_leaves(tp)
    assert len(opt.state) == len(tm.tree_leaves(tp))
    _assert_close(tstate["params"], jstate[0], PARAM_RTOL, PARAM_ATOL)


def test_bc_update_matches_k_minibatches():
    cfg = joff.BCConfig(lr=1e-3)
    params = jm.init_actor_critic(jax.random.key(16), 6, 3, (16, 16))
    shell = object.__new__(joff.BC)
    shell.opt = optax.adam(cfg.lr)
    update = jax.jit(shell._make_update())
    rng = np.random.default_rng(8)
    batches = {"obs": rng.normal(size=(5, 32, 6)).astype(np.float32),
               "actions": rng.integers(0, 3, (5, 32)).astype(np.int32)}
    loss_fn = _closure(shell._make_update(), "loss_fn")
    _clear_of_noise(jax.grad(loss_fn)(
        params, {k: jnp.asarray(v[0]) for k, v in batches.items()}))
    jp, _, jl = update(params, shell.opt.init(params), _jb(batches))
    tp = _trainable(params)
    tl = toff.bc_update(tp, tm.adam(tp, cfg.lr), _tb(batches))
    _assert_close(tl, jl, 1e-4, 1e-6)
    _assert_close(tp, jp, PARAM_RTOL, PARAM_ATOL)


# ---------------------------------------------------------- env runners

@pytest.mark.parametrize("env", ["CartPole-v1", "MinAtar-Breakout"])
def test_rollout_worker_sample_matches(env):
    """Same env, seed and weights: equal actions, and logp, values,
    advantages and returns within 1e-5."""
    from ray_tpu.rllib.rollout_worker import RolloutWorker as JWorker
    from ray_tpu_torch.rllib.common import probe_env_spec
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

    obs_dim, n_act = probe_env_spec(env)
    params = _np(jm.init_actor_critic(jax.random.key(3), obs_dim, n_act))
    jw = JWorker(env, rollout_len=64, gamma=0.99, lam=0.95, seed=3)
    tw = RolloutWorker(env, rollout_len=64, gamma=0.99, lam=0.95, seed=3,
                       device="cpu")
    for _ in range(2):  # the second sample continues the episodes
        jb, tb = jw.sample(params), tw.sample(params)
        assert set(jb) == set(tb)
        np.testing.assert_array_equal(tb["actions"], jb["actions"])
        for k in ("obs", "rewards", "terminals", "cuts", "episode_returns"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        for k in ("logp", "advantages", "returns", "next_values"):
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_multi_agent_rollout_worker_sample_matches():
    from ray_tpu.rllib.multi_agent import MultiAgentRolloutWorker as JWorker
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    mapping = {"a0": "p0", "a1": "p1"}
    params = {p: _np(jm.init_actor_critic(jax.random.key(i), 2, 3, (16,)))
              for i, p in enumerate(["p0", "p1"])}
    jout = JWorker("TwoAgentTarget-v0", 48, 0.99, 0.95, mapping,
                   seed=0).sample(params)
    tout = MultiAgentRolloutWorker("TwoAgentTarget-v0", 48, 0.99, 0.95,
                                   mapping, seed=0,
                                   device="cpu").sample(params)
    for pol in ("p0", "p1"):
        jb, tb = jout["batches"][pol], tout["batches"][pol]
        np.testing.assert_array_equal(tb["actions"], jb["actions"])
        for k in ("logp", "advantages", "returns"):
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(tout["episode_returns"],
                               jout["episode_returns"], rtol=1e-6)


# ------------------------- the reference's in-process tests, on the port

def test_rollout_worker_batch_shapes():
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

    w = RolloutWorker("CartPole-v1", rollout_len=64, gamma=0.99, lam=0.95,
                      seed=3, device="cpu")
    params = params_to_numpy(tm.init_actor_critic(0, 4, 2, device="cpu"))
    b = w.sample(params)
    assert b["obs"].shape == (64, 4)
    assert b["actions"].shape == (64,)
    assert np.isfinite(b["advantages"]).all()
    # returns = advantages + values => finite and correlated with rewards
    assert np.isfinite(b["returns"]).all()


def test_vtrace_matches_manual():
    """3-step hand computation of the V-trace targets."""
    gamma = 0.9
    values = torch.tensor([1.0, 2.0, 3.0])
    next_values = torch.tensor([2.0, 3.0, 4.0])  # within-episode V(x_{t+1})
    rewards = torch.tensor([1.0, 1.0, 1.0])
    zeros = torch.zeros(3)
    # on-policy (ratios = 1), no boundaries: V-trace reduces to n-step TD
    vs, pg = timp.vtrace(zeros, zeros, rewards, values, next_values,
                         zeros, zeros, gamma)
    deltas = np.array([
        1.0 + gamma * 2.0 - 1.0,
        1.0 + gamma * 3.0 - 2.0,
        1.0 + gamma * 4.0 - 3.0,
    ])
    acc2 = deltas[2]
    acc1 = deltas[1] + gamma * acc2
    acc0 = deltas[0] + gamma * acc1
    np.testing.assert_allclose(
        vs.numpy(), np.array([1, 2, 3]) + np.array([acc0, acc1, acc2]),
        rtol=1e-6,
    )
    # a LESS likely action under the target policy shrinks the correction
    lower = torch.full((3,), -1.0)  # target logp < behavior logp
    vs2, _ = timp.vtrace(zeros, lower, rewards, values, next_values,
                         zeros, zeros, gamma)
    assert abs(float(vs2[0] - 1.0)) < abs(float(vs[0] - 1.0))
    # truncation at t=1 (cut, NOT terminal): recursion cuts there but the
    # delta still bootstraps with next_values[1]
    cuts = torch.tensor([0.0, 1.0, 0.0])
    vs3, _ = timp.vtrace(zeros, zeros, rewards, values, next_values,
                         zeros, cuts, gamma)
    np.testing.assert_allclose(
        float(vs3[1]), 2.0 + deltas[1], rtol=1e-6  # no tail beyond the cut
    )
    # true terminal at t=1: bootstrap is zeroed
    terms = torch.tensor([0.0, 1.0, 0.0])
    vs4, _ = timp.vtrace(zeros, zeros, rewards, values, next_values,
                         terms, cuts, gamma)
    np.testing.assert_allclose(float(vs4[1]), 2.0 + (1.0 - 2.0), rtol=1e-6)


def test_dqn_replay_and_update_shapes():
    """Learner-only smoke: replay buffer cycling + one update."""
    buf = tdqn._ReplayBuffer(capacity=100, obs_dim=4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        buf.add_batch({
            "obs": rng.normal(size=(60, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, 60).astype(np.int32),
            "rewards": rng.normal(size=60).astype(np.float32),
            "next_obs": rng.normal(size=(60, 4)).astype(np.float32),
            "terminals": (rng.random(60) < 0.1).astype(np.float32),
        })
    assert buf.size == 100  # capacity-clamped circular buffer
    mb = buf.sample(rng, 32)
    assert mb["obs"].shape == (32, 4)

    cfg = tdqn.DQNConfig(train_batches=4, batch_size=16,
                         target_update_freq=2)
    params = tm.trainable(tm.init_q_network(0, 4, 2, device="cpu"), CPU)
    target = tm.tree_map(lambda x: x.detach().clone(), params)
    batches = tm.to_device(
        {k: np.stack([buf.sample(rng, 16)[k] for _ in range(4)])
         for k in mb}, CPU)
    step, loss = tdqn.dqn_update(params, target, tm.adam(params, 1e-3), 0,
                                 batches, cfg)
    assert step == 4 and np.isfinite(float(loss))
    # target synced at steps 2 and 4 (freq=2): equals the online params
    assert all(torch.allclose(a, b) for a, b in
               zip(tm.tree_leaves(params), tm.tree_leaves(target)))


def test_minatar_breakout_env():
    """In-repo Atari proxy: deterministic physics, reward on brick hits,
    termination on a missed ball."""
    from ray_tpu_torch.rllib.envs import MinAtarBreakout, make_env

    env = make_env("MinAtar-Breakout")
    assert isinstance(env, MinAtarBreakout)
    obs, _ = env.reset(seed=3)
    assert obs.shape == (300,) and obs.dtype == np.float32
    assert obs.sum() >= 2  # paddle + ball + bricks present
    total_r, steps, terminated = 0.0, 0, False
    while steps < 500 and not terminated:
        # trivial tracking policy: move paddle toward the ball
        planes = obs.reshape(3, 10, 10)
        ball_x = int(planes[1].sum(axis=0).argmax())
        # paddle CENTER (the plane shows the 3-cell-wide paddle)
        paddle_x = int(round(float(np.mean(np.nonzero(planes[0][9])[0]))))
        a = 2 if ball_x > paddle_x else (0 if ball_x < paddle_x else 1)
        obs, r, terminated, truncated, _ = env.step(a)
        total_r += r
        steps += 1
        if truncated:
            break
    assert total_r > 0, "tracking policy never hit a brick"

    # a stationary paddle loses the ball -> termination
    env2 = make_env("MinAtar-Breakout")
    env2.reset(seed=5)
    done = False
    for _ in range(200):
        _, _, done, trunc, _ = env2.step(1)
        if done or trunc:
            break
    assert done, "ball never missed a frozen paddle"


def test_appo_clip_bounds_the_surrogate():
    """With a positive advantage and a ratio far above 1+eps, the pg
    term must be the CLIPPED value (gradient w.r.t. ratio is zero)."""
    eps, adv = 0.3, 2.0

    def pg_term(logp_new, logp_old):
        ratio = torch.exp(logp_new - logp_old)
        clipped = torch.clamp(ratio, 1.0 - eps, 1.0 + eps)
        return -torch.minimum(ratio * adv, clipped * adv)

    # ratio = e^1 ~ 2.7 >> 1.3: clipped branch wins, zero gradient
    x = torch.tensor(1.0, requires_grad=True)
    val = pg_term(x, torch.tensor(0.0))
    (grad,) = torch.autograd.grad(val, x)
    np.testing.assert_allclose(float(val.detach()), -(1.0 + eps) * adv,
                               rtol=1e-6)
    assert float(grad) == 0.0
    # small ratio move: unclipped branch, non-zero gradient
    x2 = torch.tensor(0.05, requires_grad=True)
    (grad2,) = torch.autograd.grad(pg_term(x2, torch.tensor(0.0)), x2)
    assert float(grad2) != 0.0


def test_appo_clip_eps_engages_on_stale_batch():
    """Same stale-logp batch: the loss at a tight clip_eps must differ
    from the loss at an effectively-infinite clip_eps — proving the
    clip itself (not just the surrogate form) shapes the objective."""
    cfg = tapp.APPOConfig(hidden=(16,), clip_eps=0.2)
    params = tm.init_actor_critic(0, 4, 2, (16,), device="cpu")
    rng = np.random.RandomState(0)
    B, T = 2, 8
    batch = {
        "obs": torch.tensor(rng.randn(B, T, 4), dtype=torch.float32),
        "actions": torch.tensor(rng.randint(0, 2, (B, T))),
        # stale behavior logp -> ratios well away from 1
        "logp": torch.full((B, T), -2.5),
        "rewards": torch.ones(B, T),
        "next_values": torch.zeros(B, T),
        "terminals": torch.zeros(B, T),
        "cuts": torch.zeros(B, T),
    }
    tight = float(tapp.make_appo_loss(cfg)(params, batch))
    loose = float(tapp.make_appo_loss(
        dataclasses.replace(cfg, clip_eps=1e9))(params, batch))
    assert np.isfinite(tight) and np.isfinite(loose)
    assert tight != loose  # the clip actually engaged


def test_squashed_gaussian_logp_matches_numeric():
    """logp of the tanh-squashed Gaussian matches a numerical check of
    the change-of-variables formula."""
    mu = torch.tensor([[0.3, -1.2]])
    log_std = torch.tensor([[-0.5, 0.1]])
    noise = torch.randn(1, 2, generator=torch.Generator().manual_seed(0))
    a, logp = tsac.sample_squashed(noise, mu, log_std)
    assert a.shape == (1, 2) and bool(torch.all(torch.abs(a) < 1.0))
    # recompute: u = atanh(a); logp = N(u) - sum log(1 - a^2)
    u = torch.atanh(torch.clamp(a, -1 + 1e-6, 1 - 1e-6))
    std = torch.exp(log_std)
    logp_u = (
        -0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                + np.log(2 * np.pi))
    ).sum(-1)
    expected = logp_u - torch.log(1 - a**2 + 1e-9).sum(-1)
    np.testing.assert_allclose(logp.numpy(), expected.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_point_goal_env_api():
    from ray_tpu_torch.rllib.envs import make_env

    env = make_env("PointGoal2D-v0")
    obs, _ = env.reset(seed=0)
    assert obs.shape == (4,)
    total = 0.0
    for _ in range(env.MAX_STEPS):
        obs, r, term, trunc, _ = env.step(np.array([0.5, -0.5]))
        total += r
        assert not term
    assert trunc  # fixed-horizon truncation
    assert total < 0.0  # distance-penalty reward


def test_sac_update_step_runs_and_targets_move():
    """One update: losses finite, polyak targets move toward the online
    critics, alpha adapts."""
    cfg = tsac.SACConfig(num_workers=0, train_batches=4, batch_size=32,
                         hidden=(32,), seed=0)
    state = tsac.init_sac_state(cfg, 4, 2, CPU)
    rng = np.random.default_rng(0)
    batches = {
        "obs": torch.tensor(rng.random((4, 32, 4), np.float32)),
        "actions": torch.tensor(
            rng.uniform(-1, 1, (4, 32, 2)).astype(np.float32)),
        "rewards": torch.tensor(rng.random((4, 32), np.float32)),
        "next_obs": torch.tensor(rng.random((4, 32, 4), np.float32)),
        "terminals": torch.zeros((4, 32)),
    }
    before = state["target_q"]["q1"][0]["w"].clone()
    noise = torch.randn(4, 2, 32, 2, generator=torch.Generator().manual_seed(1))
    closs, aloss = tsac.sac_update(state, batches, noise, cfg, -2.0)
    assert np.isfinite(float(closs)) and np.isfinite(float(aloss))
    after = state["target_q"]["q1"][0]["w"]
    assert not torch.allclose(before, after)  # polyak moved
    assert float(state["log_alpha"].detach()) != 0.0  # temperature adapted


def test_two_agent_env_api():
    from ray_tpu_torch.rllib.envs import make_env

    env = make_env("TwoAgentTarget-v0")
    obs, _ = env.reset(seed=1)
    assert set(obs) == {"a0", "a1"}
    obs, rew, term, trunc, _ = env.step({"a0": 2, "a1": 0})
    assert set(rew) == {"a0", "a1"}
    assert term["__all__"] is False
    for _ in range(env.N_STEPS):
        obs, rew, term, trunc, _ = env.step({"a0": 1, "a1": 1})
    assert trunc["__all__"] is True


def test_multi_agent_rollout_per_policy_batches():
    """Agents mapped to DIFFERENT policies produce separate batches;
    shared mapping merges them (parameter sharing)."""
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

    w = MultiAgentRolloutWorker(
        "TwoAgentTarget-v0", rollout_len=48, gamma=0.99, lam=0.95,
        policy_mapping={"a0": "p0", "a1": "p1"}, seed=0, device="cpu",
    )
    params = {
        p: params_to_numpy(tm.init_actor_critic(i, 2, 3, (16,),
                                                device="cpu"))
        for i, p in enumerate(["p0", "p1"])
    }
    out = w.sample(params)
    assert set(out["batches"]) == {"p0", "p1"}
    assert out["batches"]["p0"]["obs"].shape == (48, 2)
    shared = MultiAgentRolloutWorker(
        "TwoAgentTarget-v0", rollout_len=48, gamma=0.99, lam=0.95,
        policy_mapping={"a0": "shared", "a1": "shared"}, seed=0,
        device="cpu",
    )
    sout = shared.sample({"shared": params["p0"]})
    # both agents' 48 steps land in ONE policy batch
    assert sout["batches"]["shared"]["obs"].shape == (96, 2)
