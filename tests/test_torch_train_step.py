"""The port's one-device training (ray_tpu_torch/parallel/train_step.py)
against the JAX package's ``make_sharded_state`` / ``make_train_step`` /
``default_optimizer`` on a one-device mesh, on the CPU.

JAX initializes the weights; both packages start from them (through
``params_from_numpy``) and take the same steps on a batch made from a numpy
seed. Tolerances, each with its reason:

- fp32, 5 ``tiny`` steps: loss and grad norm at rtol 1e-5 per step (the same
  math; XLA and PyTorch sum in different orders: ~1e-7 seen). Params after 5
  steps at atol 2e-5 (~4e-6 seen): Adam divides each grad by its own
  running scale, so a rounding-level grad difference can move a weight by
  far more than its own size; equality to the bit is not expected.
- bf16 compute (fp32 params), 5 steps: loss at atol 5e-3 and grad norm at
  rtol 5e-3 (bf16 rounds at other places in the two frameworks, e.g. JAX
  accumulates the embedding grad in bf16; ~6e-4 and ~2.4e-4 seen). Params
  at atol 3e-3: at a step Adam's update is about lr * sign(g), so a grad
  that is ~0 in both packages but of opposite signs moves a weight up to
  2 lr apart, 5 * 2 * 3e-4 = 3e-3 over the run (~1.7e-3 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import train_step as tts

STEPS = 5


def _configs(dtype_name, **kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    kw = dict(max_seq_len=32, **kw)
    return (jtf.TransformerConfig.tiny(dtype=jdt, **kw),
            ttf.TransformerConfig.tiny(dtype=tdt, **kw))


def _batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _jax_run(jcfg, batch, steps):
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0))
    init = jax.tree.map(np.array, state.params)  # copies: state is donated
    step = jts.make_train_step(jcfg, mesh, opt, sh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics, jax.tree.map(np.asarray, state.params)


def _torch_run(tcfg, init, batch, steps, capturable=False):
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(
        tcfg, opt, seed=0, device="cpu",
        params=params_from_numpy(init, device="cpu"))
    if capturable:  # as on CUDA (the caller lets torch take the CPU)
        state.opt_state.param_groups[0]["capturable"] = True
    step = tts.make_train_step(tcfg, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, tb)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state, metrics


def _assert_params_close(got, want, atol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, np.asarray(flat_want[path],
                                                    np.float32),
                                   atol=atol, err_msg=str(path))


@pytest.mark.parametrize(
    "dtype_name,attn_impl,kw",
    [("float32", "flash", {}),
     ("float32", "dense", {"n_kv_heads": 2}),
     ("float32", "flash", {"remat": True, "remat_policy": "dots"}),
     ("bfloat16", "flash", {"remat": True, "remat_policy": "dots"})],
    ids=["fp32_flash", "fp32_dense_gqa", "fp32_flash_remat_dots",
         "bf16_flash_remat_dots"],
)
def test_train_steps_match_jax(dtype_name, attn_impl, kw):
    jcfg, tcfg = _configs(dtype_name, attn_impl=attn_impl, **kw)
    batch = _batch(jcfg.vocab_size)
    init, jmetrics, jparams = _jax_run(jcfg, batch, STEPS)
    state, tmetrics = _torch_run(tcfg, init, batch, STEPS)
    if dtype_name == "float32":
        np.testing.assert_allclose(tmetrics, jmetrics, rtol=1e-5)
        _assert_params_close(params_to_numpy(state.params), jparams, 2e-5)
    else:
        t, j = np.array(tmetrics), np.array(jmetrics)
        np.testing.assert_allclose(t[:, 0], j[:, 0], atol=5e-3)
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=5e-3)
        _assert_params_close(params_to_numpy(state.params), jparams, 3e-3)
    assert tmetrics[-1][0] < tmetrics[0][0]  # the repeated batch is learned
    assert int(state.step) == STEPS


def test_step_updates_in_place_and_keeps_metrics_on_device():
    _, tcfg = _configs("float32")
    opt = tts.default_optimizer()
    state, shardings = tts.make_sharded_state(tcfg, opt, seed=0,
                                              device="cpu")
    assert shardings is None
    wq = state.params["layers"]["attn"]["wq"]
    before = wq.detach().clone()
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    new, m = tts.make_train_step(tcfg, opt)(state, tb)
    assert new is state and new.params["layers"]["attn"]["wq"] is wq
    assert not torch.equal(wq.detach(), before)
    assert all(isinstance(m[k], torch.Tensor) for k in ("loss", "grad_norm",
                                                        "step"))
    assert int(m["step"]) == 1 and wq.grad is None


def test_grads_fn_overrides_autograd():
    _, tcfg = _configs("float32")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    opt = tts.default_optimizer()
    runs = []
    for use_grads_fn in (False, True):
        state, _ = tts.make_sharded_state(tcfg, opt, seed=0, device="cpu")

        def grads_fn(params, batch):
            loss = ttf.loss_fn(params, batch, tcfg)
            grads = torch.autograd.grad(loss, ttf.tree_leaves(params))
            leaves = iter(grads)
            return loss, ttf.tree_map(lambda _: next(leaves), params)

        step = tts.make_train_step(
            tcfg, opt, grads_fn=grads_fn if use_grads_fn else None)
        _, m = step(state, tb)
        runs.append((m["loss"].item(), m["grad_norm"].item(),
                     params_to_numpy(state.params)))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(ttf.tree_leaves(runs[0][2]), ttf.tree_leaves(runs[1][2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("norm", [0.5, 3.0], ids=["unclipped", "clipped"])
def test_optimizer_update_matches_optax(norm):
    """Two updates of default_optimizer on random params and grads, against
    optax's, with every leaf decayed (norm scales included). atol 2e-7 on
    values of magnitude ~1: fp32 rounding of the same update (an ulp is
    1.2e-7)."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((5, 3), dtype=np.float32),
              "scale": np.ones(3, np.float32)}
    grads = {k: rng.standard_normal(v.shape, dtype=np.float32)
             for k, v in params.items()}
    total = np.sqrt(sum((g ** 2).sum() for g in grads.values()))
    grads = {k: g * (norm / total) for k, g in grads.items()}

    jopt = jts.default_optimizer(lr=1e-2)
    params_j = params
    jstate = jopt.init(params_j)
    for _ in range(2):
        upd, jstate = jopt.update(grads, jstate, params_j)
        params_j = optax.apply_updates(params_j, upd)

    topt = tts.default_optimizer(lr=1e-2)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in params.items()}
    opt = topt.init(tparams)
    for _ in range(2):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        got_norm = topt.clip_([p.grad for p in tparams.values()])
        opt.step()
    np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(params_j[k]), atol=2e-7)


def test_more_than_one_device_raises():
    """A list of devices without ``mesh=`` is refused, and the message
    names the mesh argument (a state over several devices is laid out on a
    mesh)."""
    _, tcfg = _configs("float32")
    with pytest.raises(ValueError, match="mesh=build_mesh"):
        tts.make_sharded_state(tcfg, tts.default_optimizer(), 0,
                               device=["cpu", "cpu"])


def test_default_optimizer_matches_the_reference_defaults():
    opt = tts.default_optimizer()
    assert (opt.lr, opt.B1, opt.B2, opt.EPS, opt.weight_decay,
            opt.MAX_NORM) == (3e-4, 0.9, 0.95, 1e-8, 0.01, 1.0)
    adamw = opt.init({"w": torch.zeros(2, requires_grad=True)})
    group = adamw.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.95), 1e-8, 0.01)


def _capturable_on_cpu(monkeypatch):
    """torch runs capturable Adam only on accelerators; its math is plain
    tensor code, so the CPU can run it once torch lets it."""
    import torch.optim.adam as adam

    real = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: [*real(supports_xla),
                                                   "cpu"])


@pytest.mark.parametrize("dtype_name,kw", [
    ("float32", {}),
    ("float32", {"remat": True, "remat_policy": "dots"}),
], ids=["fp32_flash", "fp32_flash_remat_dots"])
def test_capturable_adamw_steps_match_jax(monkeypatch, dtype_name, kw):
    """N calls with AdamW capturable (step count and bias corrections as
    tensors, as the step runs on CUDA) equal N optax steps, at the fp32
    tolerances above."""
    _capturable_on_cpu(monkeypatch)
    jcfg, tcfg = _configs(dtype_name, attn_impl="flash", **kw)
    batch = _batch(jcfg.vocab_size)
    init, jmetrics, jparams = _jax_run(jcfg, batch, STEPS)
    state, tmetrics = _torch_run(tcfg, init, batch, STEPS, capturable=True)
    assert state.opt_state.param_groups[0]["capturable"]
    st = next(iter(state.opt_state.state.values()))
    assert float(st["step"]) == STEPS and st["step"].dim() == 0
    np.testing.assert_allclose(tmetrics, jmetrics, rtol=1e-5)
    _assert_params_close(params_to_numpy(state.params), jparams, 2e-5)


def test_adamw_is_capturable_only_on_cuda():
    _, tcfg = _configs("float32")
    state, _ = tts.make_sharded_state(tcfg, tts.default_optimizer(), seed=0,
                                      device="cpu")
    assert state.opt_state.param_groups[0]["capturable"] is False


def _tiny_step(seed=0):
    _, tcfg = _configs("float32")
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(tcfg, opt, seed=seed, device="cpu")
    return tcfg, state, tts.make_train_step(tcfg, opt)


def test_metrics_are_fresh_tensors_that_keep_their_values():
    tcfg, state, step = _tiny_step()
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    kept = [step(state, tb)[1] for _ in range(3)]
    values = [(m["loss"].item(), m["grad_norm"].item(), int(m["step"]))
              for m in kept]
    step(state, tb)  # a later call changes no metric kept before
    assert [(m["loss"].item(), m["grad_norm"].item(), int(m["step"]))
            for m in kept] == values
    assert [v[2] for v in values] == [1, 2, 3]
    for k in ("loss", "grad_norm", "step"):
        ptrs = {m[k].data_ptr() for m in kept}
        assert len(ptrs) == 3, k
    assert all(m["step"] is not state.step for m in kept)


def test_state_step_advances_in_place():
    tcfg, state, step = _tiny_step()
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    step_t = state.step
    for n in range(1, 4):
        step(state, tb)
        assert state.step is step_t and int(step_t) == n
        assert step_t.dtype == torch.int32


def test_another_state_raises_and_a_new_batch_shape_runs():
    tcfg, state, step = _tiny_step()
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    step(state, tb)
    small = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg.vocab_size, b=2, s=16).items()}
    _, m = step(state, small)  # another shape: one more step on this state
    assert int(m["step"]) == 2 and np.isfinite(m["loss"].item())
    _, other, _ = _tiny_step(seed=1)
    with pytest.raises(ValueError, match="TrainState of its first call"):
        step(other, tb)
    # the same object with a parameter replaced is another state too
    state.params["embed"] = state.params["embed"].detach().clone()
    with pytest.raises(ValueError, match="TrainState of its first call"):
        step(state, tb)
    assert int(state.step) == 2
    tts.make_train_step(tcfg, tts.default_optimizer()).eager(other, tb)
    assert int(other.step) == 1  # eager serves any state


class _FakeGraph:
    """Stands in for a CUDA graph on the CPU: records no work at capture,
    reruns the step over the static buffers at replay, and writes its loss
    and grad norm into the same static tensors, as a replay does."""

    def __init__(self, body, state, batch):
        self.body, self.state, self.batch = body, state, batch
        self.loss, self.grad_norm = torch.zeros(()), torch.zeros(())

    def replay(self):
        loss, norm = self.body(self.state, self.batch)
        self.loss.copy_(loss)
        self.grad_norm.copy_(norm)


def test_cuda_calls_warm_up_then_capture_then_replay(monkeypatch):
    """The CUDA sequence, per batch signature, on the CPU with the graph
    faked: call 1 runs eagerly (the warm-up), call 2 captures and replays
    once, later calls replay; every call is one step, its batch copied into
    the static buffers, and its metrics its own."""
    import contextlib

    tcfg, state, step = _tiny_step()
    events = []

    def warm_up(st, batch, dev):
        events.append("warm")
        return step._body(st, batch)

    def capture(st, batch, dev):
        events.append("capture")
        static = {k: torch.empty_like(v) for k, v in batch.items()}
        graph = _FakeGraph(step._body, st, static)
        step.captures += 1
        return tts._Program(graph, static, graph.loss, graph.grad_norm)

    monkeypatch.setattr(step, "_warm_up", warm_up)
    monkeypatch.setattr(step, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    ref_cfg, ref, ref_step = _tiny_step()
    batches = [{k: torch.from_numpy(v) for k, v in
                _batch(tcfg.vocab_size, seed=i).items()} for i in range(4)]
    got, want = [], []
    for i in range(6):
        b = batches[i % 4]
        got.append(step._on_cuda(state, b))
        got[-1] = tts._metrics(*got[-1], state.step)
        want.append(ref_step(ref, b)[1])
    assert events == ["warm", "capture"]
    assert step.captures == 1 and step.replays == 5
    for g, w in zip(got, want):
        assert g["loss"].item() == w["loss"].item()
        assert g["grad_norm"].item() == w["grad_norm"].item()
    assert [int(g["step"]) for g in got] == [1, 2, 3, 4, 5, 6]
    small = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg.vocab_size, b=2, s=16).items()}
    step._on_cuda(state, small)
    step._on_cuda(state, small)
    assert events == ["warm", "capture", "warm", "capture"]
    assert len(step._programs) == 2 and int(state.step) == 8
