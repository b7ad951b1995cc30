"""Parity of the port's transformer (ray_tpu_torch/models/transformer.py)
with the JAX reference, on the CPU.

JAX initializes the weights; they cross as numpy arrays through
``params_from_numpy``. Token ids come from a numpy seed. Tolerance: atol 1e-4
on logits and loss for the ``tiny`` config in float32 (the same math; matmul
summation order differs between XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops.attention import causal_attention

ATOL = 1e-4

PRESETS = ["tiny", "bench_400m", "small_1b", "serve_7b", "gptj_6b"]


def _configs(**kw):
    return (dataclasses.replace(jtf.TransformerConfig.tiny(),
                                dtype=jnp.float32, **kw),
            dataclasses.replace(ttf.TransformerConfig.tiny(),
                                dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    jp = jtf.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    j = dataclasses.asdict(getattr(jtf.TransformerConfig, name)())
    t = dataclasses.asdict(getattr(ttf.TransformerConfig, name)())
    for key in ("dtype", "param_dtype"):  # the frameworks' dtype objects
        j[key] = np.dtype(j[key]).name
        t[key] = str(t[key]).removeprefix("torch.")
    assert t == j


@pytest.mark.parametrize(
    "kw",
    [{}, {"n_kv_heads": 2}, {"tie_embeddings": True}, {"moe_experts": 4}],
    ids=["mha", "gqa", "tied", "moe"],
)
def test_init_tree_and_logical_axes_match_jax(kw):
    jcfg, tcfg = _configs(**kw)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.key(0))))
    tp = ttf.init_params(tcfg, 0, device="cpu")
    assert _shapes(tp) == jshapes
    assert ttf.param_logical_axes(tcfg) == jtf.param_logical_axes(jcfg)


def test_init_params_dtype_and_seed():
    _, tcfg = _configs()
    a = ttf.init_params(tcfg, 3, device="cpu")
    b = ttf.init_params(tcfg, 3, device="cpu")
    c = ttf.init_params(tcfg, 4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["attn"]["wq"].dtype == tcfg.param_dtype


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_forward_and_loss_match_jax(attn_impl, n_kv_heads):
    jcfg, tcfg = _configs(attn_impl=attn_impl, n_kv_heads=n_kv_heads)
    jp, tp = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.8).astype(np.float32)

    ref = jtf.forward(jp, jnp.asarray(tokens), jcfg)
    out = ttf.forward(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    jbatch = {"tokens": tokens, "targets": targets, "mask": mask}
    tbatch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
    ref_loss = jtf.loss_fn(jp, {k: jnp.asarray(v) for k, v in jbatch.items()},
                           jcfg)
    loss = ttf.loss_fn(tp, tbatch, tcfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL)
    del tbatch["mask"], jbatch["mask"]  # the unmasked mean
    np.testing.assert_allclose(
        ttf.loss_fn(tp, tbatch, tcfg).item(),
        float(jtf.loss_fn(jp, {k: jnp.asarray(v) for k, v in jbatch.items()},
                          jcfg)),
        atol=ATOL)


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rotary_matches_jax(pos_rank):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 5, 4, 16), dtype=np.float32)
    k = rng.standard_normal((3, 5, 2, 16), dtype=np.float32)
    pos = (np.arange(5) if pos_rank == 1
           else rng.integers(0, 100, (3, 5))).astype(np.int32)
    jq, jk = jtf._rotary(jnp.asarray(q), jnp.asarray(k), 8, jnp.asarray(pos))
    tq, tk = ttf._rotary(torch.from_numpy(q), torch.from_numpy(k), 8,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_rms_norm_matches_jax_in_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64), dtype=np.float32)
    scale = rng.standard_normal(64, dtype=np.float32)
    ref = jtf._rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    out = ttf._rms_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of the normalized value, one of the product
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_bf16_params_cross_bit_exact():
    jcfg, tcfg = _configs()
    jp = jtf.init_params(jcfg, jax.random.key(0))
    jbf, _ = jgen.prepare_for_inference(
        jp, dataclasses.replace(jcfg, dtype=jnp.bfloat16))
    tp = params_from_numpy(jax.tree.map(np.asarray, jbf), device="cpu")
    ref = np.asarray(jbf["layers"]["attn"]["wq"]).astype(np.float32)
    got = tp["layers"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_unported_attention_raises(impl):
    """Ring and Ulysses attention are ported (tests/test_torch_ring_
    attention.py, tests/test_torch_ulysses_attention.py); as in the
    reference, each needs a mesh and refuses to run without one."""
    _, tcfg = _configs(attn_impl=impl)
    with pytest.raises(ValueError, match=f"{impl} attention needs a mesh"):
        ttf.select_attn_fn(tcfg)


class _ExpertMesh:
    """Stands for a mesh with ep = 2: the MoE FFN's checks run before any
    collective."""

    mesh_dim_names = ("ep",)

    def size(self, i):
        return 2


def test_moe_layer_raises():
    """The MoE FFN is ported (tests/test_torch_moe.py); a layer whose
    experts do not divide over the mesh's ep axis refuses to run."""
    _, tcfg = _configs(moe_experts=3)
    tp = ttf.init_params(tcfg, 0, device="cpu")
    x = torch.zeros((2, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="3 experts do not divide over ep=2"):
        ttf.apply_layer(x, ttf.layer_params(tp, 0), tcfg, torch.arange(4),
                        causal_attention, mesh=_ExpertMesh())


def _grad_batch(vocab, seed=5, b=2, s=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}


def _torch_grads(tp, batch, tcfg):
    params = ttf.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = ttf.loss_fn(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tcfg)
    return loss, torch.autograd.grad(loss, ttf.tree_leaves(params))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_loss_grads_match_jax(attn_impl, n_kv_heads):
    """jax.grad(loss_fn) against the port's autograd, tiny config in fp32
    from the same weights. atol 2e-5 on grads of magnitude up to ~1 (the
    same math; summation order differs)."""
    jcfg, tcfg = _configs(attn_impl=attn_impl, n_kv_heads=n_kv_heads)
    jp, tp = _jax_params(jcfg)
    batch = _grad_batch(jcfg.vocab_size)
    jgrads = jax.grad(jtf.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    _, grads = _torch_grads(tp, batch, tcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    got = jax.tree_util.tree_leaves_with_path(
        ttf.tree_map(lambda t: t.numpy(), _unflatten(tp, grads)))
    assert len(got) == len(want)
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=2e-5,
                                   err_msg=str(path))


def _unflatten(like, leaves):
    it = iter(leaves)
    return ttf.tree_map(lambda _: next(it), like)


def _count_flash_forwards(monkeypatch):
    from ray_tpu_torch.ops import flash_attention as tflash

    calls = [0]
    plain = tflash.flash_attention_fwd_reference

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tflash, "flash_attention_fwd_reference", counted)
    return calls


@pytest.mark.parametrize("policy", ["full", "dots", "dots_attn"])
def test_remat_policies_give_the_grads_of_no_remat(policy, monkeypatch):
    """Each policy recomputes what it does not save and must not change a
    grad (atol 1e-6: the recompute runs the same ops on the same inputs).
    As in the reference, the flash forward runs again in the backward under
    every policy: 2 runs per layer, as chip_smoke.py asserts on the card."""
    _, tcfg = _configs(attn_impl="flash")
    tp = ttf.init_params(tcfg, 0, device="cpu")
    batch = _grad_batch(tcfg.vocab_size)
    calls = _count_flash_forwards(monkeypatch)
    loss0, plain = _torch_grads(tp, batch, tcfg)
    assert calls[0] == tcfg.n_layers
    calls[0] = 0
    loss, grads = _torch_grads(
        tp, batch, dataclasses.replace(tcfg, remat=True, remat_policy=policy))
    assert calls[0] == 2 * tcfg.n_layers
    assert loss.item() == loss0.item()
    for a, b in zip(grads, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(tcfg):
    tp = ttf.init_params(tcfg, 0, device="cpu")
    params = ttf.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    batch = {k: torch.from_numpy(v)
             for k, v in _grad_batch(tcfg.vocab_size).items()}
    loss = ttf.loss_fn(params, batch, tcfg)
    with _CountOps() as ops:
        loss.backward()
    return ops.counts


@pytest.mark.parametrize("policy,extra_bmm", [
    ("dots", 2), ("dots_attn", 2), ("full", 7)])
def test_remat_policy_recomputes_what_the_reference_does(policy, extra_bmm):
    """Matrix products the backward runs beyond the no-remat backward, per
    layer, with dense attention: "dots" saves the 5 projections (no batch
    dims) and recomputes the 2 attention products (batch and heads), as
    dots_with_no_batch_dims_saveable does; "dots_attn" also saves the
    attention output (its checkpoint_name runs once, in the forward);
    "full" recomputes all 7."""
    _, tcfg = _configs(attn_impl="dense")
    plain = _backward_ops(tcfg)["aten.bmm.default"]
    ops = _backward_ops(
        dataclasses.replace(tcfg, remat=True, remat_policy=policy))
    assert ops["aten.bmm.default"] == plain + extra_bmm * tcfg.n_layers
    assert "ray_tpu_torch.checkpoint_name.default" not in ops


def test_unknown_remat_policy_raises():
    _, tcfg = _configs(remat=True, remat_policy="everything")
    tp = ttf.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        ttf.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg)


@pytest.mark.parametrize("name", PRESETS)
def test_param_count_matches_jax(name):
    assert (getattr(ttf.TransformerConfig, name)().param_count()
            == getattr(jtf.TransformerConfig, name)().param_count())
