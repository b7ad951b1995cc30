"""Int8 weight quantization in the port (ray_tpu_torch/models/quant.py) on the
CPU, held against the JAX package's ``ray_tpu/models/quant.py``: every case
of tests/test_quant.py, plus parity through forward, ``generate`` and
``LLMEngine`` on a JAX-quantized tree.

Quantization and dequantization are bit-identical to JAX's (the same fp32
division, round half to even and clip; the same bf16 product). fp32 logits:
atol 1e-4, as in the port's other forward parity tests; greedy tokens EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu.models import quant as jq
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import generation as tgen
from ray_tpu_torch.models import quant as tq
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import (
    NumpyQTensor,
    params_from_numpy,
    params_to_numpy,
)
from ray_tpu_torch.serve.llm import LLMEngine


def _weights(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.02
            ).astype(np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


# The reference's axis rules on stacked [L, ...] weights, and the
# test_quant.py case (reduce axis 0 of a [64, 32] weight).
AXIS_CASES = [
    ((3, 64, 4, 16), (1,)),   # wq/wk/wv, mlp wi: contract d
    ((3, 4, 16, 64), (1, 2)),  # attn wo: contract (h, k)
    ((3, 2, 64, 32), (2,)),   # moe wi/wo: contract d or f per expert
    ((64, 32), (0,)),
]


@pytest.mark.parametrize("shape,axes", AXIS_CASES,
                         ids=lambda x: "x".join(map(str, x)))
def test_quantize_tensor_bit_identical_to_jax(shape, axes):
    w = _weights(shape)
    ref = jq.quantize_tensor(jnp.asarray(w), axes)
    got = tq.quantize_tensor(torch.from_numpy(w), axes)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert got.s.shape == np.asarray(ref.s).shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(_bits(got.s.numpy()),
                                  _bits(np.asarray(ref.s)))


def test_quantize_tensor_roundtrip_error():
    w = torch.from_numpy(_weights((64, 32), seed=1))
    qt = tq.quantize_tensor(w, (0,))
    assert qt.q.dtype == torch.int8
    assert tuple(qt.s.shape) == (1, 32)  # per-output-channel
    err = ((qt.to(torch.float32) - w).abs().max() / w.abs().max()).item()
    assert err < 0.01  # int8 grid on a per-channel range


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bit_identical_to_jax(dtype):
    w = _weights((3, 64, 4, 16), seed=2)
    ref = jq.quantize_tensor(jnp.asarray(w), (1,))
    got = tq.quantize_tensor(torch.from_numpy(w), (1,))
    want = np.asarray(ref.astype(getattr(jnp, dtype)).astype(jnp.float32))
    deq = got.to(getattr(torch, dtype))
    assert deq.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(deq.float().numpy()), _bits(want))


def test_layer_params_and_unbind_slice_q_and_s():
    """The port's counterpart of scan slicing the QTensor pytree
    (test_quant.py:35): ``layer_params`` and ``unbind_layers`` give each
    layer's q and s, and the per-layer sums match JAX's scan."""
    w = np.random.default_rng(1).standard_normal((4, 8, 8)).astype(np.float32)
    jqt = jq.quantize_tensor(jnp.asarray(w), (1,))
    qt = tq.quantize_tensor(torch.from_numpy(w), (1,))
    params = {"layers": {"attn": {"wq": qt}}}
    by_index = [ttf.layer_params(params, i)["attn"]["wq"] for i in range(4)]
    by_unbind = [lp["attn"]["wq"] for lp in ttf.unbind_layers(params, 4)]
    for i, (a, b) in enumerate(zip(by_index, by_unbind)):
        for sl in (a, b):
            assert isinstance(sl, tq.QTensor)
            assert torch.equal(sl.q, qt.q[i]) and torch.equal(sl.s, qt.s[i])
            assert tuple(sl.s.shape) == (1, 8)

    def body(carry, sl):
        assert isinstance(sl, jq.QTensor)
        return carry + sl.astype(jnp.float32).sum(), None

    total, _ = jax.lax.scan(body, jnp.zeros(()), jqt)
    got = sum(sl.to(torch.float32).sum() for sl in by_unbind)
    np.testing.assert_allclose(float(got), float(total), rtol=1e-5)


def test_qtensor_broadcast_scale_is_not_sliced():
    """A scale with a leading dim of 1 (reduced over axis 0) broadcasts
    against every slice."""
    qt = tq.quantize_tensor(torch.from_numpy(_weights((4, 8, 8), 3)), (0, 1))
    assert tuple(qt.s.shape) == (1, 1, 8)
    for i, sl in enumerate(qt.unbind(0)):
        assert torch.equal(sl.q, qt.q[i]) and torch.equal(sl.s, qt.s[0])
        assert torch.equal(qt[i].to(torch.float32), sl.to(torch.float32))


def test_qtensor_rejects_other_slicing():
    """Only what the model code does is taken: one integer index, and
    ``unbind`` along the stacked layer dim."""
    qt = tq.quantize_tensor(torch.from_numpy(_weights((4, 8, 8), 5)), (1,))
    with pytest.raises(TypeError, match="integer index"):
        qt[1:3]
    with pytest.raises(ValueError, match="leading dim"):
        qt.unbind(1)


@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_quantize_layer_params_matches_jax(moe_experts):
    """Every layer leaf as JAX's ``quantize_layer_params`` leaves it: the
    axis rules' weights quantized bit-identically (the MoE wi/wo too, which
    the MoE FFN dequantizes through ``.to``), norms and router untouched."""
    jcfg = jtf.TransformerConfig.tiny(moe_experts=moe_experts)
    layers = jax.tree.map(np.asarray,
                          jtf.init_params(jcfg, jax.random.key(3))["layers"])
    ref = jax.tree.map(np.asarray, jq.quantize_layer_params(layers))
    got = tq.quantize_layer_params(
        ttf.tree_map(lambda a: torch.from_numpy(a.copy()), layers))
    assert sorted(got) == sorted(ref)
    for group, sub in ref.items():
        assert sorted(got[group]) == sorted(sub)
        for name, want in sub.items():
            leaf = got[group][name]
            if isinstance(want, jq.QTensor):
                assert isinstance(leaf, tq.QTensor), (group, name)
                np.testing.assert_array_equal(leaf.q.numpy(),
                                              np.asarray(want.q))
                np.testing.assert_array_equal(_bits(leaf.s.numpy()),
                                              _bits(np.asarray(want.s)))
            else:
                assert not isinstance(leaf, tq.QTensor), (group, name)
                np.testing.assert_array_equal(leaf.numpy(), want)
    if moe_experts:
        assert tuple(got["moe"]["wi"].s.shape) == (2, moe_experts, 1, 128)


def test_qtensor_to_device_keeps_it_and_to_dtype_dequantizes():
    qt = tq.quantize_tensor(torch.from_numpy(_weights((2, 16, 8), 4)), (1,))
    for dev in ("cpu", torch.device("cpu")):
        moved = qt.to(dev)
        assert isinstance(moved, tq.QTensor)
        assert moved.q.dtype == torch.int8 and moved.s.dtype == torch.float32
        assert torch.equal(moved.q, qt.q) and torch.equal(moved.s, qt.s)
    deq = qt.to(torch.bfloat16)
    assert isinstance(deq, torch.Tensor) and deq.dtype == torch.bfloat16
    assert torch.equal(deq, qt.q.to(torch.bfloat16) * qt.s.to(torch.bfloat16))
    assert qt.shape == qt.q.shape and qt.ndim == 3
    head = qt[0]  # a [d, v] weight, as a tied head would be
    assert torch.equal(head.T, head.to(torch.bfloat16).T)
    with pytest.raises(TypeError, match="dtype"):
        qt.to(3)


def _tiny(n_layers=2, dtype="float32", **kw):
    jcfg = dataclasses.replace(jtf.TransformerConfig.tiny(n_layers=n_layers),
                               dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(ttf.TransformerConfig.tiny(n_layers=n_layers),
                               dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _jax_quantized(jcfg, seed=0):
    """JAX's params, and JAX's quantize_params_int8 of them, with the port's
    copy of the quantized tree."""
    jp = jtf.init_params(jcfg, jax.random.key(seed))
    jqp = jq.quantize_params_int8(jp)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    return jp, jqp, tqp


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_quantized_forward_matches_jax(n_kv_heads):
    jcfg, tcfg = _tiny(n_kv_heads=n_kv_heads)
    _, jqp, tqp = _jax_quantized(jcfg)
    assert isinstance(tqp["layers"]["attn"]["wq"], tq.QTensor)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    ref = np.asarray(jtf.forward(jqp, jnp.asarray(toks, jnp.int32), jcfg))
    got = ttf.forward(tqp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_quantized_generate_matches_jax():
    jcfg, tcfg = _tiny()
    _, jqp, tqp = _jax_quantized(jcfg)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jp_inf, jcfg_inf = jgen.prepare_for_inference(jqp, jcfg)
    ref = jgen.generate(jp_inf, jnp.asarray(prompt), jcfg_inf,
                        max_new_tokens=8, max_len=64)
    tp_inf, tcfg_inf = tgen.prepare_for_inference(tqp, tcfg)
    got = tgen.generate(tp_inf, prompt, tcfg_inf, max_new_tokens=8,
                        max_len=64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantized_engine_matches_jax_generate():
    """LLMEngine takes the int8 tree unchanged (QTensors kept, the KV cache
    at the compute dtype), and its interleaved greedy tokens EQUAL JAX's
    generate on the same quantized weights."""
    jcfg, tcfg = _tiny()
    _, jqp, tqp = _jax_quantized(jcfg)
    prompts = [np.arange(1, 9, dtype=np.int32),
               (np.arange(3, 15, dtype=np.int32) % jcfg.vocab_size),
               np.full(5, 7, np.int32)]
    ref = [np.asarray(jgen.generate(jqp, jnp.asarray(p[None]), jcfg,
                                    max_new_tokens=10, max_len=64))[0]
           for p in prompts]
    eng = LLMEngine(tqp, tcfg, max_slots=2, max_len=64,
                    prefill_buckets=(16, 32), device="cpu")
    try:
        assert isinstance(eng.params["layers"]["mlp"]["wi"], tq.QTensor)
        assert eng.params["layers"]["mlp"]["wi"].q.dtype == torch.int8
        assert eng.cache["k"].dtype == torch.float32
        got = [None] * len(prompts)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for i, req in enumerate(reqs):
            got[i] = []
            while True:
                item = req.out.get(timeout=120)
                if not isinstance(item, int):
                    break
                got[i].append(item)
        for i in range(len(prompts)):
            assert got[i] == ref[i].tolist(), (i, got[i], ref[i].tolist())
    finally:
        eng.shutdown()


def test_engine_cache_is_compute_dtype_for_int8_weights():
    _, tcfg = _tiny(dtype="bfloat16")
    params = tq.quantize_params_int8(ttf.init_params(tcfg, 0, device="cpu"))
    eng = LLMEngine(params, tcfg, max_slots=2, max_len=32,
                    prefill_buckets=(16,), device="cpu")
    try:
        assert eng.cache["k"].dtype == eng.cache["v"].dtype == torch.bfloat16
        wq = eng.params["layers"]["attn"]["wq"]
        assert isinstance(wq, tq.QTensor) and wq.q.dtype == torch.int8
        assert eng.params["embed"].dtype == torch.bfloat16
        out = eng.generate(np.arange(1, 6), max_new_tokens=4)
        assert len(out) == 4 and all(0 <= t < tcfg.vocab_size for t in out)
    finally:
        eng.shutdown()


def test_quantized_forward_close_to_bf16():
    """As test_quant.py:52, on the port: the int8 tree's bf16 logits track
    the bf16 logits of the weights it was quantized from; and the JAX
    quantized logits agree with the port's to the same figure."""
    jcfg, tcfg = _tiny(dtype="bfloat16")
    jp, jqp, tqp = _jax_quantized(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 16))
    ref = ttf.forward(tp, torch.from_numpy(toks), tcfg).float().numpy()
    out = ttf.forward(tq.quantize_params_int8(tp), torch.from_numpy(toks),
                      tcfg).float().numpy()
    denom = np.abs(ref).max() + 1e-6
    assert np.abs(out - ref).max() / denom < 0.12
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.9
    jout = np.asarray(jtf.forward(jqp, jnp.asarray(toks, jnp.int32), jcfg),
                      np.float32)
    conv = ttf.forward(tqp, torch.from_numpy(toks), tcfg).float().numpy()
    assert np.abs(conv - jout).max() / denom < 0.12


def test_prepare_for_inference_keeps_qtensors():
    _, tcfg = _tiny(dtype="bfloat16")
    params = tq.quantize_params_int8(ttf.init_params(tcfg, 0, device="cpu"))
    wq = params["layers"]["attn"]["wq"]
    out, cfg = tgen.prepare_for_inference(params, tcfg)
    assert out["layers"]["attn"]["wq"] is wq  # untouched
    assert out["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    assert out["embed"].dtype == torch.bfloat16
    assert cfg.param_dtype == torch.bfloat16


def test_init_params_int8_shapes_and_dtypes():
    """As test_quant.py:91, and every leaf's shape and dtype as JAX's
    init_params_int8 gives them; each layer is the quantization of a
    one-layer init from its ``layer_seed``."""
    _, tcfg = _tiny(n_layers=3)
    jcfg = jtf.TransformerConfig.tiny(n_layers=3)
    p = tq.init_params_int8(tcfg, 0, device="cpu")
    wq = p["layers"]["attn"]["wq"]
    assert isinstance(wq, tq.QTensor)
    assert tuple(wq.q.shape) == (3, tcfg.d_model, tcfg.n_heads, tcfg.d_head)
    assert wq.q.dtype == torch.int8
    assert p["embed"].dtype == tcfg.param_dtype  # embedding not quantized
    assert not torch.equal(wq.q[0], wq.q[1])  # distinct layers

    jp = jax.tree.map(np.asarray, jq.init_params_int8(jcfg,
                                                      jax.random.key(0)))
    got = params_to_numpy(p)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if hasattr(tree, "q"):
            return (tree.q.shape, str(tree.q.dtype), tree.s.shape,
                    str(tree.s.dtype))
        return tree.shape, str(tree.dtype)

    assert shapes(got) == shapes(jp)

    one = dataclasses.replace(tcfg, n_layers=1)
    for li in range(3):
        layer = tq.quantize_layer_params(ttf.init_params(
            one, tq.layer_seed(0, li), device="cpu")["layers"])
        assert torch.equal(layer["mlp"]["wo"].q[0],
                           p["layers"]["mlp"]["wo"].q[li])
        assert torch.equal(layer["attn"]["wo"].s[0],
                           p["layers"]["attn"]["wo"].s[li])
        assert torch.equal(layer["ln1"]["scale"][0],
                           p["layers"]["ln1"]["scale"][li])


def test_init_params_by_layer_casts_each_seeded_layer():
    """The bf16 model beside an int8 one: each layer is the bf16 rounding of
    the one-layer init that ``init_params_int8`` quantizes; the embedding
    and head are the int8 model's."""
    _, tcfg = _tiny(n_layers=3)
    bf16 = tq.init_params_by_layer(
        tcfg, 7, lambda layer: ttf.tree_map(
            lambda w: w.to(torch.bfloat16), layer), device="cpu")
    int8 = tq.init_params_int8(tcfg, 7, device="cpu")
    one = dataclasses.replace(tcfg, n_layers=1)
    for li in range(3):
        ref = ttf.init_params(one, tq.layer_seed(7, li), device="cpu")
        assert torch.equal(bf16["layers"]["attn"]["wq"][li],
                           ref["layers"]["attn"]["wq"][0].to(torch.bfloat16))
        assert bf16["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    for name in ("embed", "lm_head"):
        assert torch.equal(bf16[name], int8[name])


def test_params_from_numpy_takes_a_bf16_quantized_tree():
    """JAX's quantization of bf16 params: int8 q and fp32 s (the scale is
    computed in fp32), the unquantized leaves bf16; all cross bit-exact."""
    jcfg = dataclasses.replace(jtf.TransformerConfig.tiny(),
                               param_dtype=jnp.bfloat16)
    jqp = jq.quantize_params_int8(jtf.init_params(jcfg, jax.random.key(4)))
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    wo = tqp["layers"]["mlp"]["wo"]
    assert wo.q.dtype == torch.int8 and wo.s.dtype == torch.float32
    assert tqp["embed"].dtype == torch.bfloat16
    assert tqp["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_to_numpy(tqp)["embed"],
        np.asarray(jqp["embed"]).astype(np.float32))
    np.testing.assert_array_equal(wo.q.numpy(),
                                  np.asarray(jqp["layers"]["mlp"]["wo"].q))


def test_params_numpy_round_trip_is_bit_exact():
    jcfg, _ = _tiny()
    _, jqp, tqp = _jax_quantized(jcfg)
    back = params_to_numpy(tqp)
    leaf = back["layers"]["attn"]["wo"]
    assert isinstance(leaf, NumpyQTensor)
    assert leaf.q.dtype == np.int8 and leaf.s.dtype == np.float32
    again = params_from_numpy(back, device="cpu")
    for a, b in zip(ttf.tree_leaves(again), ttf.tree_leaves(tqp)):
        pairs = [(a.q, b.q), (a.s, b.s)] if isinstance(a, tq.QTensor) else [
            (a, b)]
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y)
    # the JAX QTensor rebuilt from the host copy is the one JAX made
    ref = jax.tree.map(np.asarray, jqp)
    for name, w in back["layers"]["attn"].items():
        rebuilt = jq.QTensor(jnp.asarray(w.q), jnp.asarray(w.s))
        want = ref["layers"]["attn"][name]
        np.testing.assert_array_equal(np.asarray(rebuilt.q), want.q)
        np.testing.assert_array_equal(_bits(np.asarray(rebuilt.s)),
                                      _bits(want.s))


def test_serve_7b_config_is_7b_class():
    cfg = ttf.TransformerConfig.serve_7b()
    assert cfg.param_count() >= 6_000_000_000, cfg.param_count()
    assert cfg.param_count() == jtf.TransformerConfig.serve_7b().param_count()
