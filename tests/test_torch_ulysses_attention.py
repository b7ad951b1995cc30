"""The port's Ulysses attention (ray_tpu_torch/ops/ulysses_attention.py)
and the ``attn_impl="ulysses"`` transformer, held against the JAX
package's (ray_tpu/ops/ulysses_attention.py; tests/test_parallel.py:187-
230) on the CPU.

One rank (a world-size-1 gloo group, so the mesh has no sp axis): no
all-to-all, the local attention on the whole sequence, dense and flash,
against ``causal_attention``; and the refusals. Four gloo ranks (one spawn,
``tests/torch_gloo.py``) over sp 2 x tp 2: Ulysses on DTensors with the
dense and the flash local attention (the flash kernels' plain versions on
the CPU), MHA, GQA, and GQA with fewer kv heads per tp rank than sp (kv
heads repeated up to the q heads), its output and q, k, v gradients against
JAX's ``ulysses_attention`` on a mesh of the same shape (4 of the pytest
process's CPU devices; its dense local attention, and its flash one for
the flash case) and against dense ``causal_attention``; then ``tiny`` with
Ulysses attention: the forward's logits and 3 fp32 sharded train steps'
losses and gathered parameters against JAX's sharded forward and step.

Tolerances: attention outputs and gradients atol 2e-5 (the reference's
bound, tests/test_model.py:92); the model as tests/test_torch_sharded_
train.py (logits and parameters atol 1e-5, losses and grad norms rtol
1e-5).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.ops.attention import causal_attention as jcausal
from ray_tpu.ops.ulysses_attention import ulysses_attention as july
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.ops.ulysses_attention import ulysses_attention
from tests.torch_gloo import free_port, run_ranks

SIZES = {"sp": 2, "tp": 2}
STEPS = 3
SHAPES = {"mha": (2, 32, 4, 4, 8), "gqa": (2, 32, 8, 4, 8),  # b s h hkv d
          "gqa_kv_below_sp": (2, 32, 8, 2, 8)}  # 1 kv head per tp rank
CASES = [(kind, local) for kind in SHAPES for local in ("dense", "flash")]


def _qkvw(shape, seed=0):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((b, s, h, d), dtype=np.float32),
            "k": rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            "v": rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            "w": rng.standard_normal((b, s, h, d), dtype=np.float32)}


def _value_and_grads(attn, x):
    def loss(q, k, v):
        o = attn(q, k, v)
        return (o * x["w"]).sum(), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x[n]) for n in "qkv"))
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield build_mesh(MeshConfig(dp=1), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("local", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_one_rank_ulysses_matches_causal_attention(one_rank_mesh, kind,
                                                    local):
    from torch.distributed.tensor import DTensor, Replicate

    x = _qkvw(SHAPES[kind])
    want = _value_and_grads(jax.jit(jcausal), x)
    ts = [DTensor.from_local(torch.from_numpy(x[n]), one_rank_mesh,
                             [Replicate()]).requires_grad_(True)
          for n in "qkv"]
    o = ulysses_attention(*ts, mesh=one_rank_mesh, attn_impl=local)
    (o.to_local() * torch.from_numpy(x["w"])).sum().backward()
    got = [o.to_local().detach().numpy()] + [
        t.grad.to_local().numpy() for t in ts]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, err_msg=name)


class _SequenceMesh:
    """Stands for a mesh with sp = 2 and tp = 2: the checks run before any
    collective."""

    mesh_dim_names = ("sp", "tp")

    def size(self, i):
        return 2


def test_refusals():
    q = torch.zeros((2, 7, 4, 8))
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        ulysses_attention(q, q, q, mesh=_SequenceMesh())
    q = torch.zeros((2, 8, 2, 8))  # one head per tp rank, sp = 2
    with pytest.raises(ValueError, match="must be divisible by sp=2"):
        ulysses_attention(q, q, q, mesh=_SequenceMesh())
    q = torch.zeros((2, 8, 4, 8))
    with pytest.raises(ValueError, match="unknown local attn_impl"):
        ulysses_attention(q, q, q, mesh=_SequenceMesh(), attn_impl="ring")
    cfg = ttf.TransformerConfig.tiny(attn_impl="ulysses")
    with pytest.raises(ValueError, match="ulysses attention needs a mesh"):
        ttf.select_attn_fn(cfg, None)


# -- four gloo ranks ---------------------------------------------------------

_SCRIPT = """
import json
import pickle
import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.ulysses_attention import ulysses_attention
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

job = json.load(open(f"{work}/job.json"))
mesh = tmesh.build_mesh(tmesh.MeshConfig(**job["sizes"]), "cpu")
rules = tmesh.AxisRules((("batch", ("dp", "ep")), ("seq", "sp"),
                        ("heads", "tp")))
spec = tmesh.logical_to_placements(mesh, rules,
                                   ("batch", "seq", "heads", None))
out = {}
for kind, local in job["cases"]:
    x = np.load(f"{work}/{kind}.npz")
    ts = [distribute_tensor(torch.from_numpy(x[n]), mesh, spec,
                            src_data_rank=None).requires_grad_(True)
          for n in "qkv"]
    o = ulysses_attention(*ts, mesh=mesh, attn_impl=local)
    assert tuple(o.placements) == tuple(spec)
    b, s, h, d = x["q"].shape
    assert tuple(o.to_local().shape) == (b, s // 2, h // 2, d)
    w = distribute_tensor(torch.from_numpy(x["w"]), mesh, spec,
                          src_data_rank=None)
    (o * w).sum().backward()
    out[f"{kind}_{local}"] = [t.full_tensor().detach().numpy()
                              for t in [o] + [t.grad for t in ts]]
    dense = causal_attention(*(torch.from_numpy(x[n]) for n in "qkv"))
    out[kind + "_causal"] = [dense.numpy()]

cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32,
                                 attn_impl="ulysses")
batch = {k: torch.from_numpy(v)
         for k, v in np.load(f"{work}/batch.npz").items()}
init = pickle.load(open(f"{work}/init.pkl", "rb"))
opt = tts.default_optimizer()
state, sh = tts.make_sharded_state(
    cfg, opt, 0, params=params_from_numpy(init, device="cpu"), mesh=mesh)
_, placements = tts.batch_sharding(mesh)
tokens = distribute_tensor(batch["tokens"], mesh, placements,
                           src_data_rank=None)
with torch.no_grad():
    logits = ttf.forward(state.params, tokens, cfg, mesh).full_tensor()
step = tts.make_train_step(cfg, opt, mesh=mesh, state_shardings=sh)
metrics = []
for _ in range(job["steps"]):
    state, m = step(state, batch)
    metrics.append([m["loss"].item(), m["grad_norm"].item()])
leaves = [p.full_tensor().detach().numpy()
          for p in ttf.tree_leaves(state.params)]
if rank == 0:
    np.savez(f"{work}/out.npz", logits=logits.numpy(),
             **{f"{k}_{i}": a for k, v in out.items()
                for i, a in enumerate(v)},
             **{f"p{i}": a for i, a in enumerate(leaves)})
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump({"metrics": metrics}, f)
"""


def _batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


@pytest.fixture(scope="module")
def ulysses_ranks(tmp_path_factory):
    """One four-rank run (the ops, then the model), and JAX's results."""
    work = tmp_path_factory.mktemp("ulysses_ranks")
    n = int(np.prod(list(SIZES.values())))
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**SIZES),
                            devices=jax.devices()[:n])
    ref = {}
    for kind, shape in SHAPES.items():
        x = _qkvw(shape, seed=len(kind))
        np.savez(work / f"{kind}.npz", **x)
        for local in ("dense", "flash"):
            ref[f"{kind}_{local}"] = _value_and_grads(jax.jit(
                lambda q, k, v, local=local: july(q, k, v, mesh=mesh,
                                                  attn_impl=local)), x)
        ref[kind + "_causal"] = _value_and_grads(jax.jit(jcausal), x)
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, max_seq_len=32,
                                      attn_impl="ulysses")
    batch = _batch(jcfg.vocab_size)
    np.savez(work / "batch.npz", **batch)
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0))
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.array, state.params), f)
    data_sh = jts.batch_sharding(mesh)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh)
          for k, v in batch.items()}
    ref["logits"] = np.asarray(jax.jit(lambda p, t: jtf.forward(
        p, t, jcfg, mesh))(state.params, jb["tokens"]))
    step = jts.make_train_step(jcfg, mesh, opt, sh)
    ref["metrics"] = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        ref["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    ref["params"] = [np.asarray(x, np.float32) for x in ttf.tree_leaves(
        jax.tree.map(np.asarray, state.params))]
    (work / "job.json").write_text(json.dumps(
        {"sizes": SIZES, "cases": CASES, "steps": STEPS}))
    run_ranks(_SCRIPT, 4, work, timeout=200)
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(4)]
    return ranks, np.load(work / "out.npz"), ref


@pytest.mark.parametrize("kind,local", CASES)
def test_ulysses_over_sp_matches_jax_ulysses_attention(ulysses_ranks, kind,
                                                       local):
    _, out, ref = ulysses_ranks
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(out[f"{kind}_{local}_{i}"],
                                   ref[f"{kind}_{local}"][i], atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("kind,local", CASES)
def test_ulysses_over_sp_matches_causal_attention(ulysses_ranks, kind,
                                                  local):
    _, out, ref = ulysses_ranks
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(out[f"{kind}_{local}_{i}"],
                                   ref[kind + "_causal"][i], atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(out[f"{kind}_causal_0"],
                               ref[kind + "_causal"][0], atol=2e-5)


def test_ulysses_model_forward_matches_jax(ulysses_ranks):
    _, out, ref = ulysses_ranks
    np.testing.assert_allclose(out["logits"], ref["logits"], atol=1e-5)


def test_ulysses_model_steps_match_jax(ulysses_ranks):
    ranks, out, ref = ulysses_ranks
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
    np.testing.assert_allclose(ranks[0]["metrics"], ref["metrics"],
                               rtol=1e-5)
    for i, want in enumerate(ref["params"]):
        np.testing.assert_allclose(out[f"p{i}"], want, atol=1e-5,
                                   err_msg=str(i))
    losses = [m[0] for m in ranks[0]["metrics"]]
    assert losses[-1] < losses[0]
