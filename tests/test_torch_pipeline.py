"""The port's pipeline parallelism (ray_tpu_torch/parallel/pipeline.py)
against the JAX package's ray_tpu/parallel/pipeline.py, the counterparts of
tests/test_parallel.py:42-92 and :254-330, on four gloo processes
(``tests/torch_gloo.py``).

JAX initializes the fp32 ``tiny(max_seq_len=32, n_layers=4)`` weights; the
four ranks load them through ``params_from_numpy`` into
``make_sharded_state(..., mesh=)`` and run every case below in one spawn,
on batches of 8 made from numpy seeds, while the pytest process runs the
JAX side on 4 of its 8 CPU devices over a mesh of the same shape.
Tolerances, each with its reason (the reference's own, tests/
test_parallel.py):

- fp32 GPipe: loss and every gradient within 1e-5 of JAX's
  ``pipeline_loss_fn`` and of the port's one-device ``loss_fn`` (the same
  math, sums over microbatches and stages in another order);
- fp32 1F1B: loss within 1e-5, gradients within 1e-4 (the hand-written
  backward accumulates per microbatch, vocab-parallel scoring);
- 3 train steps of ``make_pipeline_train_step`` under each schedule, and
  of the non-pipelined step over dp 2 x pp 2: losses and grad norms at rtol
  1e-5, parameters at atol 1e-5 (as tests/test_torch_sharded_train.py);
- bf16 (GPipe): the loss at rtol 5e-3 (tests/test_model.py:138).

Beside them: 1F1B's saved-activation peak below GPipe's (pp 4, M 8,
``d_model=128, d_ff=512, max_seq_len=64``, tests/test_parallel.py:307-330);
every ``ValueError`` of the reference raised with the reference's message;
a pp 2 x tp 2 state that ``save_sharded`` writes restores bit for bit on
one device and through the JAX package's loader; and the sharded pump over
a pp mesh gives each rank its box.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpl
from ray_tpu.parallel import train_step as jts
from ray_tpu.train import sharded_checkpoint as jck
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import pipeline as tpl
from ray_tpu_torch.parallel import train_step as tts
from tests.torch_gloo import start_ranks

STEPS = 3
B, S = 8, 32
MESHES = {"pp4": {"pp": 4}, "dp2_pp2": {"dp": 2, "pp": 2},
          "pp2_tp2": {"pp": 2, "tp": 2}}
GPIPE_CASES = list(MESHES)  # M = 2 on each
ONE_F_ONE_B_CASES = {"pp4_m2": ("pp4", 2), "pp4_m4": ("pp4", 4),
                     "pp4_m8": ("pp4", 8), "pp2_tp2_m2": ("pp2_tp2", 2)}
VARIANTS = {"moe": {"moe_experts": 4, "moe_top_k": 2},
            "tied": {"tie_embeddings": True}}  # GPipe over dp 2 x pp 2
MEMORY = {"d_model": 128, "d_ff": 512, "max_seq_len": 64}

_SCRIPT = """
import json
import pickle
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from ray_tpu_torch.data import device_batches
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpl
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.parallel.dryrun import _pipeline_peak_bytes
from ray_tpu_torch.train import save_sharded
from ray_tpu_torch.train.sharded_checkpoint import _leaves

job = json.load(open(f"{work}/job.json"))
batch = {k: torch.from_numpy(v)
         for k, v in np.load(f"{work}/batch.npz").items()}
init = pickle.load(open(f"{work}/init.pkl", "rb"))
meshes = {}
out = {}


def mesh_of(name):
    if name not in meshes:
        meshes[name] = tmesh.build_mesh(
            tmesh.MeshConfig(**job["meshes"][name]), "cpu")
    return meshes[name]


def config(dtype=torch.float32, **kw):
    return ttf.TransformerConfig.tiny(dtype=dtype, max_seq_len=32,
                                      n_layers=4, **kw)


def state_on(mesh, cfg, weights=None):
    opt = tts.default_optimizer()
    state, sh = tts.make_sharded_state(
        cfg, opt, 0, params=params_from_numpy(weights or init, device="cpu"),
        mesh=mesh)
    return opt, state, sh


def named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in
                named(v, f"{prefix}/{k}" if prefix else k).items()}
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return {prefix: t.detach().float().numpy()}


def gpipe_grads(mesh, cfg, m, weights=None):
    _, state, _ = state_on(mesh, cfg, weights)
    loss = tpl.pipeline_loss_fn(state.params, batch, cfg, mesh, m)
    assert isinstance(loss, DTensor)
    loss.backward()
    grads = ttf.tree_map(lambda p: tts._reduced_grad(p), state.params)
    return loss.full_tensor().item(), named(grads)


def save(name, loss, grads):
    out[name] = loss
    if rank == 0:
        np.savez(f"{work}/grads_{name}.npz", **grads)


# GPipe over each mesh, M = 2
for name in job["gpipe"]:
    save(f"gpipe_{name}", *gpipe_grads(mesh_of(name), config(), 2))

# 1F1B: grads returned as DTensors the step reduces into the placements
for name, (mesh_name, m) in job["1f1b"].items():
    mesh = mesh_of(mesh_name)
    _, state, _ = state_on(mesh, config())
    loss, grads = tpl.pipeline_grads_1f1b(state.params, batch, config(),
                                          mesh, m)
    out[f"placements_{name}"] = {
        k: [repr(p) for p in g.placements] for k, g in (
            ("layers", grads["layers"]["mlp"]["wi"]),
            ("lm_head", grads["lm_head"]), ("embed", grads["embed"]),
            ("final_ln", grads["final_ln"]["scale"]))}
    reduced = tts._tree_zip(
        lambda g, p: g.redistribute(p.device_mesh, p.placements), grads,
        state.params)
    save(f"1f1b_{name}", loss.full_tensor().item(), named(reduced))

# GPipe with MoE and with a tied head, over dp 2 x pp 2
for name, kw in job["variants"].items():
    weights = pickle.load(open(f"{work}/init_{name}.pkl", "rb"))
    save(f"gpipe_{name}", *gpipe_grads(mesh_of("dp2_pp2"), config(**kw), 2,
                                       weights))

# bf16 GPipe loss
cfg16 = config(torch.bfloat16)
_, state, _ = state_on(mesh_of("dp2_pp2"), cfg16)
with torch.no_grad():
    out["bf16_loss"] = tpl.pipeline_loss_fn(
        state.params, batch, cfg16, mesh_of("dp2_pp2"), 2).full_tensor().item()


def train(mesh, step_of):
    opt, state, sh = state_on(mesh, config())
    step = step_of(opt, sh)
    metrics = []
    for _ in range(job["steps"]):
        state, m = step(state, batch)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    return metrics, named(state.params)


# make_pipeline_train_step under each schedule, and step 0: the
# non-pipelined step over a mesh with pp > 1
mesh = mesh_of("dp2_pp2")
runs = {sched: train(mesh, lambda opt, sh, sched=sched:
                     tpl.make_pipeline_train_step(
                         config(), opt, 2, mesh=mesh, state_shardings=sh,
                         schedule=sched))
        for sched in ("gpipe", "1f1b")}
runs["nonpipelined"] = train(mesh, lambda opt, sh: tts.make_train_step(
    config(), opt, mesh=mesh, state_shardings=sh))
for name, (metrics, params) in runs.items():
    out[f"train_{name}"] = metrics
    if rank == 0:
        np.savez(f"{work}/params_{name}.npz", **params)

# the local batch must divide into microbatches
try:
    tpl.pipeline_loss_fn(state.params, batch, cfg16, mesh_of("dp2_pp2"), 3)
except ValueError as e:
    out["refusal_batch"] = str(e)

# 1F1B's saved-activation peak against GPipe's
mem_cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, n_layers=4,
                                     **job["memory"])
out["peak_bytes"] = {
    sched: _pipeline_peak_bytes({"dp": 1, "pp": 4}, mem_cfg, 8, sched, "cpu",
                                seq=job["memory"]["max_seq_len"])
    for sched in ("1f1b", "gpipe")}

# a pp 2 x tp 2 state after one 1F1B step, saved
mesh = mesh_of("pp2_tp2")
opt, state, sh = state_on(mesh, config())
tpl.make_pipeline_train_step(config(), opt, 2, mesh=mesh, state_shardings=sh,
                             schedule="1f1b")(state, batch)
save_sharded(state, f"{work}/ckpt_pp2_tp2", step=1, wait=True)
stack = state.params["layers"]["attn"]["wq"]
out["ckpt_stack_placements"] = [repr(p) for p in stack.placements]
arrays = {}
for key, leaf in _leaves(state):  # full_tensor is a collective: every rank
    t = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
    arrays[key] = (t.detach().numpy().copy() if isinstance(t, torch.Tensor)
                   else np.array(t))
if rank == 0:
    with open(f"{work}/ckpt_arrays.pkl", "wb") as f:
        pickle.dump(arrays, f)

# the pump over a pp mesh: each rank its box, whole over pp
mesh = mesh_of("dp2_pp2")
m_, placements = tts.batch_sharding(mesh)
got = list(device_batches(lambda: iter([{k: v.numpy() for k, v in
                                         batch.items()}]), 2,
                          sharding=(m_, placements)))
coord = mesh.get_coordinate()
box = tmesh.shard_box(tuple(batch["tokens"].shape), tuple(mesh.shape),
                      placements, coord)
rows = slice(*box[0])
for k, v in got[0].items():
    assert tuple(v.placements) == tuple(placements)
    assert torch.equal(v.to_local(), batch[k][rows])
out["pump"] = {"coord": list(coord), "rows": list(box[0]),
               "placements": [repr(p) for p in placements]}
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(out, f)
"""


def _batch(vocab, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _jax_config(dtype=jnp.float32, **kw):
    return jtf.TransformerConfig.tiny(**{"dtype": dtype, "max_seq_len": S,
                                         "n_layers": 4, **kw})


def _jax_mesh(sizes):
    return jmesh.build_mesh(jmesh.MeshConfig(**sizes),
                            devices=jax.devices()[:4])


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _named(v, f"{prefix}/{k}" if prefix else
                                     k).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float32)}


def _jax_gpipe(cfg, sizes, m, params, batch):
    mesh = _jax_mesh(sizes)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jpl.pipeline_loss_fn(p, b, cfg, mesh,
                                          num_microbatches=m)))(params, batch)
    return float(loss), _named(grads)


def _jax_1f1b(cfg, sizes, m, params, batch):
    mesh = _jax_mesh(sizes)
    loss, grads = jax.jit(
        lambda p, b: jpl.pipeline_grads_1f1b(p, b, cfg, mesh,
                                             num_microbatches=m))(params,
                                                                  batch)
    return float(loss), _named(grads)


def _jax_train(cfg, sizes, step_of, batch):
    """STEPS steps of JAX's state on a mesh of ``sizes``: (loss, grad norm)
    per step and the final params."""
    mesh = _jax_mesh(sizes)
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(cfg, mesh, opt, jax.random.key(0))
    step = step_of(mesh, opt, sh)
    data_sh = jts.batch_sharding(mesh)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, _named(jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """One four-rank run of every case, and the JAX side of each, computed
    while the ranks work."""
    work = tmp_path_factory.mktemp("pipeline")
    cfg = _jax_config()
    batch = _batch(cfg.vocab_size)
    np.savez(work / "batch.npz", **batch)
    init = jax.tree.map(np.array, jtf.init_params(cfg, jax.random.key(0)))
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    inits = {}
    for name, kw in VARIANTS.items():
        inits[name] = jax.tree.map(np.array, jtf.init_params(
            _jax_config(**kw), jax.random.key(0)))
        with open(work / f"init_{name}.pkl", "wb") as f:
            pickle.dump(inits[name], f)
    (work / "job.json").write_text(json.dumps({
        "meshes": MESHES, "gpipe": GPIPE_CASES,
        "1f1b": ONE_F_ONE_B_CASES, "variants": VARIANTS, "steps": STEPS,
        "memory": MEMORY, "seq": S}))
    ranks = start_ranks(_SCRIPT, 4, work, timeout=300)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {"gpipe": {n: _jax_gpipe(cfg, MESHES[n], 2, init, jb)
                     for n in GPIPE_CASES},
           "1f1b": {n: _jax_1f1b(cfg, MESHES[mesh], m, init, jb)
                    for n, (mesh, m) in ONE_F_ONE_B_CASES.items()},
           "variants": {n: _jax_gpipe(_jax_config(**kw), MESHES["dp2_pp2"],
                                      2, inits[n], jb)
                        for n, kw in VARIANTS.items()}}
    cfg16 = _jax_config(jnp.bfloat16)
    mesh = _jax_mesh(MESHES["dp2_pp2"])
    ref["bf16_loss"] = float(jax.jit(
        lambda p, b: jpl.pipeline_loss_fn(p, b, cfg16, mesh,
                                          num_microbatches=2))(init, jb))
    ref["train"] = {
        sched: _jax_train(cfg, MESHES["dp2_pp2"],
                          lambda mesh, opt, sh, sched=sched:
                          jpl.make_pipeline_train_step(
                              cfg, mesh, opt, sh, 2, schedule=sched), batch)
        for sched in ("gpipe", "1f1b")}
    ref["train"]["nonpipelined"] = _jax_train(
        cfg, MESHES["dp2_pp2"],
        lambda mesh, opt, sh: jts.make_train_step(cfg, mesh, opt, sh), batch)

    outs = ranks.wait()
    results = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(4)]
    return work, results, ref, outs


def _one_device(cfg, init, batch):
    params = ttf.tree_map(lambda t: t.requires_grad_(True),
                          params_from_numpy(init, device="cpu"))
    loss = ttf.loss_fn(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg)
    loss.backward()
    return loss.item(), _named(ttf.tree_map(lambda p: p.grad, params))


def _assert_grads(got, want, atol, case):
    assert sorted(got) == sorted(want), case
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol,
                                   err_msg=f"{case}: {k}")


def _grads(work, name):
    with np.load(work / f"grads_{name}.npz") as f:
        return dict(f)


@pytest.mark.parametrize("case", GPIPE_CASES)
def test_gpipe_matches_jax(pipeline_run, case):
    work, results, ref, _ = pipeline_run
    loss, grads = ref["gpipe"][case]
    for r in results:
        assert abs(r[f"gpipe_{case}"] - loss) < 1e-5, (r[f"gpipe_{case}"],
                                                      loss)
    _assert_grads(_grads(work, f"gpipe_{case}"), grads, 1e-5, case)


@pytest.mark.parametrize("case", GPIPE_CASES)
def test_gpipe_matches_the_one_device_loss_fn(pipeline_run, case):
    work, results, _, _ = pipeline_run
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=S,
                                     n_layers=4)
    init = pickle.load(open(work / "init.pkl", "rb"))
    loss, grads = _one_device(cfg, init, dict(np.load(work / "batch.npz")))
    assert abs(results[0][f"gpipe_{case}"] - loss) < 1e-5
    _assert_grads(_grads(work, f"gpipe_{case}"), grads, 1e-5, case)


@pytest.mark.parametrize("case", list(ONE_F_ONE_B_CASES))
def test_1f1b_matches_jax(pipeline_run, case):
    work, results, ref, _ = pipeline_run
    loss, grads = ref["1f1b"][case]
    for r in results:
        assert abs(r[f"1f1b_{case}"] - loss) < 1e-5, (r[f"1f1b_{case}"], loss)
    _assert_grads(_grads(work, f"1f1b_{case}"), grads, 1e-4, case)


@pytest.mark.parametrize("case", list(ONE_F_ONE_B_CASES))
def test_1f1b_grads_lie_for_the_step_to_reduce(pipeline_run, case):
    """The layer stack's grads Shard(0) over pp, the head's Shard(1), the
    embedding's and the final norm's partial sums over pp, as the
    reference's ``finalize`` leaves them before its psums."""
    _, results, _, _ = pipeline_run
    mesh = MESHES[ONE_F_ONE_B_CASES[case][0]]
    names = [a for a in ("dp", "pp", "ep", "sp", "tp") if mesh.get(a, 1) > 1]
    pp = names.index("pp")
    got = results[0][f"placements_{case}"]
    assert got["layers"][pp] == "Shard(dim=0)"
    assert got["lm_head"][pp] == "Shard(dim=1)"
    assert got["embed"][pp] == got["final_ln"][pp] == "Partial(sum)"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gpipe_variant_matches_jax(pipeline_run, variant):
    """GPipe with 4 experts (top-2; the aux divided by n_layers · M · dp,
    tests of ``pipeline.py:218-221``) and with a tied head (``embed.T``)."""
    work, results, ref, _ = pipeline_run
    loss, grads = ref["variants"][variant]
    assert abs(results[0][f"gpipe_{variant}"] - loss) < 1e-5
    _assert_grads(_grads(work, f"gpipe_{variant}"), grads, 1e-5, variant)


@pytest.mark.parametrize("run", ["gpipe", "1f1b", "nonpipelined"])
def test_train_steps_match_jax(pipeline_run, run):
    """3 steps of ``make_pipeline_train_step`` under each schedule, and of
    the non-pipelined step over dp 2 x pp 2 (the layer stack split over pp,
    each layer made whole before it runs), against JAX's over the same
    mesh."""
    work, results, ref, _ = pipeline_run
    jmetrics, jparams = ref["train"][run]
    for r in results:
        assert r[f"train_{run}"] == results[0][f"train_{run}"]
    got = results[0][f"train_{run}"]
    np.testing.assert_allclose(got, jmetrics, rtol=1e-5)
    assert got[-1][0] < got[0][0]  # the repeated batch is learned
    with np.load(work / f"params_{run}.npz") as f:
        _assert_grads(dict(f), jparams, 1e-5, run)


def test_bf16_loss_within_the_reference_tolerance(pipeline_run):
    _, results, ref, _ = pipeline_run
    np.testing.assert_allclose(results[0]["bf16_loss"], ref["bf16_loss"],
                               rtol=5e-3)


def test_1f1b_saved_activation_peak_below_gpipes(pipeline_run):
    _, results, _, _ = pipeline_run
    for r in results:
        peak = r["peak_bytes"]
        assert 0 < peak["1f1b"] < peak["gpipe"], peak


def test_local_batch_must_divide_into_microbatches(pipeline_run):
    _, results, _, _ = pipeline_run
    cfg = _jax_config()
    mesh = _jax_mesh(MESHES["dp2_pp2"])
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
    with pytest.raises(ValueError) as want:
        jax.jit(lambda p, b: jpl.pipeline_loss_fn(p, b, cfg, mesh,
                                                  num_microbatches=3))(
            jtf.init_params(cfg, jax.random.key(0)), batch)
    for r in results:
        assert r["refusal_batch"] == str(want.value)


class _Mesh:
    """Enough of a DeviceMesh for the checks that run before any
    collective: its axis names and sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]


REFUSALS = {
    "gpipe_sp": ("gpipe", {"sp": 2, "pp": 2}, {}),
    "gpipe_ep": ("gpipe", {"ep": 2, "pp": 2}, {}),
    "gpipe_stages": ("gpipe", {"pp": 4}, {"n_layers": 2}),
    "gpipe_attention": ("gpipe", {"pp": 2}, {"attn_impl": "flash"}),
    "1f1b_sp": ("1f1b", {"sp": 2, "pp": 2}, {}),
    "1f1b_ep": ("1f1b", {"ep": 2, "pp": 2}, {}),
    "1f1b_stages": ("1f1b", {"pp": 4}, {"n_layers": 2}),
    "1f1b_vocab": ("1f1b", {"pp": 4}, {"vocab_size": 250}),
    "1f1b_attention": ("1f1b", {"pp": 2}, {"attn_impl": "flash"}),
    "1f1b_moe": ("1f1b", {"pp": 2}, {"moe_experts": 4}),
    "1f1b_tied": ("1f1b", {"pp": 2}, {"tie_embeddings": True}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_the_reference(case):
    """Each ``ValueError`` of the reference, with its message, raised before
    anything runs (a stand-in mesh: no process group is needed)."""
    schedule, sizes, kw = REFUSALS[case]
    jcfg = _jax_config(**kw)
    jfn = (jpl.pipeline_loss_fn if schedule == "gpipe"
           else jpl.pipeline_grads_1f1b)
    batch = {k: jnp.asarray(v) for k, v in _batch(256).items()}
    with pytest.raises(ValueError) as want:
        jfn(jtf.init_params(jcfg, jax.random.key(0)), batch, jcfg,
            _jax_mesh(sizes), num_microbatches=2)
    tcfg = ttf.TransformerConfig.tiny(**{"max_seq_len": S, "n_layers": 4,
                                         **kw})
    tfn = (tpl.pipeline_loss_fn if schedule == "gpipe"
           else tpl.pipeline_grads_1f1b)
    with pytest.raises(ValueError) as got:
        tfn({}, {}, tcfg, _Mesh(**sizes), 2)
    assert str(got.value) == str(want.value)


def test_an_unknown_schedule_is_refused():
    cfg = ttf.TransformerConfig.tiny()
    with pytest.raises(ValueError, match="unknown pipeline schedule 'zb'"):
        tpl.make_pipeline_train_step(cfg, tts.default_optimizer(), 2,
                                     mesh=_Mesh(pp=2), schedule="zb")


def test_pp_tp_checkpoint_restores_on_one_device(pipeline_run):
    from ray_tpu_torch.train import load_sharded
    from ray_tpu_torch.train.sharded_checkpoint import _leaves

    work, results, _, _ = pipeline_run
    assert results[0]["ckpt_stack_placements"] == ["Shard(dim=0)",
                                                   "Shard(dim=2)"]
    want = pickle.load(open(work / "ckpt_arrays.pkl", "rb"))
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=S,
                                     n_layers=4)
    state, _ = tts.make_sharded_state(cfg, tts.default_optimizer(), 9,
                                      device="cpu")
    load_sharded(str(work / "ckpt_pp2_tp2"), like=state)
    got = {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v)) for k, v in _leaves(state)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pp_tp_checkpoint_restores_in_jax(pipeline_run):
    work, _, _, _ = pipeline_run
    want = pickle.load(open(work / "ckpt_arrays.pkl", "rb"))
    mesh = _jax_mesh(MESHES["pp2_tp2"])
    template, _ = jts.make_sharded_state(_jax_config(), mesh,
                                         jts.default_optimizer(),
                                         jax.random.key(1))
    jstate = jck.load_sharded(str(work / "ckpt_pp2_tp2"), like=template)
    got = {jax.tree_util.keystr(p): np.asarray(x)
           for p, x in jax.tree_util.tree_leaves_with_path(jstate)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jstate.params["layers"]["attn"]["wq"].sharding.spec[0] == "pp"


def test_sharded_pump_over_a_pp_mesh(pipeline_run):
    """Each rank got its rows of the batch (checked in the rank against the
    global batch), the same on both pp coordinates of a dp row."""
    _, results, _, _ = pipeline_run
    rows = {tuple(r["pump"]["coord"]): r["pump"]["rows"] for r in results}
    assert sorted(rows) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert rows[(0, 0)] == rows[(0, 1)] == [0, B // 2]
    assert rows[(1, 0)] == rows[(1, 1)] == [B // 2, B]
    for r in results:
        assert r["pump"]["placements"] == ["Shard(dim=0)", "Replicate()"]
