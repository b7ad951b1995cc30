"""The port's train step over a device mesh (ray_tpu_torch/parallel/
train_step.py with ``mesh=``), the counterpart of tests/test_model.py:125-138,
on four gloo processes (``tests/torch_gloo.py``).

JAX initializes the ``tiny`` weights (flash attention); the four ranks load
them through ``params_from_numpy`` into ``make_sharded_state(..., mesh=)``
and take 3 steps on one batch made from a numpy seed, under
``DEFAULT_RULES`` on a 2 x 2 ("dp", "tp") mesh and under ``FSDP_RULES`` on
dp = 4. The same steps run on the port's one device and on the JAX
package's sharded step over a mesh of the same shape (4 of the pytest
process's CPU devices, Pallas in interpret mode). Tolerances, each with its
reason:

- float32 compute: loss and grad norm at rtol 1e-5 per step, parameters
  (gathered) at atol 1e-5 after 3 steps: the same math with sums split over
  shards and reduced in another order (~1e-7 on losses and ~4e-7 on
  parameters seen against the one-device port);
- bfloat16 compute (fp32 params, remat "dots"): the loss at the reference's
  rtol 5e-3 (tests/test_model.py:138; ~1e-4 seen).

Every gradient reaches the clip in its parameter's placements (reduced over
the batch axes), which each rank asserts.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import train_step as tts
from tests.torch_gloo import run_ranks

STEPS = 3
CASES = {"dp2_tp2_default": ({"dp": 2, "tp": 2}, "DEFAULT_RULES"),
         "dp4_fsdp": ({"dp": 4}, "FSDP_RULES")}
DTYPES = {"float32": (jnp.float32, torch.float32, {}),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       {"remat": True, "remat_policy": "dots"})}

_SCRIPT = """
import json
import pickle
import numpy as np
import torch
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

job = json.load(open(f"{work}/job.json"))
mesh = tmesh.build_mesh(tmesh.MeshConfig(**job["sizes"]), "cpu")
rules = getattr(tmesh, job["rules"])
batch = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/batch.npz").items()}
seen = []


class Recording(tts.ClippedAdamW):
    def clip_(self, grads):
        seen.append([tuple(g.placements) for g in grads])
        return super().clip_(grads)


results = {}
for dtype_name, kw in job["dtypes"].items():
    cfg = ttf.TransformerConfig.tiny(dtype=getattr(torch, dtype_name),
                                     max_seq_len=32, attn_impl="flash", **kw)
    init = pickle.load(open(f"{work}/init.pkl", "rb"))
    opt = Recording()
    state, sh = tts.make_sharded_state(
        cfg, opt, 0, params=params_from_numpy(init, device="cpu"),
        mesh=mesh, rules=rules)
    step = tts.make_train_step(cfg, opt, mesh=mesh, state_shardings=sh,
                               rules=rules)
    metrics = []
    for _ in range(job["steps"]):
        state, m = step(state, batch)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    leaves = ttf.tree_leaves(state.params)
    want = [tuple(p.placements) for p in leaves]
    assert [tuple(pl) for pl in ttf.tree_leaves(sh.params)] == want
    assert len(seen) == job["steps"] and all(s == want for s in seen), seen
    sharded = sum(any(not p.is_replicate() for p in pl) for pl in want)
    assert sharded > 0, want
    seen.clear()
    full = [p.full_tensor().detach().numpy() for p in leaves]
    results[dtype_name] = {"metrics": metrics, "sharded_leaves": sharded}
    if rank == 0:
        np.savez(f"{work}/params_{dtype_name}.npz",
                 **{str(i): a for i, a in enumerate(full)})
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(results, f)
"""


def _batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _configs(dtype_name):
    jdt, tdt, kw = DTYPES[dtype_name]
    return (jtf.TransformerConfig.tiny(dtype=jdt, max_seq_len=32,
                                       attn_impl="flash", **kw),
            ttf.TransformerConfig.tiny(dtype=tdt, max_seq_len=32,
                                       attn_impl="flash", **kw))


def _jax_run(jcfg, sizes, rules, batch):
    """JAX's sharded state and step on a mesh of ``sizes``: the initial
    params (numpy), per-step (loss, grad norm), and the final params."""
    n = int(np.prod(list(sizes.values())))
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**sizes),
                            devices=jax.devices()[:n])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0),
                                       rules=rules)
    init = jax.tree.map(np.array, state.params)  # copies: state is donated
    step = jts.make_train_step(jcfg, mesh, opt, sh, rules=rules)
    data_sh = jts.batch_sharding(mesh, rules)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics, jax.tree.map(np.asarray, state.params)


def _one_device_run(tcfg, init, batch):
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(
        tcfg, opt, 0, device="cpu",
        params=params_from_numpy(init, device="cpu"))
    step = tts.make_train_step(tcfg, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, tb)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, [p.detach().numpy() for p in ttf.tree_leaves(
        state.params)]


@pytest.fixture(scope="module", params=list(CASES))
def mesh_run(request, tmp_path_factory):
    """One four-rank run of a case (fp32, then bf16), beside the JAX
    sharded step and the one-device port on the same weights and batch."""
    sizes, rules = CASES[request.param]
    work = tmp_path_factory.mktemp(request.param)
    jcfg32, _ = _configs("float32")
    batch = _batch(jcfg32.vocab_size)
    np.savez(work / "batch.npz", **batch)
    ref = {}
    init = None
    for dtype_name in DTYPES:
        jcfg, tcfg = _configs(dtype_name)
        jinit, jmetrics, jparams = _jax_run(jcfg, sizes,
                                            getattr(jmesh, rules), batch)
        if init is None:
            init = jinit  # the same key: the same weights for both dtypes
            with open(work / "init.pkl", "wb") as f:
                pickle.dump(init, f)
        jleaves = [np.asarray(x, np.float32) for x in ttf.tree_leaves(
            jax.tree.map(np.asarray, jparams))]
        ref[dtype_name] = {"jax": (jmetrics, jleaves),
                           "one_device": _one_device_run(tcfg, init, batch)}
    (work / "job.json").write_text(json.dumps({
        "sizes": sizes, "rules": rules, "steps": STEPS,
        "dtypes": {k: v[2] for k, v in DTYPES.items()}}))
    run_ranks(_SCRIPT, 4, work, timeout=300)
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(4)]
    params = {d: [np.load(work / f"params_{d}.npz")[str(i)]
                  for i in range(len(ref[d]["jax"][1]))] for d in DTYPES}
    return ranks, params, ref


def test_fp32_sharded_step_matches_the_one_device_port(mesh_run):
    ranks, params, ref = mesh_run
    metrics, leaves = ref["float32"]["one_device"]
    for r in ranks:
        assert r["float32"]["metrics"] == ranks[0]["float32"]["metrics"]
    np.testing.assert_allclose(ranks[0]["float32"]["metrics"], metrics,
                               rtol=1e-5)
    for i, (got, want) in enumerate(zip(params["float32"], leaves)):
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(i))


def test_fp32_sharded_step_matches_the_jax_sharded_step(mesh_run):
    ranks, params, ref = mesh_run
    jmetrics, jleaves = ref["float32"]["jax"]
    np.testing.assert_allclose(ranks[0]["float32"]["metrics"], jmetrics,
                               rtol=1e-5)
    for i, (got, want) in enumerate(zip(params["float32"], jleaves)):
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(i))
    losses = [m[0] for m in ranks[0]["float32"]["metrics"]]
    assert losses[-1] < losses[0]  # the repeated batch is learned


def test_bf16_sharded_loss_within_the_reference_tolerance(mesh_run):
    ranks, _, ref = mesh_run
    got = np.array(ranks[0]["bfloat16"]["metrics"])[:, 0]
    for want in (ref["bfloat16"]["one_device"][0], ref["bfloat16"]["jax"][0]):
        np.testing.assert_allclose(got, np.array(want)[:, 0], rtol=5e-3)


def test_grads_reach_the_clip_in_their_parameters_placements(mesh_run):
    """Asserted in every rank at every step (``Recording.clip_``); here
    that the run had sharded parameters to reduce onto."""
    ranks, _, _ = mesh_run
    for r in ranks:
        for dtype_name in DTYPES:
            assert r[dtype_name]["sharded_leaves"] > 0
