"""The port's mixture-of-experts FFN (ray_tpu_torch/ops/moe.py) and the MoE
transformer, held against the JAX package's (ray_tpu/ops/moe.py) on the
CPU: the counterpart of tests/test_parallel.py:95-181.

One device: seeded numpy inputs through both packages' ``moe_ffn`` at fp32
(top-1 and top-2, capacity factor E, where nothing is dropped, and E / N,
where most picks are), the reference's brute-force and capacity-drop cases,
the index dispatch against the one-hot plain version, and ``loss_fn`` and
greedy ``generate`` of ``tiny`` with 4 experts.

Four gloo ranks (one spawn, ``tests/torch_gloo.py``): the MoE transformer
over dp 2 x ep 2 (dense attention) and over ep 2 x sp 2 with ring attention
and capacity factor 1.0 (picks dropped, so each sp rank's buffer positions
must start after the lower sp ranks' picks) under remat "dots" (the hops,
the count all-gather and the expert all-to-alls run again in the
backward's recompute). Each: the forward's logits and
aux, and 3 fp32 sharded train steps' losses and gathered parameters,
against JAX's sharded forward and step on a mesh of the same shape (4 of
the pytest process's CPU devices); then the state, experts split over ep,
saved and restored onto one rank.

Tolerances, each with its reason:

- fp32 ``moe_ffn`` against JAX: atol 1e-5 on the output (the same math,
  products summed in another order; ~2e-7 seen), rtol 1e-6 on aux (a sum
  of E products; ~1e-7 seen); the top-k masks and the dropped picks equal;
- index dispatch against the one-hot plain version: fp32 atol 1e-6 (the
  final <= k-term sum in another order); bf16 one bf16 ulp relative
  (2^-8: both round an fp32 sum to bf16 once, and sums equal to fp32
  rounding may round apart);
- sharded against JAX's sharded step: loss and grad norm rtol 1e-5 per step,
  parameters atol 1e-5 after 3 steps, logits atol 1e-5 and aux rtol 1e-6
  (as tests/test_torch_sharded_train.py).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generation as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import generation as tgen
from ray_tpu_torch.models import quant as tquant
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import moe as tmoe
from tests.torch_gloo import run_ranks


def _inputs(g, n, d, f, e, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, n, d), dtype=np.float32),
            (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _dropped_brute_force(probs, k, cap):
    """Picks past capacity by GShard's rule, one token at a time: slot 0 of
    every token of a group before slot 1, each expert's rows in order."""
    dropped = 0
    for grp in probs:
        order = np.stack([np.argsort(-p, kind="stable")[:k] for p in grp])
        used = np.zeros(probs.shape[-1], np.int64)
        for s in range(k):
            for e in order[:, s]:
                dropped += used[e] >= cap
                used[e] += 1
    return int(dropped)


CASES = {  # (top_k, capacity_factor): E drops nothing, E / N drops most
    "top1_no_drops": (1, 4.0), "top2_no_drops": (2, 4.0),
    "top1_drops": (1, 4.0 / 16), "top2_drops": (2, 4.0 / 16),
    "top2_some_drops": (2, 1.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    top_k, cf = CASES[case]
    g, n, d, f, e = 3, 16, 8, 16, 4
    x, rw, wi, wo = _inputs(g, n, d, f, e)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), rw, wi, wo, top_k=top_k,
                              capacity_factor=cf)
    tx, trw, twi, two = _torch(x, rw, wi, wo)
    out, aux = tmoe.moe_ffn(tx, trw, twi, two, top_k=top_k,
                            capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)

    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", x, rw), axis=-1)
    jgates, jmasks = jmoe._top_k_mask(probs, top_k)
    gates, masks = tmoe._top_k_mask(torch.from_numpy(np.array(probs)),
                                    top_k)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), atol=1e-7)
    cap = tmoe.capacity(n, e, top_k, cf)
    assert cap == max(1, int(np.ceil(top_k * n * cf / e)))
    routing = tmoe.route(tx, trw, top_k, cap)
    want = _dropped_brute_force(np.asarray(probs), top_k, cap)
    assert int(routing.dropped()) == want
    assert (want == 0) == case.endswith("no_drops")


def test_top_k_takes_the_first_index_of_a_tie():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]]])
    _, masks = tmoe._top_k_mask(probs, 2)
    _, jmasks = jmoe._top_k_mask(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    assert masks[0, 0, 0].argmax() == 0 and masks[1, 0, 0].argmax() == 1
    assert masks[0, 0, 1].argmax() == 1 and masks[1, 0, 1].argmax() == 2


def test_moe_matches_brute_force():
    """tests/test_parallel.py:95-114 on the port."""
    g, n, d, f, e, k = 2, 16, 8, 16, 4, 2
    x, rw, wi, wo = _inputs(g, n, d, f, e, seed=5)
    out, aux = tmoe.moe_ffn(*_torch(x, rw, wi, wo), top_k=k,
                            capacity_factor=float(e))
    probs = np.asarray(jax.nn.softmax(x @ rw, -1))
    ref = np.zeros((g, n, d), np.float32)
    for gi in range(g):
        for ni in range(n):
            chosen = np.argsort(-probs[gi, ni])[:k]
            gsum = probs[gi, ni][chosen].sum()
            for ei in chosen:
                h = np.asarray(jax.nn.gelu(x[gi, ni] @ wi[ei]))
                ref[gi, ni] += (probs[gi, ni, ei] / gsum) * (h @ wo[ei])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert aux.item() > 0.0


def test_moe_capacity_drops_tokens():
    """tests/test_parallel.py:117-131 on the port: capacity 1 and a router
    sending every token to expert 0 serve the first token only."""
    g, n, d, f, e = 1, 8, 4, 8, 2
    x = torch.ones((g, n, d))
    rw = torch.zeros((d, e))
    rw[:, 0] = 10.0
    out, _ = tmoe.moe_ffn(x, rw, torch.full((e, d, f), 0.1),
                          torch.full((e, f, d), 0.1), top_k=1,
                          capacity_factor=e / n)
    norms = torch.linalg.vector_norm(out[0], dim=-1)
    assert norms[0] > 0.0
    np.testing.assert_allclose(norms[1:].numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [4.0, 1.0], ids=["no_drops", "drops"])
def test_index_dispatch_matches_the_one_hot_plain_version(dtype, cf):
    dt = getattr(torch, dtype)
    x, rw, wi, wo = _torch(*_inputs(4, 32, 16, 32, 4, seed=2))
    x = x.to(dt)
    got, aux = tmoe.moe_ffn(x, rw, wi, wo, top_k=2, capacity_factor=cf)
    want, want_aux = tmoe.moe_ffn_reference(x, rw, wi, wo, top_k=2,
                                            capacity_factor=cf)
    assert got.dtype == want.dtype == dt
    assert aux.item() == want_aux.item()
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)


def test_index_dispatch_gradients_match_the_one_hot_plain_version():
    arrays = _inputs(2, 16, 8, 16, 4, seed=3)
    grads = []
    for fn in (tmoe.moe_ffn, tmoe.moe_ffn_reference):
        ts = [t.requires_grad_(True) for t in _torch(*arrays)]
        out, aux = fn(*ts, top_k=2, capacity_factor=1.0)
        (out.square().sum() + aux).backward()
        grads.append([t.grad.numpy() for t in ts])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_int8_expert_weights_dequantize_as_the_reference_astypes():
    """QTensor expert weights (models/quant.py) go through ``.to(dtype)``:
    the FFN equals itself on the dequantized weights."""
    x, rw, wi, wo = _torch(*_inputs(2, 16, 8, 16, 4, seed=4))
    qwi, qwo = tquant.quantize_tensor(wi, (1,)), tquant.quantize_tensor(
        wo, (1,))
    got, _ = tmoe.moe_ffn(x, rw, qwi, qwo)
    want, _ = tmoe.moe_ffn(x, rw, qwi.to(torch.float32),
                           qwo.to(torch.float32))
    assert torch.equal(got, want)


def test_aux_over_shards_is_not_the_mean_of_per_shard_aux():
    """The first trap, shown on data: the Switch aux of two halves of the
    groups, averaged, is not the aux of the whole. The sharded runs below
    must (and do) give the whole's."""
    x, rw, wi, wo = _torch(*_inputs(4, 16, 8, 16, 4, seed=6))
    whole = tmoe.moe_ffn(x, rw, wi, wo)[1].item()
    halves = [tmoe.moe_ffn(x[i:i + 2], rw, wi, wo)[1].item()
              for i in (0, 2)]
    assert abs(np.mean(halves) - whole) > 1e-3 * whole


def test_positions_across_sequence_shards_need_the_lower_shards_counts():
    """The second trap, shown on data: routing the second half of the
    sequence on its own keeps picks the whole sequence drops; with the
    first half's counts (``counts_fn``) it keeps exactly the whole's."""
    x, rw, _, _ = _torch(*_inputs(2, 32, 8, 16, 4, seed=7))
    cap = tmoe.capacity(32, 4, 2, 1.0)
    whole = tmoe.route(x, rw, 2, cap)
    first = tmoe.route(x[:, :16], rw, 2, cap)
    second_alone = tmoe.route(x[:, 16:], rw, 2, cap)

    def counts_fn(counts):
        lower = first.masks.sum(dim=2)
        return lower, lower + counts

    second = tmoe.route(x[:, 16:], rw, 2, cap, counts_fn)
    assert not torch.equal(second_alone.keep, whole.keep[:, :, 16:])
    assert torch.equal(second.keep, whole.keep[:, :, 16:])
    assert torch.equal(second.position, whole.position[:, :, 16:])


def _moe_configs(max_seq_len=32, **kw):
    base = dict(max_seq_len=max_seq_len, moe_experts=4, moe_top_k=2, **kw)
    return (jtf.TransformerConfig.tiny(dtype=jnp.float32, **base),
            ttf.TransformerConfig.tiny(dtype=torch.float32, **base))


def _batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def test_moe_loss_and_grads_match_jax():
    jcfg, tcfg = _moe_configs()
    jp = jtf.init_params(jcfg, jax.random.key(0))
    batch = _batch(jcfg.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = ttf.tree_map(lambda t: t.requires_grad_(True), params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"))
    loss = ttf.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                       tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = ttf.tree_leaves(jax.tree.map(np.asarray, jg))
    for i, (p, want) in enumerate(zip(ttf.tree_leaves(tp), jleaves)):
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5,
                                   err_msg=str(i))


def test_moe_generate_greedy_matches_jax():
    jcfg, tcfg = _moe_configs(max_seq_len=64)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ref = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6)
    out = tgen.generate(tp, prompt, tcfg, max_new_tokens=6, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- four gloo ranks ---------------------------------------------------------

STEPS = 3
MESH_CASES = {"dp2_ep2": ({"dp": 2, "ep": 2}, {"attn_impl": "dense"}),
              "ep2_sp2_ring": ({"ep": 2, "sp": 2},
                               {"attn_impl": "ring",
                                "moe_capacity_factor": 1.0, "remat": True,
                                "remat_policy": "dots"})}

_SCRIPT = """
import json
import pickle
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import load_sharded, save_sharded


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def state_tensors(state):
    out = [state.step]
    for p in ttf.tree_leaves(state.params):
        st = state.opt_state.state[p]
        out += [p.detach(), st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


jobs = json.load(open(f"{work}/jobs.json"))
results = {}
for name, job in jobs.items():
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**job["sizes"]), "cpu")
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32,
                                     moe_experts=4, moe_top_k=2, **job["kw"])
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(f"{work}/batch.npz").items()}
    init = pickle.load(open(f"{work}/init_{name}.pkl", "rb"))
    opt = tts.default_optimizer()
    state, sh = tts.make_sharded_state(
        cfg, opt, 0, params=params_from_numpy(init, device="cpu"), mesh=mesh)
    wi = state.params["layers"]["moe"]["wi"]
    ep_dim = mesh.mesh_dim_names.index("ep")
    assert wi.placements[ep_dim] == Shard(1), wi.placements
    _, placements = tts.batch_sharding(mesh)
    tokens = distribute_tensor(batch["tokens"], mesh, placements,
                               src_data_rank=None)
    with torch.no_grad():
        logits, aux = ttf.forward(state.params, tokens, cfg, mesh,
                                  return_aux=True)
    logits, aux = full(logits), full(aux)
    step = tts.make_train_step(cfg, opt, mesh=mesh, state_shardings=sh)
    metrics = []
    for _ in range(job["steps"]):
        state, m = step(state, batch)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    leaves = [full(p).detach().numpy() for p in ttf.tree_leaves(state.params)]
    whole = [full(t) for t in state_tensors(state)]
    path = f"{work}/ckpt_{name}"
    save_sharded(state, path, step=job["steps"], wait=True)
    dist.barrier()
    differing = None
    if rank == 0:
        np.savez(f"{work}/out_{name}.npz", logits=logits.numpy(),
                 aux=aux.numpy(), **{str(i): a for i, a in enumerate(leaves)})
        # a one-device state of the same tree, zeroed, filled by the load
        one, _ = tts.make_sharded_state(
            cfg, tts.default_optimizer(), 0, device="cpu",
            params=params_from_numpy(init, device="cpu"))
        with torch.no_grad():
            for p in ttf.tree_leaves(one.params):
                p.zero_()
        load_sharded(path, like=one)
        differing = sum(not torch.equal(a, b)
                        for a, b in zip(state_tensors(one), whole))
    dist.barrier()
    results[name] = {"metrics": metrics, "restore_differing": differing}
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(results, f)
"""


def _jax_sharded(jcfg, sizes, batch):
    """JAX's sharded forward (logits, aux) and 3 steps on a mesh of
    ``sizes``, from JAX's initial params (returned as numpy)."""
    n = int(np.prod(list(sizes.values())))
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**sizes),
                            devices=jax.devices()[:n])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0))
    init = jax.tree.map(np.array, state.params)
    data_sh = jts.batch_sharding(mesh)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh)
          for k, v in batch.items()}
    logits, aux = jax.jit(lambda p, t: jtf.forward(
        p, t, jcfg, mesh, return_aux=True))(state.params, jb["tokens"])
    logits, aux = np.asarray(logits), float(aux)
    step = jts.make_train_step(jcfg, mesh, opt, sh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = [np.asarray(x, np.float32) for x in ttf.tree_leaves(
        jax.tree.map(np.asarray, state.params))]
    return init, logits, aux, metrics, leaves


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """One four-rank run of both mesh cases, beside JAX's."""
    work = tmp_path_factory.mktemp("moe_ranks")
    batch = _batch(256)
    np.savez(work / "batch.npz", **batch)
    ref = {}
    for name, (sizes, kw) in MESH_CASES.items():
        jcfg, _ = _moe_configs(**kw)
        init, *ref[name] = _jax_sharded(jcfg, dict(sizes), batch)
        with open(work / f"init_{name}.pkl", "wb") as f:
            pickle.dump(init, f)
    (work / "jobs.json").write_text(json.dumps({
        name: {"sizes": sizes, "kw": kw, "steps": STEPS}
        for name, (sizes, kw) in MESH_CASES.items()}))
    run_ranks(_SCRIPT, 4, work, timeout=240)
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(4)]
    outs = {name: np.load(work / f"out_{name}.npz") for name in MESH_CASES}
    return ranks, outs, ref


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_moe_forward_matches_jax(moe_ranks, case):
    """Logits, and the aux loss over shards: the reference's global-mean
    aux (frac and mean_prob reduced over the token axes, then multiplied)."""
    _, outs, ref = moe_ranks
    logits, aux = ref[case][0], ref[case][1]
    np.testing.assert_allclose(outs[case]["logits"], logits, atol=1e-5)
    np.testing.assert_allclose(float(outs[case]["aux"]), aux, rtol=1e-6)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_moe_steps_match_jax(moe_ranks, case):
    ranks, outs, ref = moe_ranks
    metrics, leaves = ref[case][2], ref[case][3]
    for r in ranks:
        assert r[case]["metrics"] == ranks[0][case]["metrics"]
    np.testing.assert_allclose(ranks[0][case]["metrics"], metrics, rtol=1e-5)
    for i, want in enumerate(leaves):
        np.testing.assert_allclose(outs[case][str(i)], want, atol=1e-5,
                                   err_msg=str(i))
    losses = [m[0] for m in ranks[0][case]["metrics"]]
    assert losses[-1] < losses[0]


def test_sequence_split_case_drops_picks():
    """The ep 2 x sp 2 case routes with picks past capacity at its first
    layer, so its equality with JAX above holds the sp positions to the
    reference's drops."""
    sizes, kw = MESH_CASES["ep2_sp2_ring"]
    jcfg, tcfg = _moe_configs(**kw)
    init = jtf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, init), device="cpu")
    tokens = torch.from_numpy(_batch(256)["tokens"])
    h = ttf._rms_norm(tp["embed"][tokens], tp["layers"]["ln1"]["scale"][0])
    cap = tmoe.capacity(32, 4, 2, kw["moe_capacity_factor"])
    assert int(tmoe.route(h, tp["layers"]["moe"]["router"][0], 2,
                          cap).dropped()) > 0


def test_ep_split_checkpoint_restores_onto_one_rank(moe_ranks):
    ranks, _, _ = moe_ranks
    for case in MESH_CASES:
        assert ranks[0][case]["restore_differing"] == 0
