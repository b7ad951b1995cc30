"""The port's device mesh (ray_tpu_torch/parallel/mesh.py) against the JAX
package's ray_tpu/parallel/mesh.py, and the pieces that run per shard
over it, on the CPU.

In the pytest process (no process group): ``MeshConfig.resolve`` against
JAX's; the port's placements and ``shard_box`` against the index boxes of
JAX's ``shardings_for(...)[leaf].devices_indices_map(shape)`` for every
parameter of the dense ``tiny`` model, under both rules tables, on four
mesh shapes, at every device coordinate (exact); the refusals. One
world-size-1 gloo group in process: a one-rank mesh trains bit for bit as
one device does.

On four gloo processes (a 2 x 2 ("dp", "tp") mesh, ``tests/torch_gloo.py``):
``flash_attention_sharded`` (the plain versions per shard) against JAX's
``flash_attention_sharded`` in interpret mode on the same layout over 4 of
the pytest process's CPU devices (fp32, atol 2e-5, as
tests/test_model.py:205-218); ``shard_box`` against DTensor's own local
tensors, uneven splits included (exact); the sharded batch pump; and
``dryrun_multidevice(4, "cpu")`` (parts 1, 2, 2c and 3).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.ops import flash_attention as jflash
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts
from tests.torch_gloo import free_port, run_ranks

MESHES = [dict(dp=8), dict(dp=2, tp=4), dict(dp=4, tp=2),
          dict(dp=2, ep=2, tp=2)]
MESH_IDS = ["dp8", "dp2_tp4", "dp4_tp2", "dp2_ep2_tp2"]


@pytest.mark.parametrize("sizes,n", [
    ({}, 8), ({"dp": 2, "tp": 4}, 8), ({"tp": 2}, 8),
    ({"dp": 2, "sp": -1, "tp": 2}, 8), ({"tp": 3}, 8),
    ({"dp": -1, "tp": -1}, 8), ({"dp": 2, "tp": 2}, 8), ({"dp": 1}, 1)],
    ids=["default", "dp2_tp4", "free_dp", "free_sp", "indivisible",
         "two_free", "wrong_product", "one"])
def test_mesh_config_resolve_matches_jax(sizes, n):
    def outcome(config):
        try:
            return config.resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(tmesh.MeshConfig(**sizes)) == outcome(
        jmesh.MeshConfig(**sizes))


def test_rules_tables_are_the_references():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.DEFAULT_RULES.rules == jmesh.DEFAULT_RULES.rules
    assert tmesh.FSDP_RULES.rules == jmesh.FSDP_RULES.rules


def _jax_box(index, shape):
    return [(0 if sl.start is None else sl.start,
             n if sl.stop is None else sl.stop)
            for sl, n in zip(index, shape)]


def _kept(sizes):
    """The axes the port's mesh keeps (more than one device; dp when none)
    with their sizes."""
    full = dict(zip(jmesh.MESH_AXES, jmesh.MeshConfig(**sizes).resolve(
        math.prod(sizes.values()))))
    kept = [(a, full[a]) for a in jmesh.MESH_AXES if full[a] > 1]
    return kept or [("dp", 1)], full


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "FSDP_RULES"])
@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_placements_and_boxes_match_jax(sizes, rules):
    n = math.prod(sizes.values())
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes),
                          devices=jax.devices()[:n])
    jrules, trules = getattr(jmesh, rules), getattr(tmesh, rules)
    cfg = ttf.TransformerConfig.tiny()
    logical = ttf.param_logical_axes(cfg)
    assert logical == jtf.param_logical_axes(jtf.TransformerConfig.tiny())
    shapes = ttf.tree_map(lambda t: tuple(t.shape),
                          ttf.init_params(cfg, 0, "cpu"))
    jsh = jmesh.shardings_for(jm, jrules, logical)
    batch_sh = jmesh.shardings_for(jm, jrules, {"batch": ("batch", "seq")})
    leaves = [("batch", ("batch", "seq"), (8, 32), batch_sh["batch"])]
    for path, axes in jax.tree_util.tree_leaves_with_path(
            logical, is_leaf=lambda x: isinstance(x, tuple)):
        shape, sharding = shapes, jsh
        for key in path:
            shape, sharding = shape[key.key], sharding[key.key]
        leaves.append((jax.tree_util.keystr(path), axes, shape, sharding))
    kept, full = _kept(sizes)
    names = tuple(a for a, _ in kept)
    mesh_shape = tuple(s for _, s in kept)
    for name, axes, shape, sharding in leaves:
        placements = tmesh.logical_to_placements(names, trules, axes)
        assert len(placements) == len(names)
        index_map = sharding.devices_indices_map(shape)
        for coord in np.ndindex(*jm.devices.shape):
            want = _jax_box(index_map[jm.devices[coord]], shape)
            sub = tuple(coord[jmesh.MESH_AXES.index(a)] for a in names)
            got = tmesh.shard_box(shape, mesh_shape, placements, sub)
            assert got == want, (name, coord, placements)


def test_out_of_order_tuple_rule_raises():
    rules = tmesh.DEFAULT_RULES.with_overrides(batch=("ep", "dp"))
    for names in (("dp", "ep", "tp"), ("dp", "tp")):
        with pytest.raises(ValueError, match="out of mesh order"):
            tmesh.logical_to_placements(names, rules, ("batch", "seq"))
    with pytest.raises(ValueError, match="shards two dimensions"):
        tmesh.logical_to_placements(("dp", "tp"), tmesh.DEFAULT_RULES,
                                    ("heads", "mlp"))
    with pytest.raises(ValueError, match="no mesh axis"):
        tmesh.logical_to_placements(
            ("dp",), tmesh.DEFAULT_RULES.with_overrides(embed="xp"),
            ("embed",))


def test_a_mesh_with_pipeline_stages_raises():
    """Over a mesh with pp > 1 the forward makes each layer whole over pp
    from the stage that holds it (tests/test_torch_pipeline.py trains it
    against JAX over dp 2 x pp 2); a stack that pp splits into unequal
    stages is refused before anything runs."""

    class PipelineMesh:
        mesh_dim_names = ("dp", "pp")

        def size(self, i):
            return (2, 3)[i]

    cfg = ttf.TransformerConfig.tiny()
    params = ttf.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="pp=3 must divide n_layers=2"):
        ttf.forward(params, torch.zeros((2, 8), dtype=torch.long), cfg,
                    PipelineMesh())


def test_build_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.build_mesh(tmesh.MeshConfig(dp=1), "cpu")


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(vocab, seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int64)
    return {"tokens": torch.from_numpy(ids[:, :-1]),
            "targets": torch.from_numpy(ids[:, 1:]),
            "mask": torch.from_numpy((rng.random((b, s)) < 0.9)
                                     .astype(np.float32))}


def test_mesh_entry_points_default_to_cuda(one_rank_group, monkeypatch):
    from ray_tpu_torch.parallel.dryrun import dryrun_multidevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA.*device_type='cpu'"):
        tmesh.build_mesh(tmesh.MeshConfig(dp=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multidevice(1)


def test_one_rank_mesh_trains_bit_for_bit_as_one_device(one_rank_group):
    """At world size 1 every placement is whole and no collective runs: the
    mesh path's steps are the one-device path's, bit for bit (what the
    card checks at full width)."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=1), "cpu")
    assert mesh.mesh_dim_names == ("dp",) and tuple(mesh.shape) == (1,)
    assert tuple(tmesh.host_local_mesh(device_type="cpu").shape) == (1,)
    with pytest.raises(ValueError, match="process group of 2"):
        tmesh.host_local_mesh(2, "cpu")
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32,
                                     attn_impl="flash")
    batch = _batch(cfg.vocab_size)

    def run(device=None, mesh=None, **kw):
        opt = tts.default_optimizer()
        state, sh = tts.make_sharded_state(cfg, opt, 0, device, mesh=mesh,
                                           **kw)
        step = tts.make_train_step(cfg, opt, mesh=mesh, state_shardings=sh,
                                   **kw)
        metrics = [step(state, batch)[1] for _ in range(3)]
        params = [p.full_tensor() if hasattr(p, "full_tensor") else p
                  for p in ttf.tree_leaves(state.params)]
        return ([(m["loss"].item(), m["grad_norm"].item()) for m in metrics],
                [p.detach() for p in params])

    ref, ref_params = run(device="cpu")
    for rules in (tmesh.DEFAULT_RULES, tmesh.FSDP_RULES):
        got, params = run(mesh=mesh, rules=rules)
        assert got == ref
        assert all(torch.equal(a, b) for a, b in zip(params, ref_params))


# -- four gloo ranks, 2 x 2 ("dp", "tp") ---------------------------------------

FLASH_SHAPE = (4, 64, 4, 2, 32)  # B, S, H, Hkv, D (GQA)

_RANKS_SCRIPT = """
import json
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from ray_tpu_torch.data import device_batches
from ray_tpu_torch.ops.flash_attention import flash_attention_sharded
from ray_tpu_torch.parallel import batch_sharding
from ray_tpu_torch.parallel.dryrun import dryrun_multidevice
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh, shard_box

mesh = build_mesh(MeshConfig(dp=2, tp=2), "cpu")
coord = mesh.get_coordinate()
spec = [Shard(0), Shard(2)]

def dist_(x, placements, grad=True):
    t = distribute_tensor(torch.from_numpy(x), mesh, placements,
                          src_data_rank=None)
    return t.requires_grad_(grad)

# 1. flash per shard; q arrives replicated and is redistributed first
q, k, v, w = (np.load(f"{work}/{n}.npy") for n in "qkvw")
qd, kd, vd = dist_(q, [Replicate(), Replicate()]), dist_(k, spec), dist_(v, spec)
o = flash_attention_sharded(qd, kd, vd, mesh=mesh)
assert isinstance(o, DTensor) and tuple(o.placements) == tuple(spec)
b, s, h, d = q.shape
assert tuple(o.to_local().shape) == (b // 2, s, h // 2, d)
(o * dist_(w, spec, grad=False)).sum().backward()
flash = {n: t.full_tensor().detach().numpy()
         for n, t in (("o", o), ("dq", qd.grad), ("dk", kd.grad),
                      ("dv", vd.grad))}
if rank == 0:
    np.savez(f"{work}/flash.npz", **flash)

# 2. shard_box against DTensor's own local tensors
cases = [((5, 7, 3), [Shard(0), Shard(1)]), ((8, 6), [Shard(0), Shard(0)]),
         ((7, 4), [Replicate(), Shard(0)]), ((3, 5), [Shard(1), Shard(1)]),
         ((2, 9, 4), [Shard(2), Replicate()]), ((3, 2), [Shard(0), Shard(1)])]
boxes = []
for shape, placements in cases:
    g = torch.arange(int(np.prod(shape))).reshape(shape)
    local = distribute_tensor(g, mesh, placements,
                              src_data_rank=None).to_local()
    box = shard_box(shape, tuple(mesh.shape), placements, coord)
    sl = tuple(slice(a, b) for a, b in box)
    assert torch.equal(local, g[sl]), (shape, placements, box, local.shape)
    boxes.append([list(shape), [repr(p) for p in placements], box])

# 3. the pump: each rank's box of every global batch, as DTensors
batches = [{"tokens": np.arange(4 * 6).reshape(4, 6) + 100 * i,
            "mask": np.full((4, 6), float(i), np.float32)} for i in range(3)]
mesh_, placements = batch_sharding(mesh)
got = list(device_batches(lambda: iter(batches), 2,
                          sharding=(mesh_, placements)))
assert len(got) == len(batches)
for want, have in zip(batches, got):
    for key, arr in want.items():
        t = have[key]
        assert isinstance(t, DTensor) and tuple(t.shape) == arr.shape
        assert tuple(t.placements) == tuple(placements)
        box = shard_box(arr.shape, tuple(mesh.shape), placements, coord)
        np.testing.assert_array_equal(
            t.to_local().numpy(), arr[tuple(slice(a, b) for a, b in box)])
        np.testing.assert_array_equal(t.full_tensor().numpy(), arr)

# 4. the dry run
dry = dryrun_multidevice(4, "cpu")
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump({"coord": list(coord), "boxes": boxes, "pump_batches": len(got),
               "pump_placements": [repr(p) for p in placements],
               "dryrun": dry}, f)
"""


def _flash_inputs():
    b, s, h, hkv, d = FLASH_SHAPE
    rng = np.random.default_rng(3)
    return {"q": rng.standard_normal((b, s, h, d), dtype=np.float32),
            "k": rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            "v": rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            "w": rng.standard_normal((b, s, h, d), dtype=np.float32)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One run of the four-rank script; the tests below read its results."""
    work = tmp_path_factory.mktemp("mesh_ranks")
    for name, arr in _flash_inputs().items():
        np.save(work / f"{name}.npy", arr)
    outs = run_ranks(_RANKS_SCRIPT, 4, work, timeout=240)
    results = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(4)]
    return work, results, outs


def test_sharded_flash_matches_jax(four_ranks):
    work, _, _ = four_ranks
    x = _flash_inputs()
    jm = jmesh.build_mesh(jmesh.MeshConfig(dp=2, tp=2),
                          devices=jax.devices()[:4])

    def loss(q, k, v):
        o = jflash.flash_attention_sharded(q, k, v, mesh=jm, block_q=64,
                                           block_kv=64, interpret=True)
        return (o * x["w"]).sum(), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x[n]) for n in "qkv"))
    got = np.load(work / "flash.npz")
    np.testing.assert_allclose(got["o"], np.asarray(o), atol=2e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(g), atol=2e-5,
                                   err_msg=name)


def test_shard_box_matches_dtensor_local_tensors(four_ranks):
    """Each rank held exactly its ``shard_box`` of every case (checked in
    the rank against ``distribute_tensor``'s local tensor); here the boxes
    of the four ranks tile each tensor once."""
    _, results, _ = four_ranks
    assert sorted(tuple(r["coord"]) for r in results) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for case in range(len(results[0]["boxes"])):
        shape = results[0]["boxes"][case][0]
        seen = np.zeros(shape, np.int64)
        for r in results:
            box = r["boxes"][case][2]
            seen[tuple(slice(a, b) for a, b in box)] += 1
        replicas = 2 if "Replicate()" in results[0]["boxes"][case][1] else 1
        assert (seen == replicas).all(), results[0]["boxes"][case]


def test_sharded_pump_yields_each_ranks_box(four_ranks):
    _, results, _ = four_ranks
    for r in results:
        assert r["pump_batches"] == 3
        assert r["pump_placements"] == ["Shard(dim=0)", "Replicate()"]


def test_dryrun_multidevice_on_four_cpu_ranks(four_ranks):
    _, results, outs = four_ranks
    assert "dryrun_multidevice ok: mesh=" in outs[0]
    assert "dryrun_multidevice ok (pipeline): mesh=" in outs[0]
    assert "dryrun_multidevice ok (pp=4, M=8, 1f1b): mesh=" in outs[0]
    assert "dryrun_multidevice ok (moe/ep): mesh=" in outs[0]
    for r in results:
        dry = r["dryrun"]
        # part 1: ring attention over sp = 2; part 2: GPipe over dp 2 x pp
        # 2; part 2c: 1F1B over pp 4 at M 8 (part 2b needs 8 ranks); part
        # 3: 4 experts over ep = 2
        assert dry["mesh"] == {"dp": 1, "pp": 1, "ep": 1, "sp": 2, "tp": 2}
        assert dry["pipeline"]["mesh"] == {"dp": 2, "pp": 2, "ep": 1,
                                           "sp": 1, "tp": 1}
        assert dry["pipeline_deep"]["mesh"] == {"dp": 1, "pp": 4, "ep": 1,
                                                "sp": 1, "tp": 1}
        assert "pipeline_tp" not in dry
        assert dry["moe"]["mesh"] == {"dp": 1, "pp": 1, "ep": 2, "sp": 1,
                                      "tp": 2}
        for name in ("pipeline", "pipeline_deep", "moe"):
            part = dry[name]
            assert all(np.isfinite(part["losses"]))
            assert part["losses"][-1] < part["losses"][0]
            assert part["losses"] == results[0]["dryrun"][name]["losses"]
        assert all(np.isfinite(dry["losses"]))
        assert dry["losses"][-1] < dry["losses"][0]
        assert dry["losses"] == results[0]["dryrun"]["losses"]
        peak = dry["pipeline_deep"]["peak_bytes"]
        assert 0 < peak["1f1b"] <= 1.05 * peak["gpipe"], peak
