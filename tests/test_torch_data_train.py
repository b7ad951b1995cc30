"""The slice as a whole against JAX on the CPU: a model fed from a
``Dataset``.

Five ``.npy`` token shards (one [4, 33] array each) go through
``read_numpy(dir, parallelism=5)`` and ``map_batches(to_lm_batch)`` (tokens,
targets and a mask of ones, in CPU tasks), then into ``tiny`` (float32,
flash attention, remat "dots") from JAX's initial weights carried across by
``params_from_numpy``:

- through ``TorchTrainer(datasets={"train": ds})``, one gloo worker that
  iterates ``session.get_dataset_shard("train").iter_device_batches(
  device="cpu")``;
- through a one-rank ``MeshGroup`` and ``split_dataset``, the rank
  iterating its split into its train step with the batch laid out over its
  mesh (``sharding=batch_sharding(mesh)``).

Both take 5 steps; their losses and grad norms equal JAX's train step on
the same batches, in the file order, at rtol 1e-5 (float32, as
tests/test_torch_train.py states it). A third test splits a dataset over a
two-rank gloo gang on a two-node ``Cluster``: every row reaches exactly one
rank, rank r gets the blocks with ``idx % 2 == r``, and the coordinator's
executor routed its launches by the ranks' nodes (``routed_launches``).
"""

import os

import numpy as np
import pytest

STEPS = 5
RTOL = 1e-5  # float32: tests/test_torch_train.py, test_torch_train_step.py
B, S = 4, 32
TIMEOUTS = {"mesh_group_placement_timeout_s": 60.0,
            "mesh_group_rendezvous_timeout_s": 90.0,
            "mesh_group_step_timeout_s": 90.0}


def _shards(tmp, vocab):
    """File i holds step i's token ids, [B, S + 1] int32."""
    arrays = []
    for i in range(STEPS):
        rng = np.random.default_rng(200 + i)
        arrays.append(rng.integers(0, vocab, (B, S + 1)).astype(np.int32))
        np.save(os.path.join(tmp, f"shard_{i:02d}.npy"), arrays[-1])
    return arrays


def _lm(a):
    return {"tokens": a[:, :-1], "targets": a[:, 1:],
            "mask": np.ones((a.shape[0], a.shape[1] - 1), np.float32)}


def _make_to_lm_batch():
    def to_lm_batch(a):
        import numpy as np

        return {"tokens": np.ascontiguousarray(a[:, :-1]),
                "targets": np.ascontiguousarray(a[:, 1:]),
                "mask": np.ones((a.shape[0], a.shape[1] - 1), np.float32)}

    return to_lm_batch


def _jax_reference(arrays):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtf
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import train_step as jts

    cfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, max_seq_len=S,
                                     attn_impl="flash", remat=True,
                                     remat_policy="dots")
    mesh = jmesh.build_mesh(jmesh.MeshConfig(dp=1), devices=jax.devices()[:1])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(cfg, mesh, opt, jax.random.key(0))
    init = jax.tree.map(np.array, state.params)  # copies: state is donated
    step = jts.make_train_step(cfg, mesh, opt, sh)
    metrics = []
    for a in arrays:
        state, m = step(state, {k: jnp.asarray(v) for k, v in _lm(a).items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics


def _make_loop():
    """The trainer's loop (a closure: pickled by value)."""

    def loop(config):
        import torch

        from ray_tpu_torch.models import transformer as ttf
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel import train_step as tts
        from ray_tpu_torch.train import session

        torch.set_num_threads(1)
        cfg = ttf.TransformerConfig.tiny(
            dtype=torch.float32, max_seq_len=config["s"], attn_impl="flash",
            remat=True, remat_policy="dots")
        opt = tts.default_optimizer()
        state, _ = tts.make_sharded_state(
            cfg, opt, 0, device="cpu",
            params=params_from_numpy(config["init"], device="cpu"))
        step = tts.make_train_step(cfg, opt)
        it = session.get_dataset_shard("train")
        out, tokens = [], []
        for batch in it.iter_device_batches(batch_size=config["b"],
                                            prefetch_batches=2,
                                            prefetch_blocks=2, device="cpu"):
            assert all(isinstance(v, torch.Tensor) for v in batch.values())
            tokens.append(batch["tokens"][:, 0].tolist())
            state, m = step(state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        session.report({"metrics": out, "tokens": tokens,
                        "rank": session.get_world_rank()})

    return loop


def _make_gang_fn(init):
    """The gang's rank function: its split, fed into its train step."""

    def run(ctx, its):
        import torch

        from ray_tpu_torch.models import transformer as ttf
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel import train_step as tts

        cfg = ttf.TransformerConfig.tiny(
            dtype=torch.float32, max_seq_len=32, attn_impl="flash",
            remat=True, remat_policy="dots")
        opt = tts.default_optimizer()
        state, sh = tts.make_sharded_state(
            cfg, opt, 0, params=params_from_numpy(init, device="cpu"),
            mesh=ctx.mesh)
        step = tts.make_train_step(cfg, opt, mesh=ctx.mesh,
                                   state_shardings=sh)
        out = []
        for batch in its[ctx.rank].iter_device_batches(
                batch_size=4, prefetch_blocks=2, device="cpu",
                sharding=tts.batch_sharding(ctx.mesh)):
            state, m = step(state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        return out

    return run


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from ray_tpu_torch.models import transformer as ttf

    tmp = str(tmp_path_factory.mktemp("shards"))
    arrays = _shards(tmp, ttf.TransformerConfig.tiny().vocab_size)
    init, want = _jax_reference(arrays)
    return tmp, arrays, init, want


def _dataset(tmp):
    import ray_tpu_torch.data as rd

    return rd.read_numpy(tmp, parallelism=STEPS).map_batches(
        _make_to_lm_batch(), batch_format="numpy")


def test_trainer_fed_from_a_dataset_equals_jax(data, tmp_path):
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    tmp, arrays, init, want = data
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
            system_config={"mesh_bootstrap_timeout_s": 60.0})
    try:
        result = TorchTrainer(
            _make_loop(), train_loop_config={"init": init, "b": B, "s": S},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(name="fed", storage_path=str(tmp_path)),
            datasets={"train": _dataset(tmp)}).fit()
    finally:
        rt.shutdown()
    got = result.metrics
    # every row once, in file order
    assert got["tokens"] == [a[:, 0].tolist() for a in arrays]
    np.testing.assert_allclose(got["metrics"], want, rtol=RTOL)


def test_one_rank_gang_fed_by_split_dataset_equals_jax(data):
    import ray_tpu_torch as rt
    from ray_tpu_torch.mesh import MeshGroup

    tmp, arrays, init, want = data
    rt.init(num_cpus=3, object_store_memory=128 * 1024 * 1024,
            system_config=dict(TIMEOUTS))
    try:
        mg = MeshGroup(hosts=1, mesh_shape={"dp": 1}, devices_per_host=1,
                       name="fed_gang")
        try:
            its = mg.split_dataset(_dataset(tmp))
            assert len(its) == 1
            (got,) = mg.run(_make_gang_fn(init), its, timeout=120)
            stats = rt.get(its[0]._coord.stats.remote(), timeout=30)
            its[0].stop()
        finally:
            mg.shutdown()
    finally:
        rt.shutdown()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert stats["executor"]["routed_launches"] > 0, stats


def _make_rank_rows():
    def rank_rows(ctx, its):
        import ray_tpu_torch as _rt

        rows = list(its[ctx.rank].iter_rows())
        return {"rank": ctx.rank, "rows": rows,
                "node": _rt.get_runtime_context().get_node_id()}

    return rank_rows


def test_split_dataset_over_a_two_node_gang_is_disjoint_and_routed():
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.mesh import MeshGroup

    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 3}},
                system_config=dict(TIMEOUTS))
    c.add_node(num_cpus=3)
    c.connect()
    try:
        mg = MeshGroup(hosts=2, mesh_shape={"dp": 2}, devices_per_host=1,
                       name="split_gang")
        try:
            ds = rd.from_items(list(range(24)), parallelism=12).map(
                lambda x: x)
            its = mg.split_dataset(ds)
            assert len(its) == 2
            got = mg.run(_make_rank_rows(), its, timeout=120)
            stats = rt.get(its[0]._coord.stats.remote(), timeout=30)
            its[0].stop()
            members = mg.member_node_ids()
        finally:
            mg.shutdown()
    finally:
        c.shutdown()
    assert [g["rank"] for g in got] == [0, 1]
    assert len(set(members)) == 2 and [g["node"] for g in got] == members
    rows = [g["rows"] for g in got]
    assert sorted(rows[0] + rows[1]) == list(range(24))
    # block idx (two rows each) goes to split idx % 2
    for r in (0, 1):
        assert rows[r] == [i for i in range(24) if (i // 2) % 2 == r]
    assert stats["executor"]["routed_launches"] > 0, stats
