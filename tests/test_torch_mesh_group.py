"""MeshGroup on the port (``ray_tpu_torch/mesh/group.py``): the flows of
``tests/test_mesh_group.py`` on a two-node CPU ``Cluster`` of the port's
runtime, and the slice as a whole against the JAX package.

A gang runs one process per device (the reference: one per host), so a
``{"dp": 2, "tp": 2}`` gang over two hosts is four gloo ranks, two per
node. Covered: STRICT_SPREAD placement one host per node with the ranks of
a host on its node; the GCS registry, member ``node_stats["mesh_groups"]``
and the gang label; SIGKILL of one rank's process -> ``RankFailedError``
naming it -> ``recover()`` onto another mesh shape, the resumed losses
equal to the numpy continuation bit for bit (integral state, as the
reference's); the rendezvous under seeded link chaos; the locality
picker's unit test and its pull preference; the simulated nodes' own
cards (``cluster_utils``), two one-GPU workers in one two-GPU bundle, and
a GPU gang that refuses to run without a card.

The slice as a whole: a 2-layer narrow transformer trained in a
``{"dp": 2}`` gang of two gloo ranks through ``compile_step_with_plan``,
checkpointed, one rank SIGKILLed and the gang recovered, against JAX's
``make_train_step`` on weights carried over by ``params_from_numpy``: loss
and grad norm at rtol 1e-5 per step, as ``tests/test_torch_sharded_train.py``
states (float32, the same math with sums reduced in another order).

Every wait is bounded: the clusters' mesh-group timeouts are cut to
``TIMEOUTS``, and every ``get`` and ``run_step`` names its own.
"""

import contextlib
import json
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.protocol import LABEL_GANG, LABEL_HOST
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.mesh import (
    MeshGroup,
    MeshGroupError,
    RankFailedError,
    StateKey,
)

TIMEOUTS = {"mesh_group_placement_timeout_s": 60.0,
            "mesh_group_rendezvous_timeout_s": 90.0,
            "mesh_group_step_timeout_s": 90.0}


def _make_init_state():
    """Closure factory (functions handed to a gang pickle by value only
    when they are not module-level in a test module): integral-valued
    dp x tp sharded state, so every result stays exactly representable and
    losses compare bitwise across mesh shapes."""

    def init_state(ctx):
        import os as _os

        import torch
        from torch.distributed.tensor import Shard, distribute_tensor

        import ray_tpu_torch as _rt

        glob = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
        ctx.state["w"] = distribute_tensor(
            glob, ctx.mesh, (Shard(0), Shard(1)), src_data_rank=None)
        return {"rank": ctx.rank, "host": ctx.host,
                "node": _rt.get_runtime_context().get_node_id(),
                "pid": _os.getpid()}

    return init_state


def _compile_train_step(mg):
    from torch.distributed.tensor import Replicate, Shard

    def train_step(w, b):
        w = w + b[:, None]
        return w, w.sum()

    block = (Shard(0), Shard(1))
    return mg.compile_step_with_plan(
        train_step,
        in_shardings=(block, (Shard(0), Replicate())),
        out_shardings=(block, (Replicate(), Replicate())),
        donate_argnums=(0,),
    )


@pytest.fixture
def cluster2():
    """Two labeled 3-CPU 'hosts'."""
    c = Cluster(
        initialize_head=True,
        head_node_args={"resources": {"CPU": 3},
                        "labels": {LABEL_HOST: "h0"}},
        system_config=dict(TIMEOUTS),
    )
    c.add_node(num_cpus=3, labels={LABEL_HOST: "h1"})
    c.connect()
    yield c
    c.shutdown()


def _gcs_call(method, payload):
    from ray_tpu_torch._private.worker import require_connected

    return require_connected().gcs.call(method, payload, timeout=10)


def _node_stats(addr):
    from ray_tpu_torch._private import rpc

    cli = rpc.Client.connect(addr, name="mg-stats")
    try:
        return cli.call("node_stats", None, timeout=30)
    finally:
        cli.close()


def test_gang_placement_one_per_host_and_registry(cluster2):
    """STRICT_SPREAD gang: each host's two ranks share a node and the two
    hosts do not; the GCS registry carries the gang, member node_stats
    grow a mesh_groups section with ranks/host/epoch, and member nodes
    wear the gang label (adopted by their raylets too)."""
    mg = MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                   devices_per_host=2, name="gang_pg")
    try:
        assert mg.state == "READY" and mg.world_size == 4
        infos = mg.run(_make_init_state(), timeout=60)
        assert [i["rank"] for i in infos] == [0, 1, 2, 3]
        assert [i["host"] for i in infos] == [0, 0, 1, 1]
        nodes = [i["node"] for i in infos]
        assert nodes[0] == nodes[1] and nodes[2] == nodes[3]
        assert nodes[0] != nodes[2]  # genuinely one host per node
        assert len({i["pid"] for i in infos}) == 4  # one process per rank
        table = _gcs_call("mesh_group_table", None)
        rec = table["gang_pg"]
        assert rec["state"] == "READY" and rec["epoch"] == 1
        assert rec["members"] == [nodes[0], nodes[2]]
        assert rec["ranks"] == {nodes[0]: [0, 1], nodes[2]: [2, 3]}
        assert rec["world_size"] == 4
        info = {n["node_id"].hex(): n for n in rt.nodes()}
        ns = _node_stats(info[nodes[2]]["raylet_addr"])
        mine = ns["mesh_groups"]["gang_pg"]
        assert (mine["rank"], mine["ranks"], mine["host"]) == (2, [2, 3], 1)
        assert mine["epoch"] == 1 and mine["state"] == "READY"
        # the member RAYLET adopted its own gang-label patch (pubsub round
        # trip): the locality picker's same-gang prong on the puller side
        assert ns["labels"].get(LABEL_GANG) == "gang_pg", ns["labels"]
        assert ns["labels"].get(LABEL_HOST) in ("h0", "h1")
        labels = {h: (info[h].get("labels") or {}) for h in info}
        assert all(labels[n].get(LABEL_GANG) == "gang_pg" for n in nodes)
    finally:
        mg.shutdown()
    assert "gang_pg" not in _gcs_call("mesh_group_table", None)
    labels = {n["node_id"].hex(): n.get("labels") or {} for n in rt.nodes()}
    assert not any(LABEL_GANG in v for v in labels.values()), labels


def test_sigkill_typed_failure_then_reshard_recover(cluster2, tmp_path):
    """Train, checkpoint, SIGKILL one rank's process (typed
    RankFailedError naming it, for the WHOLE gang), recover onto a
    DIFFERENT mesh shape, and the resumed losses match a no-failure
    continuation from the same checkpoint bitwise (integral state)."""
    ckpt = str(tmp_path / "gang_ckpt")
    mg = MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                   devices_per_host=2, name="gang_kill",
                   checkpoint_path=ckpt, state_init=_make_init_state())
    try:
        infos = mg.run(_make_init_state(), timeout=60)
        sid = _compile_train_step(mg)
        batch = np.ones((8,), np.float32)
        for _ in range(3):
            (loss,) = mg.run_step(sid, StateKey("w"), batch,
                                  store={0: "w"}, timeout=60)
        mg.save_state(step=3, timeout=60)
        # the no-failure continuation, in numpy: w started as arange and
        # gained +1 everywhere per step
        w = np.arange(32, dtype=np.float32).reshape(8, 4) + 3.0
        expect = []
        for _ in range(3):
            w = w + 1.0
            expect.append(float(w.sum()))
        os.kill(infos[1]["pid"], signal.SIGKILL)  # rank 1: host 0's second
        with pytest.raises(RankFailedError) as ei:
            for _ in range(3):
                mg.run_step(sid, StateKey("w"), batch, store={0: "w"},
                            timeout=60)
        assert (ei.value.rank, ei.value.host, ei.value.epoch) == (1, 0, 1)
        assert mg.state == "BROKEN"
        with pytest.raises(MeshGroupError, match="BROKEN"):
            mg.run_step(sid, StateKey("w"), batch, timeout=60)
        # every rank of the broken gang is gone, survivors included
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                _alive(i["pid"]) for i in infos):
            time.sleep(0.2)
        assert not any(_alive(i["pid"]) for i in infos)
        restored = mg.recover(mesh_shape={"dp": 4, "tp": 1})
        assert restored == 3
        assert mg.state == "READY" and mg.epoch == 2
        got = []
        for _ in range(3):
            (loss,) = mg.run_step(sid, StateKey("w"), batch,
                                  store={0: "w"}, timeout=60)
            got.append(float(loss))
        assert got == expect, (got, expect)
    finally:
        mg.shutdown()


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@contextlib.contextmanager
def _network_chaos(spec):
    """The chaos spec exported to every daemon and worker a cluster started
    inside the context spawns, and installed in this process."""
    from ray_tpu_torch._private import chaos

    old = os.environ.get(chaos.ENV_SPEC)
    os.environ[chaos.ENV_SPEC] = json.dumps(spec)
    plane = chaos.install(spec, role="driver")
    try:
        yield plane
    finally:
        if old is None:
            os.environ.pop(chaos.ENV_SPEC, None)
        else:
            os.environ[chaos.ENV_SPEC] = old
        chaos.uninstall()


@pytest.mark.chaos
def test_gang_rendezvous_under_link_chaos():
    """Seeded drop/delay/dup on the gang's control links (driver and gang
    worker processes <-> GCS) while the gang places and rendezvouses; the
    gang still reaches READY and computes (one recover() allowed, as in
    the reference)."""
    from ray_tpu_torch._private import chaos

    fault = {"link": "gcs", "drop": 0.05, "dup": 0.02,
             "delay_ms": [2, 15]}
    spec = chaos.make_spec(
        seed=77,
        rules=[dict(fault, role="driver"), dict(fault, role="worker")],
    )
    with _network_chaos(spec):
        c = Cluster(initialize_head=True,
                    head_node_args={"resources": {"CPU": 3}},
                    system_config=dict(TIMEOUTS))
        c.add_node(num_cpus=3)
        c.connect()
        try:
            mg = MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                           devices_per_host=2, name="gang_chaos")
            try:
                for attempt in range(2):
                    try:
                        mg.run(_make_init_state(), timeout=60)
                        sid = _compile_train_step(mg)
                        (loss,) = mg.run_step(
                            sid, StateKey("w"), np.ones((8,), np.float32),
                            store={0: "w"}, timeout=60)
                        break
                    except MeshGroupError:
                        if attempt:
                            raise
                        mg.recover()
                assert float(loss) == 528.0  # arange(32).sum() + 32
                assert mg.state == "READY" and mg.epoch >= 1
            finally:
                mg.shutdown()
            live = chaos.plane()
            assert live.stats["frames"] > 0
            assert live.stats["dropped"] + live.stats["delayed"] > 0
        finally:
            c.shutdown()


def test_locality_class_ordering_unit():
    from ray_tpu_torch._private.protocol import LABEL_DCN, LABEL_SLICE
    from ray_tpu_torch._private.raylet import locality_class

    me = {LABEL_HOST: "hA", LABEL_SLICE: "s1", LABEL_GANG: "g1",
          LABEL_DCN: "d1"}
    assert locality_class(me, {LABEL_HOST: "hA"}) == 0
    assert locality_class(me, {LABEL_HOST: "hB", LABEL_SLICE: "s1"}) == 1
    assert locality_class(me, {LABEL_HOST: "hB", LABEL_SLICE: "s2",
                               LABEL_GANG: "g1"}) == 2
    assert locality_class(me, {LABEL_GANG: "g2", LABEL_DCN: "d1"}) == 3
    assert locality_class(me, {LABEL_DCN: "d2"}) == 4
    assert locality_class(me, {}) == 4
    assert locality_class(me, None) == 4
    assert locality_class({}, {LABEL_HOST: "hA"}) == 4
    assert locality_class(None, None) == 4


def test_pull_prefers_same_host_labeled_peer():
    """Two sealed holders, one sharing the puller's host label: with the
    stripe width forced to 1 the pull comes off the same-host peer."""
    from ray_tpu_torch._private import rpc

    c = Cluster(
        initialize_head=True,
        head_node_args={"resources": {"CPU": 2},
                        "labels": {LABEL_HOST: "hA"}},
        system_config={"object_transfer_same_host_shm": False,
                       "object_transfer_stripe_peers": 1},
    )
    other = c.add_node(num_cpus=1, labels={LABEL_HOST: "hB"})
    puller = c.add_node(num_cpus=1, labels={LABEL_HOST: "hA"})
    c.connect()
    try:
        arr = np.random.default_rng(0).integers(
            0, 255, 2 * 1024 * 1024, dtype=np.uint8)
        ref = rt.put(arr)
        info = {n["node_id"].hex(): n for n in rt.nodes()}
        clis = {h: rpc.Client.connect(info[h]["raylet_addr"], name=f"lp-{h}")
                for h in info}
        try:
            head_hex = c.head_node.node_id.hex()
            other_hex, puller_hex = other.node_id.hex(), puller.node_id.hex()
            assert clis[other_hex].call(
                "pull_object", ref.binary(), timeout=120, retry=False) is True
            base = {h: clis[h].call("node_stats", None,
                                    timeout=30)["transfer"]["bytes_out"]
                    for h in (head_hex, other_hex)}
            assert clis[puller_hex].call(
                "pull_object", ref.binary(), timeout=120, retry=False) is True
            out = {h: clis[h].call("node_stats", None,
                                   timeout=30)["transfer"]["bytes_out"]
                   - base[h] for h in (head_hex, other_hex)}
            assert out[head_hex] >= arr.nbytes, out
            assert out[other_hex] == 0, out
            pstats = clis[puller_hex].call("node_stats", None, timeout=30)
            assert pstats["transfer"]["locality_pref_hits"] >= 1
        finally:
            for cl in clis.values():
                cl.close()
    finally:
        c.shutdown()


# ---------------- cards of simulated nodes ----------------


def test_simulated_gpu_nodes_own_disjoint_cards(monkeypatch):
    """Two nodes of num_gpus=2 under a visible list of four cards hand out
    disjoint cards (each raylet starts with its own CUDA_VISIBLE_DEVICES);
    a third finds none left and raises rather than share."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1,0,2")
    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 1}})
    try:
        a = c.add_node(num_cpus=1, num_gpus=2)
        b = c.add_node(num_cpus=1, num_gpus=2)
        ids = [_node_stats(n.raylet_addr)["gpu_cards"]["ids"] for n in (a, b)]
        assert ids == [["3", "1"], ["0", "2"]], ids
        with pytest.raises(ValueError, match="do not share cards"):
            c.add_node(num_cpus=1, num_gpus=1)
    finally:
        c.shutdown()


def test_simulated_gpu_nodes_number_cards_on_from_earlier_nodes(
        monkeypatch):
    """With no visible list (a host whose cards are all visible), nodes
    take the indices 0, 1, ... in turn: the head's GPU too."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 1, "GPU": 1}})
    try:
        a = c.add_node(num_cpus=1, num_gpus=2)
        ids = [_node_stats(n.raylet_addr)["gpu_cards"]["ids"]
               for n in (c.head_node, a)]
        assert ids == [["0"], ["1", "2"]], ids
    finally:
        c.shutdown()


def _card_probe():
    @rt.remote(num_cpus=0.5, num_gpus=1)
    class Probe:
        def cards(self):
            import os as _os

            import ray_tpu_torch as _rt

            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    _rt.get_runtime_context().get_accelerator_ids()["GPU"])

    return Probe


def test_two_one_gpu_workers_in_one_two_gpu_bundle_name_two_cards():
    """A placement-group bundle of two GPUs holding two one-GPU workers
    gives them two distinct cards (the card picker inside a bundle)."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    rt.init(num_cpus=2, num_gpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        pg = placement_group([{"CPU": 1, "GPU": 2}], strategy="PACK")
        assert pg.wait(timeout_seconds=30)
        strategy = PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)
        Probe = _card_probe()
        probes = [Probe.options(scheduling_strategy=strategy).remote()
                  for _ in range(2)]
        got = rt.get([p.cards.remote() for p in probes], timeout=60)
        visible = sorted(v for v, _ in got)
        assert visible == ["0", "1"], got
        assert sorted(i for _, ids in got for i in ids) == ["0", "1"], got
        for p in probes:
            rt.kill(p)
        remove_placement_group(pg)
    finally:
        rt.shutdown()


def test_gpu_gang_without_a_card_raises():
    """A gang whose resources name GPU is granted a (faked) GPU here, but
    its ranks see no CUDA device: the bring-up fails typed, and no rank
    trains on the CPU instead."""
    rt.init(num_cpus=2, num_gpus=1, object_store_memory=64 * 1024 * 1024,
            system_config=dict(TIMEOUTS))
    try:
        with pytest.raises(MeshGroupError, match="no CUDA device"):
            MeshGroup(hosts=1, mesh_shape={"dp": 1}, devices_per_host=1,
                      resources_per_host={"CPU": 1, "GPU": 1},
                      name="gang_nocard")
        assert "gang_nocard" not in _gcs_call("mesh_group_table", None)
    finally:
        rt.shutdown()


def test_gang_resources_give_each_rank_one_card():
    with pytest.raises(MeshGroupError, match="one process per card"):
        MeshGroup(hosts=1, mesh_shape={"dp": 2}, devices_per_host=2,
                  resources_per_host={"CPU": 2, "GPU": 1})
    with pytest.raises(MeshGroupError, match="hosts x devices_per_host"):
        MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                  devices_per_host=1)


# ---------------- the slice as a whole, against JAX ----------------

STEPS, SAVE_AFTER = 5, 3
RTOL = 1e-5  # tests/test_torch_sharded_train.py: float32, sums reordered


def _batches(vocab, n, b=4, s=32):
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": ids[:, :-1], "targets": ids[:, 1:],
                    "mask": (rng.random((b, s)) < 0.9).astype(np.float32)})
    return out


def _jax_reference(batches):
    """JAX's sharded state and step over a dp 2 mesh of CPU devices: the
    initial params (numpy) and per-step (loss, grad norm)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtf
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import train_step as jts

    cfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, max_seq_len=32,
                                     attn_impl="flash")
    mesh = jmesh.build_mesh(jmesh.MeshConfig(dp=2), devices=jax.devices()[:2])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(cfg, mesh, opt, jax.random.key(0))
    init = jax.tree.map(np.array, state.params)
    step = jts.make_train_step(cfg, mesh, opt, sh)
    data_sh = jts.batch_sharding(mesh)
    metrics = []
    for b in batches:
        jb = {k: jax.device_put(jnp.asarray(v), data_sh) for k, v in b.items()}
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics


def _gang_train_parts(init):
    """The gang's state init and train step (closures: pickled by value).
    The step makes the port's ``make_train_step`` on its rank's mesh at
    its first call; the TrainStep then serves the resident state."""

    def state_init(ctx):
        import torch

        from ray_tpu_torch.models import transformer as ttf
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel import train_step as tts

        cfg = ttf.TransformerConfig.tiny(dtype=torch.float32,
                                         max_seq_len=32, attn_impl="flash")
        state, _ = tts.make_sharded_state(
            cfg, tts.default_optimizer(), 0,
            params=params_from_numpy(init, device="cpu"), mesh=ctx.mesh)
        ctx.state["state"] = state
        return ctx.rank

    class GangTrainStep:
        def __init__(self):
            self.step = None

        def __call__(self, state, batch):
            if self.step is None:
                import torch

                from ray_tpu_torch.models import transformer as ttf
                from ray_tpu_torch.parallel import train_step as tts

                cfg = ttf.TransformerConfig.tiny(
                    dtype=torch.float32, max_seq_len=32, attn_impl="flash")
                mesh = ttf.tree_leaves(state.params)[0].device_mesh
                self.step = tts.make_train_step(
                    cfg, tts.default_optimizer(), mesh=mesh)
            return self.step(state, batch)

    return state_init, GangTrainStep()


def _plan(axes):
    """The step's plan, built on the controller from the mesh's axis
    names: the state as ``make_sharded_state`` lays it out, the batch as
    ``batch_sharding``, the metrics replicated."""
    from torch.distributed.tensor import Replicate

    from ray_tpu_torch.models import transformer as ttf
    from ray_tpu_torch.parallel.mesh import (
        DEFAULT_RULES,
        logical_to_placements,
        shardings_for,
    )
    from ray_tpu_torch.parallel.train_step import TrainState

    cfg = ttf.TransformerConfig.tiny(max_seq_len=32, attn_impl="flash")
    params = shardings_for(axes, DEFAULT_RULES, ttf.param_logical_axes(cfg))
    rep = (Replicate(),) * len(axes)
    state = TrainState(step=rep, params=params, opt_state=params)
    batch = logical_to_placements(axes, DEFAULT_RULES, ("batch", "seq"))
    return {"in_shardings": (state, batch), "out_shardings": (state, rep)}


def test_small_transformer_in_a_gang_equals_jax_across_a_sigkill(tmp_path):
    """Three steps in a {"dp": 2} gang, a checkpoint, rank 1 SIGKILLed,
    recover() (restored step 3, epoch 2), two more steps: all five losses
    and grad norms equal JAX's uninterrupted run at rtol 1e-5."""
    from ray_tpu_torch.models import transformer as ttf

    vocab = ttf.TransformerConfig.tiny().vocab_size
    batches = _batches(vocab, STEPS)
    init, want = _jax_reference(batches)
    rt.init(num_cpus=3, object_store_memory=128 * 1024 * 1024,
            system_config=dict(TIMEOUTS))
    try:
        state_init, step_fn = _gang_train_parts(init)
        mg = MeshGroup(hosts=1, mesh_shape={"dp": 2}, devices_per_host=2,
                       name="gang_tiny", checkpoint_path=str(tmp_path / "c"),
                       state_init=state_init)
        try:
            assert mg.run(state_init, timeout=60) == [0, 1]
            sid = mg.compile_step_with_plan(step_fn, **_plan(("dp",)))
            got = []
            for b in batches[:SAVE_AFTER]:
                (m,) = mg.run_step(sid, StateKey("state"), b,
                                   store={0: "state"}, timeout=60)
                got.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
            mg.save_state(step=SAVE_AFTER, timeout=60)
            os.kill(mg.members[1]["pid"], signal.SIGKILL)
            with pytest.raises(RankFailedError) as ei:
                mg.run_step(sid, StateKey("state"), batches[SAVE_AFTER],
                            store={0: "state"}, timeout=60)
            assert (ei.value.rank, ei.value.epoch) == (1, 1)
            assert mg.recover() == SAVE_AFTER and mg.epoch == 2
            for b in batches[SAVE_AFTER:]:
                (m,) = mg.run_step(sid, StateKey("state"), b,
                                   store={0: "state"}, timeout=60)
                got.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        finally:
            mg.shutdown()
    finally:
        rt.shutdown()
    assert [s for *_, s in got] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([g[:2] for g in got], want, rtol=RTOL)
