"""The port's streaming data plane against the JAX package's: the flows of
tests/test_data_plane.py, each run once on each package.

- Chaos re-read accounting: all N shard blocks are produced on a victim
  node, the consumer pulls k of them (k from the seeded
  ``chaos.replay_rng`` schedule, so both packages lose the same shards),
  the victim is SIGKILLed and the rest reconstruct. Exactly the N - k lost
  shards are re-read, and the head's ``pulls_completed`` shows every block
  crossed the wire once. The mid-stream soak is ``slow``, as in the
  reference.
- Backpressure: a slow consumer bounds the executor's in-flight blocks
  and the prefetch window; an abandoned consumer unwinds a pump parked on
  a wedged producer; a slow producer shows as ``ingest_stall_s``.

The reference's legs run with the cyclic GC paused (``torch_parity``).
"""

import gc
import importlib
import time
from collections import Counter

import numpy as np
import pytest
from torch_parity import norm, outcome, plain, run_flows

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _read_counts(path) -> Counter:
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = ""
    return Counter(int(line) for line in text.split())


def _make_read_fn(marker_path, rows=65536):
    """Source-read stage: stamps each execution (the re-read counter) and
    returns a store-sized columnar block."""

    def read_shard(block, _p=str(marker_path), _r=rows):
        import numpy as np

        with open(_p, "a") as f:
            for item in block:
                f.write(f"{item}\n")
        return {"x": np.full((_r,), float(block[0]), np.float32)}

    return read_shard


def _chaos_leg(name, fn, tmp):
    """``fn(rt, rd, chaos, rpc, Cluster, tmp)`` on package ``name``, with
    the reference's GC paused; its outcome as plain data."""
    rt = importlib.import_module(name)
    rd = importlib.import_module(name + ".data")
    chaos = importlib.import_module(name + "._private.chaos")
    rpc = importlib.import_module(name + "._private.rpc")
    cluster_cls = importlib.import_module(name + ".cluster_utils").Cluster
    gc.collect()
    if name == "ray_tpu":
        gc.disable()
    try:
        return plain(outcome(fn, rt, rd, chaos, rpc, cluster_cls, str(tmp)))
    finally:
        gc.enable()


def node_death_rereads_only_lost_shards(rt, rd, chaos, rpc, Cluster, tmp):
    N = 8
    marker = tmp + "/reads.log"
    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 0.5}},
                system_config={"prestart_workers": False,
                               "log_to_driver": False})
    chaos.install(chaos.make_spec(seed=1234))
    try:
        victim = c.add_node(num_cpus=2)
        c.connect()
        ds = rd.from_items(list(range(N)), parallelism=N).map_batches(
            _make_read_fn(marker))
        ex = ds._executor(locality_hints=[victim.node_id.hex()])
        refs = list(ex.iter_output_refs())
        assert len(refs) == N
        assert sum(_read_counts(marker).values()) == N
        # The survivor joins only once every block exists: the locality
        # hint is soft, so a survivor present during the stage could
        # produce a block that the victim's death never loses.
        c.add_node(num_cpus=2)
        k = chaos.replay_rng("test:data_plane:kill_point").randrange(2, N - 1)
        nodes = {n["node_id"].hex(): n for n in rt.nodes()}
        cli = rpc.Client.connect(
            nodes[c.head_node.node_id.hex()]["raylet_addr"], name="dp-head")
        try:
            def pulls():
                return cli.call("node_stats", None,
                                timeout=30)["transfer"]["pulls_completed"]

            base = pulls()
            consumed = [rt.get(r, timeout=60) for r in refs[:k]]
            assert pulls() - base == k
            c.remove_node(victim)
            time.sleep(1.0)
            rest = [rt.get(r, timeout=240) for r in refs[k:]]
            firsts = [float(b["x"][0]) for b in consumed + rest]
            assert firsts == [float(i) for i in range(N)]
            counts = _read_counts(marker)
            assert sum(counts.values()) == N + (N - k), counts
            assert all(counts[i] == 1 for i in range(k)), counts
            assert all(counts[i] == 2 for i in range(k, N)), counts
            moved = pulls() - base
            assert moved == N, (moved, N)
        finally:
            cli.close()
        return [k, firsts, sorted(counts.items()), moved]
    finally:
        chaos._PLANE = None
        c.shutdown()


def node_death_mid_stream_rereads_bounded(rt, rd, chaos, rpc, Cluster, tmp):
    N = 24
    marker = tmp + "/reads.log"
    c = Cluster(initialize_head=True,
                head_node_args={"resources": {"CPU": 0.5}},
                system_config={"prestart_workers": False,
                               "log_to_driver": False})
    chaos.install(chaos.make_spec(seed=77))
    try:
        c.add_node(num_cpus=3)
        victim = c.add_node(num_cpus=3)
        c.connect()
        ds = rd.from_items(list(range(N)), parallelism=N).map_batches(
            _make_read_fn(marker))
        ex = ds._executor(locality_hints=[victim.node_id.hex()])
        k = chaos.replay_rng("test:data_plane:soak_kill").randrange(4, N // 2)
        got, killed = [], False
        for ref in ex.iter_output_refs():
            got.append(rt.get(ref, timeout=240))
            if len(got) == k and not killed:
                c.remove_node(victim)
                killed = True
        assert killed and len(got) == N
        firsts = [float(b["x"][0]) for b in got]
        assert firsts == [float(i) for i in range(N)]
        counts = _read_counts(marker)
        assert all(counts[i] == 1 for i in range(k)), counts
        rereads = sum(counts.values()) - N
        assert 0 <= rereads <= N - k, (rereads, k, counts)
        return [k, firsts, [counts[i] for i in range(k)]]
    finally:
        chaos._PLANE = None
        c.shutdown()


@pytest.mark.chaos
def test_node_death_rereads_only_lost_shards(tmp_path):
    got = {}
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        got[name] = _chaos_leg(name, node_death_rereads_only_lost_shards,
                               tmp_path / name)
    assert got["ray_tpu"][0] == "value", got["ray_tpu"]
    assert norm(got["ray_tpu_torch"]) == norm(got["ray_tpu"])


@pytest.mark.chaos
@pytest.mark.slow
def test_node_death_mid_stream_rereads_bounded(tmp_path):
    got = {}
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        got[name] = _chaos_leg(name, node_death_mid_stream_rereads_bounded,
                               tmp_path / name)
    assert got["ray_tpu"][0] == "value", got["ray_tpu"]
    assert norm(got["ray_tpu_torch"]) == norm(got["ray_tpu"])


# ---------------------------------------------------- backpressure flows


def slow_consumer_bounds_inflight_and_memory(rt, rd):
    import resource

    prefetch = importlib.import_module(rt.__name__ + ".data.prefetch")
    nblocks, rows = 64, 262144  # 64 x 1 MiB >> the bounded window
    ds = rd.from_items(list(range(nblocks)), parallelism=nblocks).map_batches(
        lambda b: {"x": np.full((rows,), float(b[0]), np.float32)})
    ex = ds._executor(max_tasks_in_flight=2, max_buffered_blocks=3)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    pf = prefetch.BlockPrefetcher(ex.iter_output_refs(), max_ahead=2)
    firsts = []
    try:
        for blk in pf:
            assert blk["x"].nbytes == rows * 4
            firsts.append(float(blk["x"][0]))
            time.sleep(0.02)  # slow consumer
    finally:
        pf.close()
    assert len(firsts) == nblocks
    assert ex._peak_buffered <= 4, ex._peak_buffered
    st = pf.stats()
    assert st["max_depth"] <= 2, st
    assert st["producer_wait_s"] > 0, st
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert rss1 - rss0 < 48 * 1024, (rss0, rss1)
    return [firsts, st["blocks"], st["max_depth"] <= 2]


def abandoned_consumer_unwinds_wedged_pump(rt, rd):
    prefetch = importlib.import_module(rt.__name__ + ".data.prefetch")

    @rt.remote(num_cpus=1)
    def wedged():
        import time as _t

        _t.sleep(30)
        return {"x": np.zeros(4)}

    pf = prefetch.BlockPrefetcher(iter([wedged.remote()]), max_ahead=2)
    time.sleep(0.3)  # let the pump park inside the get
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    return pf._thread.is_alive()


def slow_producer_surfaces_as_ingest_stall(rt, rd):
    def slow_block(b):
        import time as _t

        import numpy as np

        _t.sleep(0.15)
        return {"x": np.full((1024,), float(b[0]), np.float32)}

    nblocks = 10
    ds = rd.from_items(list(range(nblocks)), parallelism=nblocks).map_batches(
        slow_block)
    (it,) = ds.streaming_split(1)
    got = list(it.iter_native_blocks(prefetch_blocks=2))
    firsts = [float(b["x"][0]) for b in got]
    assert sorted(firsts) == [float(i) for i in range(nblocks)]
    st = it.stats()["prefetch"]
    assert st["ingest_stall_s"] > 0.05, st
    assert st["blocks"] == nblocks, st
    it.stop()
    return [firsts, st["blocks"]]


def read_object_chunk_debug_reads(rt, rd):
    """The raylet's msgpack ``read_object_chunk`` (the transfer tests'
    debug read): byte ranges of a stored object, ``None`` for an object
    the node does not hold, a clean error for a range outside the
    object."""
    rpc = importlib.import_module(rt.__name__ + "._private.rpc")
    ids = importlib.import_module(rt.__name__ + "._private.ids")
    arr = np.arange(300_000, dtype=np.int32)  # above the inline limit
    ref = rt.put(arr)
    (node,) = [n for n in rt.nodes() if n.get("alive", True)]
    cli = rpc.Client.connect(node["raylet_addr"], name="chunk-probe")
    try:
        meta = cli.call("read_object_meta", ref.binary(), timeout=30)
        size, chunks, off = meta["size"], [], 0
        while off < size:
            n = min(256 * 1024, size - off)
            chunks.append(cli.call("read_object_chunk",
                                   [ref.binary(), off, n], timeout=30))
            off += n
        whole = b"".join(chunks)
        assert len(whole) == size
        missing = cli.call("read_object_chunk",
                           [ids.ObjectID.from_random().binary(), 0, 8],
                           timeout=30)
        try:
            cli.call("read_object_chunk", [ref.binary(), -4096, 4096],
                     timeout=30)
            raise AssertionError("a negative offset was served")
        except AssertionError:
            raise
        except Exception as e:  # the message is part of the result
            bad = "outside object" in str(e)
    finally:
        cli.close()
    return [size, [len(c) for c in chunks], arr.tobytes() in whole,
            missing, bad]


BACKPRESSURE = [slow_consumer_bounds_inflight_and_memory,
                abandoned_consumer_unwinds_wedged_pump,
                slow_producer_surfaces_as_ingest_stall,
                read_object_chunk_debug_reads]


@pytest.fixture(scope="module")
def runs():
    init = {"num_cpus": 4, "object_store_memory": 96 * 1024 * 1024}
    return {name: run_flows(
        name, BACKPRESSURE, init,
        lambda n: (importlib.import_module(n + ".data"),))
        for name in PACKAGES}


@pytest.mark.parametrize("flow", [f.__name__ for f in BACKPRESSURE])
def test_backpressure_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_packed_exchange_flips_at_the_knob():
    """``data_exchange_packed_max_parts`` (default 8; 0 disables packing):
    a shuffle stage of K parts is packed iff 0 < K <= the knob, in both
    packages, under the same settings."""
    got = {}
    for name in PACKAGES:
        config = importlib.import_module(name + "._private.config")
        shuffle = importlib.import_module(name + ".data.shuffle")
        cfg = config.GLOBAL_CONFIG
        old = cfg.data_exchange_packed_max_parts
        row = []
        try:
            for knob in (8, 4, 0):
                cfg.load({"data_exchange_packed_max_parts": knob})
                row.append([shuffle.shuffle_stage(k, 0).is_packed()
                            for k in (1, 4, 5, 8, 9, 16)])
        finally:
            cfg.load({"data_exchange_packed_max_parts": old})
        got[name] = row
    assert got["ray_tpu"][0] == [True, True, True, True, False, False]
    assert got["ray_tpu"][2] == [False] * 6
    assert got["ray_tpu_torch"] == got["ray_tpu"]
