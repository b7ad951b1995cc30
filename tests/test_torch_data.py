"""The port's Data library (ray_tpu_torch/data/) against the JAX package's
(ray_tpu/data/): the flows of tests/test_data.py, each run once on each
package and compared through ``torch_parity.norm``.

Each flow takes the package, its ``data`` module and a fresh directory,
asserts what the reference's test asserts, and returns what it saw as
plain data; the port's result must equal the reference's. Both packages
run the same code over the same seeds, so seeded shuffles, sorts and
exchanges must agree row for row, not only as sets. One runtime session
per package for the module (the reference's with the cyclic GC paused,
``torch_parity.run_flows``).

Port-only, first on the port's fresh session: a ``map_batches`` task's
worker has no torch loaded.
"""

import importlib
import os
import random
import tempfile
import time

import numpy as np
import pytest
from torch_parity import norm, run_flows


def _data(name):
    return importlib.import_module(name + ".data")


# ---------------------------------------------------------------- flows


def from_items_roundtrip(rt, rd, tmp):
    ds = rd.from_items(list(range(100)), parallelism=8)
    assert ds.num_blocks() == 8
    out = ds.take_all()
    assert sorted(out) == list(range(100))
    assert ds.count() == 100
    return out


def range_map_filter(rt, rd, tmp):
    ds = rd.range(50, parallelism=4).map(lambda x: x * 2).filter(
        lambda x: x % 4 == 0)
    out = sorted(ds.take_all())
    assert out == [x * 2 for x in range(50) if (x * 2) % 4 == 0]
    return out


def map_batches_block_level(rt, rd, tmp):
    ds = rd.from_items(list(range(20)), parallelism=4).map_batches(
        lambda block: [sum(block)])
    sums = sorted(ds.take_all())
    assert sum(sums) == sum(range(20)) and len(sums) == 4
    return sums


def iter_batches_sizes(rt, rd, tmp):
    ds = rd.from_items(list(range(23)), parallelism=3)
    batches = list(ds.iter_batches(batch_size=10))
    assert [len(b) for b in batches] == [10, 10, 3]
    return batches


def take_is_streaming(rt, rd, tmp):
    ds = rd.from_items(list(range(1000)), parallelism=100).map_batches(
        lambda b: b)
    ex = ds._executor()
    got = []
    for ref in ex.iter_output_refs():
        got.extend(rt.get(ref, timeout=60))
        if len(got) >= 5:
            break
    assert ex._peak_buffered <= 10
    return got[:5]


def backpressure_bounds_buffering(rt, rd, tmp):
    ds = rd.from_items(list(range(64)), parallelism=16).map_batches(
        lambda b: b)
    ex = ds._executor(max_tasks_in_flight=2, max_buffered_blocks=3)
    seen = 0
    for _ref in ex.iter_output_refs():
        time.sleep(0.05)  # slow consumer
        seen += 1
    assert seen == 16
    assert ex._peak_buffered <= 4, ex._peak_buffered
    return seen


def random_shuffle(rt, rd, tmp):
    out = rd.from_items(list(range(200)), parallelism=8).random_shuffle(
        seed=7).take_all()
    assert sorted(out) == list(range(200)) and out != list(range(200))
    return out


def streaming_split_disjoint_and_complete(rt, rd, tmp):
    ds = rd.from_items(list(range(60)), parallelism=6).map(lambda x: x)
    a, b = ds.streaming_split(2)
    got_a, got_b = list(a.iter_rows()), list(b.iter_rows())
    a.stop()
    assert sorted(got_a + got_b) == list(range(60))
    assert got_a and got_b
    return [got_a, got_b]


def streaming_split_feeds_trainer(rt, rd, tmp):
    """tests/test_data.py's trainer feed: two workers each draw their shard
    through ``session.get_dataset_shard`` (JaxTrainer in the reference,
    TorchTrainer on gloo in the port)."""
    pkg = rt.__name__
    train = importlib.import_module(pkg + ".train")
    if pkg == "ray_tpu_torch":
        trainer_cls, sc = train.TorchTrainer, train.ScalingConfig(
            num_workers=2, use_gpu=False)
    else:
        trainer_cls, sc = train.JaxTrainer, train.ScalingConfig(
            num_workers=2)
    ds = rd.from_items([{"x": float(i), "y": 2.0 * i} for i in range(40)],
                       parallelism=8).map(lambda r: {"x": r["x"],
                                                     "y": r["y"]})

    def loop(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        shard = session.get_dataset_shard("train")
        n, total, rows = 0, 0.0, []
        for batch in shard.iter_batches(batch_size=5):
            n += len(batch)
            total += sum(r["y"] for r in batch)
            rows.extend(r["x"] for r in batch)
        session.report({"rows": n, "total": total, "xs": rows})

    seen = {}

    class Sum2(trainer_cls):
        def _drain(self, group):
            done = [False] * group.num_workers
            while not all(done):
                for rank, p in enumerate(group.poll_all(timeout=10.0)):
                    for ev in p["events"]:
                        seen[rank] = ev["metrics"]
                    if p["done"]:
                        if p["error"] is not None:
                            raise RuntimeError(p.get("error_tb"))
                        done[rank] = True
            return {}

    Sum2(loop, train_loop_config={"pkg": pkg}, scaling_config=sc,
         run_config=train.RunConfig(name="data_feed", storage_path=tmp),
         datasets={"train": ds}).fit()
    assert sum(m["rows"] for m in seen.values()) == 40
    assert sum(m["total"] for m in seen.values()) == sum(
        2.0 * i for i in range(40))
    return [seen[r]["xs"] for r in sorted(seen)]


def iter_batches_numpy_format(rt, rd, tmp):
    ds = rd.from_items([{"x": np.full(4, i, np.float32), "y": i}
                        for i in range(10)], parallelism=2)
    batches = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
    assert [b["x"].shape for b in batches] == [(4, 4), (4, 4), (2, 4)]
    assert batches[0]["y"].tolist() == [0, 1, 2, 3]
    out = list(rd.range(6, parallelism=2).iter_batches(
        batch_size=3, batch_format="numpy"))
    assert sorted(np.concatenate(out).tolist()) == [0, 1, 2, 3, 4, 5]
    try:
        list(ds.iter_batches(batch_format="arrow"))
        raise AssertionError("batch_format='arrow' was accepted")
    except ValueError as e:
        assert "batch_format" in str(e)
        err = str(e)
    return [batches, out, err]


def exact_random_shuffle(rt, rd, tmp):
    ds = rd.from_items(list(range(200)), parallelism=8).random_shuffle(seed=7)
    out = ds.take_all()
    assert sorted(out) == list(range(200)) and out != list(range(200))
    blocks = list(ds.iter_blocks())
    first = next(b for b in blocks if b)
    assert len({v // 25 for v in first}) > 1, "rows did not cross blocks"
    return blocks


def sort_global_order(rt, rd, tmp):
    vals = list(range(300))
    random.Random(0).shuffle(vals)
    flat = []
    for block in rd.from_items(vals, parallelism=6).sort().iter_blocks():
        flat.extend(block)
    assert flat == list(range(300))
    desc = rd.from_items(vals[:50], parallelism=4).sort(descending=True)
    got = desc.take_all()
    assert got == sorted(vals[:50], reverse=True)
    return [flat, got]


def sort_by_column_key(rt, rd, tmp):
    rows = [{"k": i % 7, "v": i} for i in range(60)]
    out = rd.from_items(rows, parallelism=5).sort(key="k").take_all()
    ks = [r["k"] for r in out]
    assert ks == sorted(ks)
    return out


def groupby_aggregates(rt, rd, tmp):
    rows = [{"k": i % 3, "v": float(i)} for i in range(30)]
    ds = rd.from_items(rows, parallelism=4)
    counts = {r["key"]: r["count"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}
    sums = {r["key"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    expect = {k: sum(float(i) for i in range(30) if i % 3 == k)
              for k in (0, 1, 2)}
    assert sums == expect
    means = {r["key"]: r["mean(v)"]
             for r in ds.groupby("k").mean("v").take_all()}
    assert means == {k: expect[k] / 10 for k in expect}
    spans = ds.groupby("k").map_groups(
        lambda rows: max(r["v"] for r in rows) - min(r["v"] for r in rows)
    ).take_all()
    assert sorted(spans) == [27.0, 27.0, 27.0]
    return [counts, sums, means, spans]


def repartition_and_split(rt, rd, tmp):
    ds = rd.from_items(list(range(100)), parallelism=3).repartition(7)
    assert ds.num_blocks() == 7
    sizes = [len(b) for b in ds.iter_blocks()]
    assert sum(sizes) == 100 and max(sizes) - min(sizes) <= 15
    assert ds.take_all() == list(range(100))
    parts = rd.from_items(list(range(50)), parallelism=4).split(3)
    assert len(parts) == 3
    got = [p.take_all() for p in parts]
    assert sorted(r for p in got for r in p) == list(range(50))
    return [sizes, got]


def limit_union_flat_map(rt, rd, tmp):
    assert rd.range(100, parallelism=10).limit(25).count() == 25
    u = rd.from_items([1, 2]).union(rd.from_items([3, 4]),
                                    rd.from_items([5])).take_all()
    assert sorted(u) == [1, 2, 3, 4, 5]
    fm = rd.from_items([1, 2, 3]).flat_map(lambda x: [x] * x).take_all()
    assert sorted(fm) == [1, 2, 2, 3, 3, 3]
    return [u, fm]


def column_ops_and_schema(rt, rd, tmp):
    rows = [{"a": i, "b": str(i), "c": float(i)} for i in range(10)]
    ds = rd.from_items(rows, parallelism=2)
    assert ds.schema() == {"a": int, "b": str, "c": float}
    sel = ds.select_columns(["a", "c"]).take(1)[0]
    drp = ds.drop_columns(["b"]).take(1)[0]
    assert set(sel) == {"a", "c"} and set(drp) == {"a", "c"}
    add = ds.add_column("d", lambda r: r["a"] * 2).take(3)
    assert [r["d"] for r in add] == [0, 2, 4]
    aggs = [ds.sum("a"), ds.min("a"), ds.max("a"), ds.mean("c")]
    assert aggs == [45, 0, 9, 4.5]
    return [sorted(ds.schema()), sel, drp, add, aggs]


def csv_json_roundtrip(rt, rd, tmp):
    rows = [{"x": i, "y": f"s{i}", "z": i / 2} for i in range(40)]
    ds = rd.from_items(rows, parallelism=4)
    csv_dir, json_dir = os.path.join(tmp, "csv"), os.path.join(tmp, "json")
    files = ds.write_csv(csv_dir)
    assert len(files) == 4
    back = sorted(rd.read_csv(csv_dir, parallelism=2).take_all(),
                  key=lambda r: r["x"])
    assert back == rows
    ds.write_json(json_dir)
    back_j = sorted(rd.read_json(json_dir).take_all(), key=lambda r: r["x"])
    assert back_j == rows
    return [[os.path.basename(f) for f in files], back, back_j]


def parquet_roundtrip(rt, rd, tmp):
    rows = [{"x": i, "name": f"n{i}"} for i in range(30)]
    pq_dir = os.path.join(tmp, "pq")
    rd.from_items(rows, parallelism=3).write_parquet(pq_dir)
    back = sorted(rd.read_parquet(pq_dir, parallelism=2).take_all(),
                  key=lambda r: r["x"])
    assert back == rows
    only_x = rd.read_parquet(pq_dir, columns=["x"]).take(1)[0]
    assert set(only_x) == {"x"}
    return [back, only_x]


def pandas_numpy_interop(rt, rd, tmp):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    ds = rd.from_pandas(df)
    rows = sorted(ds.take_all(), key=lambda r: r["a"])
    assert rows == df.to_dict("records")
    a = sorted(ds.to_pandas()["a"].tolist())
    assert a == [1, 2, 3]
    arr = np.arange(12).reshape(6, 2)
    got = np.stack(sorted(rd.from_numpy(arr, parallelism=3).take_all(),
                          key=lambda r: r[0]))
    assert (got == arr).all()
    return [rows, a, got]


def preprocessors(rt, rd, tmp):
    pp = importlib.import_module(rt.__name__ + ".data.preprocessors")
    rows = [{"a": float(i), "b": float(i % 5), "cat": "xyz"[i % 3]}
            for i in range(50)]
    ds = rd.from_items(rows, parallelism=4)
    out = [r["a"] for r in pp.StandardScaler(["a"]).fit(ds).transform(
        ds).take_all()]
    assert abs(sum(out) / len(out)) < 1e-9 and abs(np.std(out) - 1.0) < 1e-9
    vals = [r["b"] for r in pp.MinMaxScaler(["b"]).fit(ds).transform(
        ds).take_all()]
    assert min(vals) == 0.0 and max(vals) == 1.0
    le = pp.LabelEncoder("cat").fit(ds)
    assert le.mapping_ == {"x": 0, "y": 1, "z": 2}
    oh_row = pp.OneHotEncoder(["cat"]).fit(ds).transform(ds).take(1)[0]
    assert sum(oh_row[k] for k in ("cat_x", "cat_y", "cat_z")) == 1
    chain = pp.Chain(pp.StandardScaler(["a"]), pp.LabelEncoder("cat"),
                     pp.Concatenator(columns=["a", "b", "cat"])).fit(ds)
    out_rows = chain.transform(ds).take(2)
    assert out_rows[0]["features"].shape == (3,)
    assert out_rows[0]["features"].dtype == np.float32
    batch = chain.transform_batch(rows[:2])
    assert np.allclose(batch[0]["features"], out_rows[0]["features"])
    try:
        pp.StandardScaler(["a"]).transform(ds)
        raise AssertionError("an unfitted preprocessor transformed")
    except RuntimeError as e:
        assert "must be fit" in str(e)
    return [out, vals, le.mapping_, oh_row, out_rows, batch]


def single_block_barrier_ops(rt, rd, tmp):
    ds = rd.from_items(list(range(10)), parallelism=1)
    shuf = ds.random_shuffle(seed=1).take_all()
    assert sorted(shuf) == list(range(10))
    desc = ds.sort(descending=True).take_all()
    assert desc == sorted(range(10), reverse=True)
    rows = rd.from_items([{"k": i % 2, "v": i} for i in range(6)],
                         parallelism=1)
    counts = {r["key"]: r["count"] for r in rows.groupby("k").count().take_all()}
    assert counts == {0: 3, 1: 3}
    return [shuf, desc, counts]


def barrier_ops_lazy_and_deterministic(rt, rd, tmp):
    streaming = importlib.import_module(rt.__name__ + ".data.streaming")
    ds = rd.from_items(list(range(40)), parallelism=4)
    shuffled = ds.random_shuffle(seed=3)
    assert shuffled._source is ds._source
    assert isinstance(shuffled._stages[-1], streaming.ExchangeStage)
    first, second = shuffled.take_all(), shuffled.take_all()
    assert first == second
    mat = shuffled.materialize()
    assert not mat._stages and mat.take_all() == first
    return first


def actor_pool_map_batches(rt, rd, tmp):
    class AddPid:
        def __init__(self):
            import os as _os

            self.pid = _os.getpid()
            self.calls = 0

        def __call__(self, rows):
            self.calls += 1
            return [{"v": r, "pid": self.pid, "call": self.calls}
                    for r in rows]

    rows = rd.from_items(list(range(40)), parallelism=8).map_batches(
        AddPid, batch_format="rows", compute=rd.ActorPoolStrategy(size=2)
    ).take_all()
    vs = sorted(r["v"] for r in rows)
    assert vs == list(range(40))
    assert len({r["pid"] for r in rows}) <= 2
    assert max(r["call"] for r in rows) > 1
    return vs


def class_udf_requires_actor_pool(rt, rd, tmp):
    class F:
        def __call__(self, rows):
            return rows

    try:
        rd.from_items([1]).map_batches(F)
    except ValueError as e:
        assert "ActorPoolStrategy" in str(e)
        return str(e)
    raise AssertionError("a class UDF ran without an actor pool")


def columnar_zero_copy_ingest(rt, rd, tmp):
    arr = np.arange(4000, dtype=np.float32).reshape(1000, 4)
    batches = list(rd.from_numpy(arr, parallelism=2).iter_batches(
        batch_size=100, batch_format="numpy"))
    assert len(batches) == 10
    assert not batches[0].flags["OWNDATA"]
    assert (np.concatenate(batches) == arr).all()
    return [len(batches), bool(batches[0].flags["OWNDATA"]),
            bool(batches[0].flags["WRITEABLE"])]


def map_batches_numpy_format_columnar_through(rt, rd, tmp):
    import pandas as pd

    ds = rd.from_pandas(pd.DataFrame(
        {"x": np.arange(50, dtype=np.float64), "y": np.ones(50)}),
        parallelism=4).map_batches(lambda b: {"z": b["x"] * 2 + b["y"]},
                                   batch_format="numpy")
    z = np.concatenate([b["z"] for b in ds.iter_batches(
        batch_size=25, batch_format="numpy")])
    assert np.allclose(np.sort(z), np.arange(50) * 2 + 1)
    return z


def exchange_streams_inside_executor(rt, rd, tmp):
    streaming = importlib.import_module(rt.__name__ + ".data.streaming")
    ds = (rd.range(200, parallelism=8).map(lambda x: int(x) * 2)
          .random_shuffle(seed=11).map(lambda x: x + 1).sort())
    out = ds.take_all()
    assert out == [x * 2 + 1 for x in range(200)]
    n = sum(isinstance(s, streaming.ExchangeStage) for s in ds._stages)
    assert n == 2
    return [out, n]


def columnar_sort_and_shuffle_vectorized(rt, rd, tmp):
    vals = np.random.default_rng(5).permutation(500).astype(np.int64)
    got = np.asarray(rd.from_numpy(vals, parallelism=5).sort().take_all())
    assert (got == np.arange(500)).all()
    got_d = np.asarray(rd.from_numpy(vals, parallelism=5).sort(
        descending=True).take_all())
    assert (got_d == np.arange(499, -1, -1)).all()
    return [got, got_d]


FLOWS = [from_items_roundtrip, range_map_filter, map_batches_block_level,
         iter_batches_sizes, take_is_streaming, backpressure_bounds_buffering,
         random_shuffle, streaming_split_disjoint_and_complete,
         streaming_split_feeds_trainer, iter_batches_numpy_format,
         exact_random_shuffle, sort_global_order, sort_by_column_key,
         groupby_aggregates, repartition_and_split, limit_union_flat_map,
         column_ops_and_schema, csv_json_roundtrip, parquet_roundtrip,
         pandas_numpy_interop, preprocessors, single_block_barrier_ops,
         barrier_ops_lazy_and_deterministic, actor_pool_map_batches,
         class_udf_requires_actor_pool, columnar_zero_copy_ingest,
         map_batches_numpy_format_columnar_through,
         exchange_streams_inside_executor,
         columnar_sort_and_shuffle_vectorized]


def map_batches_worker_modules(rt, rd, tmp):
    """First on the port's fresh session: the modules a data task's worker
    (and the split coordinator's) has loaded."""

    def loaded(block):
        import sys

        return [sorted({m.split(".")[0] for m in sys.modules}
                       & {"torch", "jax", "jaxlib", "ray_tpu"})]

    ds = rd.from_items(list(range(8)), parallelism=4).map_batches(loaded)
    (it,) = ds.streaming_split(1)
    got = list(it.iter_rows())
    it.stop()
    return got


def shuffle_larger_than_object_store(rt, rd, tmp):
    """A shuffle of a dataset ~4x the object store completes: partition
    outputs spill instead of pinning (its own small-store session)."""
    nblocks, rows_per = 64, 512
    ds = rd.from_items(list(range(nblocks)), parallelism=nblocks).map_batches(
        lambda b: {"x": np.full((rows_per, 1024), b[0], np.float32),
                   "i": np.full(rows_per, b[0], np.int64)},
        batch_format="rows").random_shuffle(seed=3)
    seen = np.zeros(nblocks, dtype=np.int64)
    order = []
    for batch in ds.iter_batches(batch_size=256, batch_format="numpy"):
        np.add.at(seen, batch["i"], 1)
        order.extend(batch["i"].tolist())
    assert len(order) == nblocks * rows_per and (seen == rows_per).all()
    return order


def _args(tmp_factory):
    return lambda name: (_data(name), str(tmp_factory.mktemp(name)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 4, "object_store_memory": 256 * 1024 * 1024}
    return {
        "ray_tpu": run_flows("ray_tpu", FLOWS, init,
                             _args(tmp_path_factory)),
        "ray_tpu_torch": run_flows(
            "ray_tpu_torch", [map_batches_worker_modules] + FLOWS, init,
            _args(tmp_path_factory)),
    }


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_a_data_task_worker_loads_no_torch(runs):
    got = runs["ray_tpu_torch"]["map_batches_worker_modules"]
    assert got == ("value", [[]] * 4), got


def test_zero_copy_batches_are_read_only_views(runs):
    """A batch cut from one block maps the store's pages: not its own
    memory and not writable, in both packages (the pump copies such an
    array rather than aliasing it: test_torch_data_prefetch.py)."""
    got = runs["ray_tpu_torch"]["columnar_zero_copy_ingest"]
    assert got == ("value", [10, False, False])


def test_shuffle_larger_than_object_store(tmp_path_factory):
    init = {"num_cpus": 4, "object_store_memory": 32 * 1024 * 1024,
            "system_config": {"object_spilling_enabled": True,
                              "object_spilling_threshold": 0.5}}
    got = {name: run_flows(name, [shuffle_larger_than_object_store], init,
                           _args(tmp_path_factory))
           for name in ("ray_tpu", "ray_tpu_torch")}
    ref = got["ray_tpu"]["shuffle_larger_than_object_store"]
    assert ref[0] == "value", ref[:3]
    assert got["ray_tpu_torch"]["shuffle_larger_than_object_store"] == ref
