"""The port's logical-plan fusion and its image / tfrecords / Hugging Face /
SQL sources against the JAX package's: the flows of
tests/test_data_plan_sources.py, each run once on each package and
compared through ``torch_parity.norm`` (one runtime session per package,
``torch_parity.run_flows``)."""

import importlib
import os
import sqlite3

import numpy as np
import pytest
from torch_parity import norm, run_flows


def _data(name):
    return importlib.import_module(name + ".data")


def _mod(rt, sub):
    return importlib.import_module(rt.__name__ + ".data." + sub)


# ---------------------------------------------------------------- flows


def adjacent_maps_fuse_in_physical_plan(rt, rd, tmp):
    plan = _mod(rt, "plan")
    ds = (rd.range(10).map(lambda x: x + 1).filter(lambda x: x % 2 == 0)
          .map_batches(lambda rows: rows, batch_format="rows"))
    phys = plan.optimize(ds._stages)
    assert len(phys) == 1 and isinstance(phys[0], plan.FusedStage)
    assert "map" in phys[0].name and "filter" in phys[0].name
    text = ds.explain()
    assert "Logical plan" in text and "Fused[" in text
    return [phys[0].name, text, sorted(ds.take_all())]


def fusion_breaks_at_exchange_and_actor_pool(rt, rd, tmp):
    plan = _mod(rt, "plan")
    ds = (rd.range(20).map(lambda x: x + 1).random_shuffle(seed=0)
          .map(lambda x: x * 2).map(lambda x: x - 1))
    phys = plan.optimize(ds._stages)
    assert len(phys) == 3
    assert isinstance(phys[0], plan.FusedStage)
    assert phys[1].name == "random_shuffle"
    assert isinstance(phys[2], plan.FusedStage)
    ds2 = (rd.range(10).map(lambda x: x + 1).map_batches(
        lambda rows: rows, batch_format="rows",
        compute=rd.ActorPoolStrategy(size=1)))
    phys2 = plan.optimize(ds2._stages)
    assert len(phys2) == 2
    return [[s.name for s in phys], [s.name for s in phys2], ds.take_all()]


def fused_pipeline_results_match_unfused(rt, rd, tmp):
    plan = _mod(rt, "plan")
    ds = (rd.from_items(list(range(50)), parallelism=4)
          .map(lambda x: x + 1).filter(lambda x: x % 2 == 0)
          .map(lambda x: x * 10))
    fused = sorted(ds.take_all())
    orig = plan.optimize
    try:
        plan.optimize = lambda stages: stages
        unfused = sorted(ds.take_all())
    finally:
        plan.optimize = orig
    assert fused == unfused == [i * 10 for i in range(2, 52, 2)]
    return fused


def read_images_roundtrip(rt, rd, tmp):
    from PIL import Image

    for i in range(4):
        Image.fromarray(np.full((8, 6, 3), i * 10, dtype=np.uint8)).save(
            os.path.join(tmp, f"img_{i}.png"))
    rows = sorted(rd.read_images(tmp, parallelism=2,
                                 include_paths=True).take_all(),
                  key=lambda r: r["path"])
    assert len(rows) == 4 and rows[0]["image"].shape == (8, 6, 3)
    assert int(rows[2]["image"][0, 0, 0]) == 20
    small = rd.read_images(tmp, size=(4, 3), mode="L").take_all()
    assert small[0]["image"].shape == (4, 3)
    return [[r["image"] for r in rows], [os.path.basename(r["path"])
                                         for r in rows],
            [r["image"] for r in small]]


def tfrecords_roundtrip(rt, rd, tmp):
    payloads = [b"alpha", b"bravo" * 100, b"", b"delta"]
    out = os.path.join(tmp, "out")
    files = rd.from_items([{"bytes": p} for p in payloads],
                          parallelism=2).write_tfrecords(out)
    assert files
    back = rd.read_tfrecords([os.path.join(out, p)
                              for p in sorted(os.listdir(out))],
                             verify=True).take_all()
    assert [r["bytes"] for r in back] == payloads
    raw = [open(os.path.join(out, p), "rb").read()
           for p in sorted(os.listdir(out))]
    return [back, raw]


def tfrecords_corruption_detected(rt, rd, tmp):
    files = rd.from_items([{"bytes": b"payload-123"}],
                          parallelism=1).write_tfrecords(
        os.path.join(tmp, "c"))
    path = files[0]
    raw = bytearray(open(path, "rb").read())
    raw[-6] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(raw))
    try:
        rd.read_tfrecords([path], verify=True).take_all()
        raise AssertionError("a corrupt record was read")
    except AssertionError:
        raise
    except Exception as e:  # the class is part of the result
        err = type(e).__name__
    out = rd.read_tfrecords([path], verify=False).take_all()
    assert len(out) == 1
    return [err, out]


def from_huggingface_shape(rt, rd, tmp):
    class FakeHF:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"text": f"t{i}", "label": i % 2}

    ds = rd.from_huggingface(FakeHF(), parallelism=3)
    rows = ds.take_all()
    assert len(rows) == 10 and rows[3] == {"text": "t3", "label": 1}
    assert ds.num_blocks() >= 3
    return [rows, ds.num_blocks()]


def read_sql_sqlite(rt, rd, tmp):
    db = os.path.join(tmp, "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE items (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO items VALUES (?, ?)",
                     [(i, f"n{i}") for i in range(57)])
    conn.commit()
    conn.close()

    def factory(_db=db):
        import sqlite3 as _s

        return _s.connect(_db)

    rows = rd.read_sql("SELECT id, name FROM items ORDER BY id", factory,
                       parallelism=4).take_all()
    assert len(rows) == 57 and sorted(r["id"] for r in rows) == list(
        range(57))
    assert rows[0].keys() == {"id", "name"}
    one = rd.read_sql("SELECT id FROM items ORDER BY id LIMIT 5",
                      factory).take_all()
    assert [r["id"] for r in one] == [0, 1, 2, 3, 4]
    return [rows, one]


FLOWS = [adjacent_maps_fuse_in_physical_plan,
         fusion_breaks_at_exchange_and_actor_pool,
         fused_pipeline_results_match_unfused, read_images_roundtrip,
         tfrecords_roundtrip, tfrecords_corruption_detected,
         from_huggingface_shape, read_sql_sqlite]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 2, "object_store_memory": 256 * 1024 * 1024}

    def args(name):
        return _data(name), str(tmp_path_factory.mktemp(name))

    return {name: run_flows(name, FLOWS, init, args)
            for name in ("ray_tpu", "ray_tpu_torch")}


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


@pytest.mark.parametrize("data", [b"123456789", b"", b"\x00" * 32,
                                  bytes(range(256))])
def test_tfrecord_crc_equals_the_reference(data):
    """The masked CRC-32C of the TFRecord spec: the golden Castagnoli
    vector (crc32c("123456789") == 0xE3069283), and the port's
    ``_crc32c`` / ``_masked_crc`` equal to the reference's on every
    input."""
    from ray_tpu.data import io as jio
    from ray_tpu_torch.data import io as tio

    assert tio._crc32c(b"123456789") == 0xE3069283
    assert tio._crc32c(data) == jio._crc32c(data)
    assert tio._masked_crc(data) == jio._masked_crc(data)
