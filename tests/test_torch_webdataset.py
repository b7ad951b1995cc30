"""The port's webdataset tar shards (ray_tpu_torch/data/webdataset.py)
against the JAX package's: the webdataset flows of
tests/test_offline_webdataset.py, each run once on each package (one
runtime session per package, ``torch_parity.run_flows``). The shards'
members must read back alike, and the two packages must write the same
tar members for the same rows."""

import importlib
import io
import os
import tarfile

import numpy as np
import pytest
from torch_parity import norm, run_flows


def _wds(rt):
    return importlib.import_module(rt.__name__ + ".data.webdataset")


def _members(paths):
    """Each shard's member names and bytes (tar headers carry times)."""
    out = []
    for p in paths:
        with tarfile.open(p) as tf:
            out.append([(m.name, tf.extractfile(m).read())
                        for m in tf.getmembers()])
    return out


def webdataset_roundtrip(rt, rd, tmp):
    wds = _wds(rt)
    rows = [{"__key__": f"s{i:03d}", "txt": f"caption {i}",
             "json": {"label": i % 3}, "bin": bytes([i, i + 1])}
            for i in range(12)]
    shards = wds.write_webdataset(rd.from_items(rows, parallelism=3),
                                  os.path.join(tmp, "wds"))
    assert shards and all(s.endswith(".tar") for s in shards)
    back = sorted(wds.read_webdataset(shards, parallelism=2).take_all(),
                  key=lambda r: r["__key__"])
    assert len(back) == 12
    assert back[4]["txt"] == "caption 4"
    assert back[4]["json"] == {"label": 1}
    assert back[4]["bin"] == bytes([4, 5])
    raw = wds.read_webdataset(shards, decode=False).take_all()
    assert isinstance(raw[0]["txt"], bytes)
    return [[os.path.basename(s) for s in shards], back, raw,
            _members(shards)]


def webdataset_image_decoding(rt, rd, tmp):
    from PIL import Image

    wds = _wds(rt)

    def png_bytes(val):
        buf = io.BytesIO()
        Image.fromarray(np.full((4, 5, 3), val, dtype=np.uint8)).save(
            buf, format="PNG")
        return buf.getvalue()

    rows = [{"__key__": f"img{i}", "png": png_bytes(i * 20)}
            for i in range(3)]
    shards = wds.write_webdataset(rd.from_items(rows, parallelism=1),
                                  os.path.join(tmp, "w"))
    back = sorted(wds.read_webdataset(shards).take_all(),
                  key=lambda r: r["__key__"])
    assert back[1]["png"].shape == (4, 5, 3)
    assert int(back[1]["png"][0, 0, 0]) == 20
    return back


def webdataset_exports(rt, rd, tmp):
    """``read_webdataset`` / ``write_webdataset`` are the data package's
    exports, as in the reference."""
    wds = _wds(rt)
    assert rd.read_webdataset is wds.read_webdataset
    assert rd.write_webdataset is wds.write_webdataset
    return sorted(rd.__all__)


FLOWS = [webdataset_roundtrip, webdataset_image_decoding,
         webdataset_exports]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 2, "object_store_memory": 128 * 1024 * 1024}

    def args(name):
        return (importlib.import_module(name + ".data"),
                str(tmp_path_factory.mktemp(name)))

    return {name: run_flows(name, FLOWS, init, args)
            for name in ("ray_tpu", "ray_tpu_torch")}


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS[:2]])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_exports_are_the_reference_s_and_the_pump():
    """The port exports every name of the reference's ``data`` package,
    plus its device pump."""
    import ray_tpu.data as jrd
    import ray_tpu_torch.data as trd

    names = set(trd.__all__)
    assert names == set(jrd.__all__) | {"DeviceBatches", "device_batches"}
    for name in names:
        assert hasattr(trd, name), name


def test_webdataset_exports(runs):
    kind, names = runs["ray_tpu_torch"]["webdataset_exports"]
    assert kind == "value"
    assert runs["ray_tpu"]["webdataset_exports"] == (
        "value", sorted(set(names) - {"DeviceBatches", "device_batches"}))
