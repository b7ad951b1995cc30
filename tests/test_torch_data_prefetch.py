"""The port's text and binary readers and its device feed,
``Dataset.iter_device_batches``, against the JAX package's: the flows of
tests/test_data_prefetch_sources.py, each run once on each package (one
runtime session per package, ``torch_parity.run_flows``).

``iter_device_batches(device="cpu")`` yields torch tensors; the reference
yields ``jax.Array``s. A flow hands back each batch as numpy (``np.asarray``
of the reference's, ``Tensor.numpy()`` of the port's), so the two compare
value for value and dtype for dtype. Port-only: the feed on a worker that
sees no card raises rather than yielding CPU tensors, and a batch sliced
from the object store's pages is copied, never aliased.
"""

import importlib
import os
import time

import numpy as np
import pytest
from torch_parity import norm, run_flows


def _data(name):
    return importlib.import_module(name + ".data")


def _device_kw(rt):
    return {"device": "cpu"} if rt.__name__ == "ray_tpu_torch" else {}


def _host(rt, batch):
    """A device batch as numpy, checking its type on the way."""
    if rt.__name__ == "ray_tpu_torch":
        import torch

        assert isinstance(batch, torch.Tensor) and batch.device.type == "cpu"
        return batch.numpy()
    assert hasattr(batch, "devices") or hasattr(batch, "sharding")
    return np.asarray(batch)


# ---------------------------------------------------------------- flows


def read_text_roundtrip(rt, rd, tmp):
    with open(os.path.join(tmp, "a.txt"), "w") as f:
        f.write("alpha\nbeta\n")
    with open(os.path.join(tmp, "b.txt"), "w") as f:
        f.write("gamma\n")
    rows = rd.read_text(tmp).take_all()
    assert rows == [{"text": "alpha"}, {"text": "beta"}, {"text": "gamma"}]
    one = rd.read_text(os.path.join(tmp, "b.txt")).take_all()
    assert one == [{"text": "gamma"}]
    return [rows, one]


def read_binary_files_roundtrip(rt, rd, tmp):
    with open(os.path.join(tmp, "x.bin"), "wb") as f:
        f.write(b"\x00\x01\x02")
    with open(os.path.join(tmp, "y.bin"), "wb") as f:
        f.write(b"hello")
    rows = rd.read_binary_files([os.path.join(tmp, "x.bin"),
                                 os.path.join(tmp, "y.bin")]).take_all()
    assert [r["bytes"] for r in rows] == [b"\x00\x01\x02", b"hello"]
    assert rows[0]["path"].endswith("x.bin")
    return [[r["bytes"] for r in rows],
            [os.path.basename(r["path"]) for r in rows]]


def iter_device_batches_values(rt, rd, tmp):
    ds = rd.from_numpy(np.arange(100, dtype=np.int32))
    batches = [_host(rt, b) for b in ds.iter_device_batches(
        batch_size=32, **_device_kw(rt))]
    got = [v for b in batches for v in b.tolist()]
    assert sorted(got) == list(range(100))
    return batches


def iter_device_batches_columnar(rt, rd, tmp):
    """Dict batches of several dtypes, cut across block edges."""
    rows = [{"tokens": np.arange(i, i + 5, dtype=np.int32),
             "mask": np.full(5, i % 2, np.float32)} for i in range(11)]
    ds = rd.from_items(rows, parallelism=3).map_batches(
        lambda b: {"tokens": b["tokens"], "mask": b["mask"]},
        batch_format="numpy")
    out = []
    for b in ds.iter_device_batches(batch_size=4, prefetch_batches=1,
                                    **_device_kw(rt)):
        out.append({k: _host(rt, v) for k, v in sorted(b.items())})
    assert [len(b["tokens"]) for b in out] == [4, 4, 3]
    return out


def iter_device_batches_overlaps_host_and_consumer(rt, rd, tmp):
    H = C = 0.05
    n = 8

    def slow_host(b):
        import time as _t

        _t.sleep(H)  # stand-in for decode/augment cost
        return b

    ds = rd.range(n * 16, parallelism=n).map_batches(slow_host)
    _ = list(ds.iter_batches(batch_size=16))  # warm the workers once
    t0 = time.perf_counter()
    seen = 0
    for _batch in ds.iter_device_batches(batch_size=16, prefetch_batches=2,
                                         **_device_kw(rt)):
        time.sleep(C)  # stand-in for the device step
        seen += 1
    overlapped = time.perf_counter() - t0
    assert seen == n
    assert overlapped < n * (H + C) * 0.75, (
        f"no overlap: {overlapped:.2f}s vs serial {n * (H + C):.2f}s")
    return seen


def iter_device_batches_propagates_errors(rt, rd, tmp):
    def boom(b):
        raise RuntimeError("decode failed")

    ds = rd.from_numpy(np.arange(8)).map_batches(boom)
    try:
        list(ds.iter_device_batches(batch_size=4, **_device_kw(rt)))
    except Exception as e:  # the message is part of the result
        assert "decode failed" in str(e)
        return "decode failed" in str(e)
    raise AssertionError("the error did not reach the consumer")


FLOWS = [read_text_roundtrip, read_binary_files_roundtrip,
         iter_device_batches_values, iter_device_batches_columnar,
         iter_device_batches_overlaps_host_and_consumer,
         iter_device_batches_propagates_errors]


def read_only_batches_are_copied(rt, rd, tmp):
    """Port-only: a batch that is a view of one block maps the store's
    read-only pages; the CPU feed hands out a copy of it (writable, its own
    memory), and counts it."""
    arr = np.arange(4000, dtype=np.float32).reshape(1000, 4)
    ds = rd.from_numpy(arr, parallelism=2)
    views = list(ds.iter_batches(batch_size=100, batch_format="numpy"))
    assert not views[0].flags["WRITEABLE"]
    it = ds.iter_device_batches(batch_size=100, device="cpu")
    got = list(it)
    for t in got:
        t.add_(0)  # writable: not the store's pages
    assert (np.concatenate([t.numpy() for t in got]) == arr).all()
    return [it.stats["readonly_copies"], len(got)]


def feed_without_a_card_raises(rt, rd, tmp):
    """Port-only: ``device=None`` means the card; a process that sees none
    raises at the call, never yielding CPU tensors."""
    ds = rd.from_numpy(np.arange(8))
    try:
        ds.iter_device_batches(batch_size=4)
    except RuntimeError as e:
        return str(e)
    raise AssertionError("the feed ran without a card")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 2, "object_store_memory": 256 * 1024 * 1024}

    def args(name):
        return _data(name), str(tmp_path_factory.mktemp(name))

    return {
        "ray_tpu": run_flows("ray_tpu", FLOWS, init, args),
        "ray_tpu_torch": run_flows(
            "ray_tpu_torch",
            FLOWS + [read_only_batches_are_copied, feed_without_a_card_raises],
            init, args),
    }


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_read_only_batches_are_copied(runs):
    assert runs["ray_tpu_torch"]["read_only_batches_are_copied"] == (
        "value", [10, 10])


def test_feed_without_a_card_raises(runs):
    # this box has no CUDA: the default device raises
    kind, message = runs["ray_tpu_torch"]["feed_without_a_card_raises"]
    assert kind == "value" and "CUDA" in message
