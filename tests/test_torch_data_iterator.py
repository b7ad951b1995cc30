"""The port's device batch pump (ray_tpu_torch/data/iterator.py) on the CPU,
against the JAX package's ``_device_batches`` (``ray_tpu/data/iterator.py:
287``) over the same plain numpy iterators, and for the reference's
properties: overlap of host and consumer work (the bound of
``tests/test_data_prefetch_sources.py:54``), errors at the consumer, the
``prefetch_batches`` check and the abandoned-consumer guard."""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.data.iterator import _device_batches
from ray_tpu_torch.data import device_batches


def _numpy_batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 100, (2, 8)).astype(np.int32),
             "mask": (rng.random((2, 8)) < 0.5).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("prefetch", [1, 3])
def test_values_in_order_equal_jax(prefetch):
    batches = _numpy_batches()
    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in _device_batches(lambda: iter(batches), prefetch, None)]
    it = device_batches(lambda: iter(batches), prefetch, device="cpu")
    got = list(it)
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
            assert g[k].numpy().dtype == w[k].dtype
    assert it.stats["batches"] == len(batches)


def test_plain_arrays_and_tuples():
    src = [np.arange(4) + i for i in range(3)]
    got = [t.tolist() for t in device_batches(lambda: iter(src), 2,
                                              device="cpu")]
    assert got == [a.tolist() for a in src]
    pairs = [(np.ones(2) * i, np.zeros(1)) for i in range(2)]
    out = list(device_batches(lambda: iter(pairs), 1, device="cpu"))
    assert all(isinstance(b, tuple) and len(b) == 2 for b in out)
    np.testing.assert_array_equal(out[1][0].numpy(), pairs[1][0])


def test_cpu_pump_moves_nothing():
    batch = {"x": np.arange(6, dtype=np.float32)}
    (got,) = device_batches(lambda: iter([batch]), 1, device="cpu")
    assert got["x"].data_ptr() == batch["x"].ctypes.data


def test_overlaps_host_and_consumer():
    """Host cost H per batch on the pump and consumer cost C per batch:
    serial time is N (H + C); the pump must save at least a quarter of it,
    as the reference's test asks of ``iter_device_batches``. (With H = C
    whether a given batch is already waiting is a tie that thread
    scheduling breaks, so prefetch is checked apart, with events:
    ``test_prefetches_while_the_consumer_works``.)"""
    H = C = 0.05
    n = 8

    def slow_source():
        for i in range(n):
            time.sleep(H)  # stand-in for decode/augment cost
            yield {"x": np.full(4, i)}

    t0 = time.perf_counter()
    seen = []
    it = device_batches(slow_source, 2, device="cpu")
    for batch in it:
        time.sleep(C)  # stand-in for the device step
        seen.append(int(batch["x"][0]))
    overlapped = time.perf_counter() - t0
    assert seen == list(range(n))
    serial_floor = n * (H + C)
    assert overlapped < serial_floor * 0.75, (
        f"no overlap: {overlapped:.2f}s vs serial {serial_floor:.2f}s")


def test_prefetches_while_the_consumer_works():
    """With the pump strictly ahead of its consumer, every batch but the
    first is waiting when the consumer asks for it. The source marks batch
    i queued when the pump comes back to it for more (the pump enqueues a
    batch before it draws the next); the consumer, holding batch i, waits
    for batch i + 1's mark before it asks, so no timing decides the count."""
    n = 8
    queued = [threading.Event() for _ in range(n)]

    def source():
        for i in range(n):
            yield {"x": np.full(4, i)}
            queued[i].set()

    it = device_batches(source, 2, device="cpu")
    seen = []
    for batch in it:
        i = int(batch["x"][0])
        seen.append(i)
        if i + 1 < n:
            assert queued[i + 1].wait(30), f"batch {i + 1} never queued"
    assert seen == list(range(n))
    assert it.stats["ready"] >= n - 1, it.stats


def test_errors_propagate_to_the_consumer():
    def broken():
        yield {"x": np.zeros(2)}
        yield {"x": np.ones(2)}
        raise OSError("source failed")

    it = device_batches(broken, 1, device="cpu")
    assert next(it)["x"].tolist() == [0, 0]
    assert next(it)["x"].tolist() == [1, 1]
    with pytest.raises(OSError, match="source failed"):
        next(it)


@pytest.mark.parametrize("prefetch", [0, -1])
def test_prefetch_below_one_raises(prefetch):
    with pytest.raises(ValueError, match="prefetch_batches"):
        device_batches(lambda: iter([]), prefetch, device="cpu")


@pytest.mark.parametrize("how", ["break", "close"])
def test_abandoned_consumer_lets_the_pump_exit(how):
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield np.array([i])
            i += 1

    it = device_batches(endless, 1, device="cpu")
    thread = it.thread
    for batch in it:
        assert int(batch[0]) == 0
        break
    if how == "close":
        it.close()
    else:
        del it, batch
        gc.collect()
    thread.join(timeout=3.0)
    assert not thread.is_alive()
    assert len(produced) <= 4  # the pump stopped drawing from its source
    assert thread.name == "device-prefetch"
    assert thread not in threading.enumerate()


def test_no_cuda_device_raises_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_batches(lambda: iter([]), 1)
