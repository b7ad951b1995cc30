"""The device batch pump (PyTorch port of ``_device_batches``,
``ray_tpu/data/iterator.py:287-342``).

``device_batches(batch_iter_factory, prefetch_batches, device=None)`` runs
``batch_iter_factory()`` (any iterator of numpy batches: arrays, or dicts,
lists or tuples of them) on a pump thread and yields each batch as tensors
on ``device``, at most ``prefetch_batches`` ahead of the consumer. As in the
reference: a bounded queue, errors raised at the consumer, and a pump that
unwinds when its consumer stops early instead of blocking in ``put``.

On CUDA (``device=None`` means the current CUDA device; it raises without
one) the pump copies each batch into pinned host memory and on to the card
with a non-blocking copy on a stream of its own, and records an event. The
consumer makes its current stream wait on that event before it yields the
batch, and marks every tensor as used on that stream (``record_stream``),
so the allocator cannot hand a batch's memory to the pump again while a
step still reads it. On the CPU (``device="cpu"``) the pump moves nothing:
arrays become tensors over the same memory.

``Dataset.iter_device_batches`` waits for the port's runtime planes.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

_ERROR = "__raytpu_prefetch_error__"


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class DeviceBatches:
    """The iterator ``device_batches`` returns. ``stats`` counts, as the
    batches go: ``batches`` yielded; ``ready`` of them already waiting when
    the consumer asked (prefetched); ``host_s``, the pump's time to draw,
    pin and enqueue them; ``wait_s``, the consumer's time blocked waiting
    for one. ``thread`` is the pump thread."""

    def __init__(self, gen: Iterator, stats: Dict[str, Any],
                 thread: threading.Thread):
        self._gen = gen
        self.stats = stats
        self.thread = thread

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        """Stops the pump (as dropping the iterator does)."""
        self._gen.close()


def device_batches(batch_iter_factory: Callable[[], Iterable],
                   prefetch_batches: int,
                   device: DeviceLike = None) -> DeviceBatches:
    """Yields the batches of ``batch_iter_factory()`` as tensors on
    ``device``, copied ahead of the consumer by a pump thread (device
    memory holds up to ``prefetch_batches`` + 2 batches)."""
    if prefetch_batches < 1:
        raise ValueError("prefetch_batches must be >= 1")
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=prefetch_batches)
    _END = object()
    # Abandoned-consumer guard: a train loop that breaks out early drops
    # the iterator; the pump must unwind, not block in q.put pinning device
    # buffers and the source iterator forever.
    aborted = threading.Event()
    stats = {"batches": 0, "ready": 0, "host_s": 0.0, "wait_s": 0.0}

    def _put(item) -> bool:
        while not aborted.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            stream = torch.cuda.Stream(dev) if on_cuda else None
            it = iter(batch_iter_factory())
            while True:
                t0 = time.perf_counter()
                batch = next(it, _END)
                if batch is _END:
                    break
                host = _tree_map(_as_tensor, batch)
                if on_cuda:
                    host = _tree_map(lambda t: t.pin_memory(), host)
                    with torch.cuda.stream(stream):
                        item = (_tree_map(
                            lambda t: t.to(dev, non_blocking=True), host),
                            stream.record_event())
                else:
                    item = (host, None)
                stats["host_s"] += time.perf_counter() - t0
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # surfaced to the consumer
            _put((_ERROR, e))

    thread = threading.Thread(target=pump, daemon=True,
                              name="device-prefetch")

    def consume():
        try:
            while True:
                t0 = time.perf_counter()
                ready = not q.empty()
                item = q.get()
                stats["wait_s"] += time.perf_counter() - t0
                if item is _END:
                    return
                if item[0] is _ERROR:
                    raise item[1]
                batch, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(event)
                    for t in _tensors(batch):
                        t.record_stream(cur)
                stats["batches"] += 1
                stats["ready"] += ready
                yield batch
        finally:
            aborted.set()
            while not q.empty():  # free a pump blocked awaiting a slot
                q.get_nowait()

    thread.start()
    return DeviceBatches(consume(), stats, thread)
