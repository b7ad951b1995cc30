"""The device batch pump (PyTorch port of ``_device_batches``,
``ray_tpu/data/iterator.py:287-342``).

``device_batches(batch_iter_factory, prefetch_batches, device=None,
sharding=None)`` runs ``batch_iter_factory()`` (any iterator of numpy
batches: arrays, or dicts, lists or tuples of them) on a pump thread and
yields each batch as tensors on ``device``, at most ``prefetch_batches``
ahead of the consumer. As in the reference: a bounded queue, errors raised
at the consumer, and a pump that unwinds when its consumer stops early
instead of blocking in ``put``.

With ``sharding`` = ``(mesh, placements)`` (``parallel.train_step.
batch_sharding``), every array is a global batch that each rank draws alike:
the pump moves only this rank's box of it (``mesh.local_box``) to the
device, and the consumer yields it as a DTensor of that layout. No
collective runs: this is what ``jax.device_put(batch, sharding)`` does.

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
from ray_tpu_torch.parallel.mesh import local_box, mesh_device

_ERROR = "__raytpu_prefetch_error__"


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn: Callable, tree, other):
    """``fn(leaf, other_leaf)`` over a tree and another of its structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


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


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def device_batches(batch_iter_factory: Callable[[], Iterable],
                   prefetch_batches: int,
                   device: DeviceLike = None,
                   sharding=None) -> DeviceBatches:
    """Yields the batches of ``batch_iter_factory()`` as tensors on
    ``device``, copied ahead of the consumer by a pump thread (device
    memory holds up to ``prefetch_batches`` + 2 batches). With ``sharding``
    = ``(mesh, placements)`` each array becomes a DTensor of which this
    rank holds its own box (on the mesh's device unless ``device`` says)."""
    if prefetch_batches < 1:
        raise ValueError("prefetch_batches must be >= 1")
    if sharding is None:
        dev = resolve_device(device)
    else:
        mesh, placements = sharding
        dev = mesh_device(mesh, device)

        def own_box(x):
            box = local_box(mesh, np.shape(x), placements)
            return np.asarray(x)[tuple(slice(a, b) for a, b in box)]

        def as_dtensor(local, shape):
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(local, mesh, placements, shape=shape,
                                      stride=_contiguous_stride(shape))
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
                if sharding is not None:
                    shapes = _tree_map(lambda x: tuple(np.shape(x)), batch)
                    batch = _tree_map(own_box, batch)
                host = _tree_map(_as_tensor, batch)
                if on_cuda:
                    host = _tree_map(lambda t: t.pin_memory(), host)
                    with torch.cuda.stream(stream):
                        item = (_tree_map(
                            lambda t: t.to(dev, non_blocking=True), host),
                            stream.record_event())
                else:
                    item = (host, None)
                if sharding is not None:
                    item += (shapes,)
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
                batch, event = item[:2]
                if event is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(event)
                    for t in _tensors(batch):
                        t.record_stream(cur)
                if sharding is not None:
                    batch = _zip_map(as_dtensor, batch, item[2])
                stats["batches"] += 1
                stats["ready"] += ready
                yield batch
        finally:
            aborted.set()
            while not q.empty():  # free a pump blocked awaiting a slot
                q.get_nowait()

    thread.start()
    return DeviceBatches(consume(), stats, thread)
