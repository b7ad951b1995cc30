"""Per-consumer iterators over a shared streaming execution, and the
device batch pump that lands their batches on the card (PyTorch port of
``ray_tpu/data/iterator.py``).

Parity: reference ``python/ray/data/_internal/iterator/stream_split_iterator
.py:31`` — one StreamingExecutor runs inside a coordinator actor; N
consumers (TorchTrainer workers, typically in other processes) pull blocks
round-robin via ``next_block`` RPCs. The executor's bounded buffers mean a
slow consumer throttles the whole pipeline instead of ballooning memory.

The pump (``device_batches``, the port of ``_device_batches``,
``ray_tpu/data/iterator.py:287-342``): ``device_batches(batch_iter_factory,
prefetch_batches, device=None, sharding=None)`` runs ``batch_iter_factory()``
(any iterator of numpy batches: arrays, or dicts, lists or tuples of them)
on a pump thread and yields each batch as tensors on ``device``, at most
``prefetch_batches`` ahead of the consumer. As in the reference: a bounded
queue, errors raised at the consumer, and a pump that unwinds when its
consumer stops early instead of blocking in ``put``.

With ``sharding`` = ``(mesh, placements)`` (``parallel.train_step.
batch_sharding``), every array is a global batch that each rank draws alike:
the pump moves only this rank's box of it (``mesh.local_box``) to the
device, and the consumer yields it as a DTensor of that layout. No
collective runs: this is what ``jax.device_put(batch, sharding)`` does.

On CUDA (``device=None`` means the current CUDA device; it raises without
one, and never yields CPU tensors) the pump copies each batch into pinned
host memory and on to the card with a non-blocking copy on a stream of its
own, and records an event. The consumer makes its current stream wait on
that event before it yields the batch, and marks every tensor as used on
that stream (``record_stream``), so the allocator cannot hand a batch's
memory to the pump again while a step still reads it. On the CPU
(``device="cpu"``) the pump moves nothing: a writable array becomes a
tensor over the same memory. A read-only array (a block mapped from the
object store, or a batch sliced from one) is copied first, on either
device: a tensor must not alias the store's pages, which are shared and
immutable. ``stats["readonly_copies"]`` counts those arrays.

Only the pump needs torch, and it imports it when called: ``import
ray_tpu_torch.data`` and a data task's worker load no torch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch


# Sentinel telling a consumer to back off and re-poll: the pipeline cannot
# advance without overflowing a slower split's bounded queue.
_RETRY = "__raytpu_split_retry__"

# Per-split buffered-block cap: bounds coordinator-side memory to
# n_splits * cap blocks even when one consumer stalls (the stall then
# backpressures every split, which backpressures the executor itself).
_SPLIT_QUEUE_CAP = 4


class _SplitCoordinator:
    """Actor: owns the executor, deals blocks round-robin to n splits.

    Dealing is arrival-ordered and the executor yields in output-index
    order, so split ``i`` receives exactly the blocks with
    ``idx % n == i`` — which is why ``locality_hints[i]`` (the node that
    consumes split ``i``) can route block ``idx``'s production to
    ``hints[idx % n]`` and have every block land on its consumer's
    host.

    Production runs on a dedicated pump thread, AHEAD of demand: the
    executor's launches/harvests overlap consumer think time (demand-
    clocking production behind serialized next_block RPCs leaves every
    block arriving just-in-time — the consumer then eats the full
    production latency as stall on every step), and the split queues
    are already full when an epoch's first ``run_step`` asks for data.
    A full round-robin target queue parks the pump (consumer-lag
    backpressure), which stops pumping the executor, whose own buffer
    caps stall production upstream — a slow consumer bounds the whole
    pipeline's memory.

    NOTE the pump thread is only safe because task_done completions
    carry a starvation-bound flush (conduit_rpc.task_done_fn): without
    it, one consumer's RPC churn could starve the executor's task
    completions and the other consumers' replies indefinitely."""

    def __init__(self, source_refs, stages, n: int,
                 locality_hints=None, gang=None):
        import threading

        from ray_tpu_torch.data.streaming import StreamingExecutor

        self.n = n
        # Wider pipe than the single-consumer default: in-flight tasks
        # count against the buffer cap, so 4/4 leaves ~2 tasks running
        # once the reorder buffer holds a straggler — far under what n
        # consumers drain. 3 in-system blocks per consumer keeps every
        # free CPU producing while staying bounded (refs in the store,
        # spillable; backpressure caps just scale with the fan-out).
        self._executor = StreamingExecutor(
            stages, source_refs,
            max_tasks_in_flight=max(4, 3 * n),
            max_buffered_blocks=max(4, 3 * n),
            locality_hints=locality_hints, gang=gang,
        )
        self._queues: List[List] = [[] for _ in range(n)]
        self._rr = 0
        self._exhausted = False
        self._calls = [0] * n  # next_block arrivals per split (stats)
        self._retries = 0  # _RETRY replies (producer-behind signals)
        self._error: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._pump = threading.Thread(
            target=self._pump_loop, daemon=True, name="split-pump"
        )
        self._pump.start()

    def _pump_loop(self):
        """Deal executor output refs round-robin into the split queues,
        parking when the round-robin target is full (bounded memory)."""
        try:
            for ref in self._executor.iter_output_refs():
                with self._cv:
                    while len(self._queues[self._rr]) >= _SPLIT_QUEUE_CAP:
                        self._cv.wait(0.25)
                    self._queues[self._rr].append(ref)
                    self._rr = (self._rr + 1) % self.n
                    self._cv.notify_all()
        except BaseException as e:  # surfaced to every consumer
            with self._cv:
                self._error = e
        finally:
            with self._cv:
                self._exhausted = True
                self._cv.notify_all()

    def next_block(self, split: int, max_n: int = 1):
        """Up to ``max_n`` block refs (as a list) for ``split``; None at
        end of data; the _RETRY sentinel when the producer is behind
        (the consumer backs off briefly — visible stall, never a
        hang)."""
        with self._cv:
            self._calls[split] += 1
            q = self._queues[split]
            if not q and not self._exhausted:
                # one bounded wait only: actor methods serialize, so a
                # long block here would gate the OTHER splits' RPCs
                self._cv.wait(0.05)
            if q:
                # return REFS (inside a list so the reply is a
                # ref-bearing value, not an auto-resolved task arg):
                # each block then moves producer->consumer over the
                # object plane exactly once, instead of being funneled
                # by value through this actor
                out = q[:max(1, max_n)]
                del q[:len(out)]
                self._cv.notify_all()  # wake a pump parked on this queue
                return out
            if self._exhausted:
                if self._error is not None:
                    raise self._error
                return None
            self._retries += 1
            return _RETRY

    def stats(self):
        with self._cv:
            return {"queues": [len(q) for q in self._queues],
                    "calls": list(self._calls),
                    "retries": self._retries,
                    "exhausted": self._exhausted,
                    "executor": self._executor.stats()}


class DataIterator:
    """Picklable consumer handle: ships to worker processes.

    ``timeout`` (seconds) bounds each next_block RPC; None = wait forever
    (slow stages are a pipeline property, not a failure)."""

    def __init__(self, coordinator, split: int,
                 timeout: Optional[float] = None):
        self._coord = coordinator
        self._split = split
        self._timeout = timeout
        self._prefetcher = None  # active/last BlockPrefetcher (stats)

    def _ref_stream(self) -> Iterator:
        """This split's block refs as the coordinator deals them (the
        RPC runs on whatever thread drains this — under prefetch, the
        agent's thread, off the consumer's step). Refs arrive in
        BATCHES of up to the coordinator's per-split queue cap, and TWO
        requests stay in flight: while this consumer processes one
        reply, its next request is already queued at the coordinator —
        the round-trip latency overlaps the coordinator's fill work
        instead of serializing with it (ordered-actor execution keeps
        the replies in submission order)."""
        import collections
        import time as _time

        pending: "collections.deque" = collections.deque()
        for _ in range(2):
            pending.append(
                self._coord.next_block.remote(self._split,
                                              _SPLIT_QUEUE_CAP)
            )
        draining = False
        while pending:
            reply = ray_tpu_torch.get(pending.popleft(), timeout=self._timeout)
            if reply is None:
                draining = True  # end of data: consume what's in flight
                continue
            if isinstance(reply, str) and reply == _RETRY:
                _time.sleep(0.005)  # producer behind: back off, re-poll
                # (short: this chains behind the coordinator's own 50 ms
                # bounded wait — a long backoff here turns one near-miss
                # at the epoch tail into a visible step stall)
            if not draining:
                pending.append(
                    self._coord.next_block.remote(self._split,
                                                  _SPLIT_QUEUE_CAP)
                )
            if not isinstance(reply, str):
                yield from reply

    def iter_native_blocks(self, prefetch_blocks: int = 0) -> Iterator:
        """Blocks in stored form (row list or columnar dict).

        ``prefetch_blocks`` > 0 runs a per-host
        :class:`~ray_tpu_torch.data.prefetch.BlockPrefetcher`: upcoming blocks
        resolve through the local raylet's windowed striped pulls ahead
        of consumption (bounded by consumer lag, capped at
        ``prefetch_blocks`` buffered blocks)."""
        if prefetch_blocks and prefetch_blocks > 0:
            from ray_tpu_torch.data.prefetch import BlockPrefetcher

            pf = BlockPrefetcher(
                self._ref_stream(), max_ahead=prefetch_blocks,
                timeout=self._timeout,
                name=f"split{self._split}",
            )
            self._prefetcher = pf
            try:
                yield from pf
            finally:
                pf.close()
            return
        for ref in self._ref_stream():
            yield ray_tpu_torch.get(ref, timeout=self._timeout)

    def iter_blocks(self) -> Iterator[List]:
        from ray_tpu_torch.data.block import BlockAccessor

        for block in self.iter_native_blocks():
            yield BlockAccessor.for_block(block).to_rows()

    def stop(self):
        """Kill the shared coordinator actor (call once per split group,
        e.g. when a trainer attempt ends)."""
        try:
            ray_tpu_torch.kill(self._coord)
        except Exception:
            pass

    def iter_rows(self) -> Iterator[Any]:
        from ray_tpu_torch.data.block import BlockAccessor

        for block in self.iter_native_blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def stats(self):
        """Ingest observability for this consumer: the active (or last)
        prefetch agent's counters — ``ingest_stall_s`` is the time the
        consumer waited on the producer (slow pipeline), bounded depth
        counters prove backpressure held."""
        pf = self._prefetcher
        return {"prefetch": pf.stats() if pf is not None else None}

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "rows",
                     prefetch_blocks: int = 0) -> Iterator:
        from ray_tpu_torch.data.dataset import batches_from_blocks

        return batches_from_blocks(
            self.iter_native_blocks(prefetch_blocks=prefetch_blocks),
            batch_size, batch_format,
        )

    def iter_device_batches(self, batch_size: int = 256, *,
                            prefetch_batches: int = 2,
                            prefetch_blocks: int = 2,
                            sharding=None, device=None) -> "DeviceBatches":
        """Double-buffered device feed: the pump thread fetches the NEXT
        numpy batch and copies it to ``device`` (default: this process's
        current CUDA card; it raises without one) while the step consumes
        the current one, so host decode and the host-to-device copy
        overlap compute instead of serializing with it.

        Parity: reference ``iter_torch_batches(prefetch_batches=...)``
        (python/ray/data/iterator.py), through :func:`device_batches`.
        ``sharding=(mesh, placements)`` yields each rank's box as DTensors.

        ``prefetch_batches`` bounds in-flight device batches.
        ``prefetch_blocks`` runs the per-host block prefetch agent ON
        by default (2 blocks ahead over the zero-copy pull plane, lag-
        bounded): host-side block arrival overlaps the step the same way
        the device double-buffer overlaps the host-to-device copy. 0
        disables it (blocks resolve inline).
        """
        return device_batches(
            lambda: self.iter_batches(
                batch_size, batch_format="numpy",
                prefetch_blocks=prefetch_blocks,
            ),
            prefetch_batches, device=device, sharding=sharding,
        )


# ---------------------------------------------------------------- the pump

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


def _as_tensor(x, pin: bool = False, stats: Optional[Dict] = None):
    """A numpy leaf as a CPU tensor: over the same memory when the array is
    writable, else over a private copy (a read-only array maps the object
    store's pages); with ``pin``, always a copy into pinned memory (the
    one copy a card-bound batch makes on the host)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.pin_memory() if pin else x
    arr = np.asarray(x)
    if not arr.flags.writeable and stats is not None:
        stats["readonly_copies"] += 1
    if pin:
        out = torch.empty(arr.shape, pin_memory=True,
                          dtype=torch.from_numpy(arr[:0].copy()).dtype)
        np.copyto(out.numpy(), arr)
        return out
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


class DeviceBatches:
    """The iterator ``device_batches`` returns. ``stats`` counts, as the
    batches go: ``batches`` yielded; ``ready`` of them already waiting when
    the consumer asked (prefetched); ``host_s``, the pump's time to draw,
    pin and enqueue them; ``wait_s``, the consumer's time blocked waiting
    for one; ``readonly_copies``, the read-only arrays copied rather than
    aliased. ``thread`` is the pump thread."""

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
                   device=None,
                   sharding=None) -> DeviceBatches:
    """Yields the batches of ``batch_iter_factory()`` as tensors on
    ``device``, copied ahead of the consumer by a pump thread (device
    memory holds up to ``prefetch_batches`` + 2 batches). With ``sharding``
    = ``(mesh, placements)`` each array becomes a DTensor of which this
    rank holds its own box (on the mesh's device unless ``device`` says)."""
    import torch

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.parallel.mesh import local_box, mesh_device

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
    stats = {"batches": 0, "ready": 0, "host_s": 0.0, "wait_s": 0.0,
             "readonly_copies": 0}

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
                host = _tree_map(
                    lambda x: _as_tensor(x, pin=on_cuda, stats=stats), batch)
                if on_cuda:
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
