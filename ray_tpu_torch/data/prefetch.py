"""Per-host block prefetch agent: the consumer leg of the streaming
data plane.

One :class:`BlockPrefetcher` runs per ingest consumer (a trainer rank's
:class:`~ray_tpu_torch.data.iterator.DataIterator`, or a driver-side
``Dataset`` iteration). A background thread resolves upcoming block refs
through ``ray_tpu_torch.get`` — for a remote block that is the local raylet's
windowed striped pull (``read_object_chunks``: deposit sinks stream the
bytes wire->arena with no Python-side copies), after which the consumer's
blocks are zero-copy views over the sealed local store object. The agent
therefore keeps the consumer's NEXT blocks sealed in the local arena
before they are asked for, so ingest overlaps the device step instead of
serializing with it.

Backpressure is derived from **consumer lag**, not a fixed queue depth:
the agent tracks an EMA of its own fetch latency and of the consumer's
per-block drain time, and keeps only enough blocks buffered to cover one
fetch at the observed drain rate (bounded by ``[1, max_ahead]``). A slow
consumer thus bounds producer-side memory to a couple of blocks (the
upstream executor's own buffer caps then throttle production), and a
slow producer surfaces as ``ingest_stall_s`` in :meth:`stats` — visible
stall time, never a hang.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Iterator, Optional

import ray_tpu_torch

_EMA = 0.3  # smoothing for fetch/drain latency estimates
_CLOSED = object()  # _fetch sentinel: consumer closed mid-resolve


class BlockPrefetcher:
    """Iterate blocks resolved ahead of the consumer.

    ``ref_iter``: iterator/generator of ObjectRefs (it may itself do
    work per ref, e.g. a split coordinator ``next_block`` RPC — that
    cost lands on the prefetch thread, off the consumer's step).
    ``max_ahead``: hard cap on buffered-but-unconsumed blocks; the
    lag-adaptive target never exceeds it. ``timeout``: per-``get``
    bound (None = a slow pipeline is a pipeline property, not a
    failure).
    """

    def __init__(self, ref_iter: Iterator, max_ahead: int = 8,
                 timeout: Optional[float] = None, name: str = "ingest"):
        if max_ahead < 1:
            raise ValueError("max_ahead must be >= 1")
        self._refs = iter(ref_iter)
        self._max_ahead = max_ahead
        self._timeout = timeout
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._q: "collections.deque" = collections.deque()
        self._done = False
        self._closed = False
        self._error: Optional[BaseException] = None
        # lag model: fetch EMA (producer latency per block) vs drain EMA
        # (consumer think time per block, stall excluded)
        self._fetch_ema = 0.0
        self._drain_ema = 0.0
        self._target = min(2, max_ahead)
        self._last_yield: Optional[float] = None
        # stats
        self._blocks = 0
        self._bytes = 0
        self._ingest_stall_s = 0.0
        self._producer_wait_s = 0.0
        self._fetch_s = 0.0
        self._max_depth = 0
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name=f"{name}-prefetch"
        )
        self._thread.start()

    # -- producer side -------------------------------------------------

    def _pump(self):
        try:
            for ref in self._refs:
                with self._lock:
                    t0 = time.perf_counter()
                    while not self._closed and len(self._q) >= self._target:
                        self._wake.wait(0.25)  # consumer-lag backpressure
                    self._producer_wait_s += time.perf_counter() - t0
                    if self._closed:
                        return
                t0 = time.perf_counter()
                block = self._fetch(ref)
                if block is _CLOSED:
                    return
                dt = time.perf_counter() - t0
                with self._lock:
                    if self._closed:
                        return
                    self._fetch_s += dt
                    self._fetch_ema = (
                        dt if self._fetch_ema == 0.0
                        else (1 - _EMA) * self._fetch_ema + _EMA * dt
                    )
                    self._q.append(block)
                    self._max_depth = max(self._max_depth, len(self._q))
                    self._retarget()
                    self._wake.notify_all()
        except BaseException as e:  # surfaced to the consumer
            with self._lock:
                self._error = e
        finally:
            with self._lock:
                self._done = True
                self._wake.notify_all()

    def _fetch(self, ref):
        """Resolve ``ref`` in bounded slices so ``close()`` can unwind a
        pump parked on a slow/wedged producer (an unbounded ``get``
        would pin the thread, the source iterator and every buffered
        ref for process lifetime — the exact leak close() guards
        against). ``self._timeout`` still bounds the TOTAL wait."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        t0 = time.perf_counter()
        while True:
            with self._lock:
                if self._closed:
                    return _CLOSED
            left = None
            if self._timeout is not None:
                left = self._timeout - (time.perf_counter() - t0)
            try:
                return ray_tpu_torch.get(
                    ref, timeout=1.0 if left is None else min(1.0, left)
                )
            except GetTimeoutError:
                if left is not None and left <= 1.0:
                    raise

    def _retarget(self):
        """Lag-derived depth (called under the lock): buffer just enough
        blocks to cover one fetch at the consumer's drain rate, +1 for
        jitter. Unknown drain (consumer not yet observed) keeps the
        conservative startup depth."""
        if self._drain_ema <= 0.0 or self._fetch_ema <= 0.0:
            return
        want = 1 + int(self._fetch_ema / max(self._drain_ema, 1e-6))
        self._target = min(self._max_ahead, max(1, want))

    # -- consumer side -------------------------------------------------

    def __iter__(self) -> "BlockPrefetcher":
        return self

    def __next__(self) -> Any:
        with self._lock:
            now = time.perf_counter()
            if self._last_yield is not None:
                think = now - self._last_yield
                self._drain_ema = (
                    think if self._drain_ema == 0.0
                    else (1 - _EMA) * self._drain_ema + _EMA * think
                )
                self._retarget()
            stall_from = None
            while not self._q:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                if self._done:
                    raise StopIteration
                if stall_from is None:
                    stall_from = time.perf_counter()
                self._wake.wait(0.25)
            if stall_from is not None:
                self._ingest_stall_s += time.perf_counter() - stall_from
            block = self._q.popleft()
            self._blocks += 1
            self._bytes += _block_bytes(block)
            self._last_yield = time.perf_counter()
            self._wake.notify_all()
            return block

    def close(self):
        """Unwind the producer thread (abandoned-consumer guard: a train
        loop breaking out early must not leave a pump blocked on
        backpressure pinning blocks + the source iterator forever).
        Interrupts backpressure parks immediately and in-progress
        fetches within one bounded-get slice (~1s); a pump inside
        ``ref_iter`` itself (e.g. the streaming executor waiting on its
        next task) unwinds when that source next yields — bounded by
        one task duration, the same wait any direct consumer of the
        source would be pinned by."""
        with self._lock:
            self._closed = True
            self._q.clear()
            self._wake.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "blocks": self._blocks,
                "bytes": self._bytes,
                # consumer-visible producer slowness (ingest not keeping
                # up with the step): the "never a hang" observable
                "ingest_stall_s": round(self._ingest_stall_s, 4),
                # producer throttled by consumer lag (backpressure held)
                "producer_wait_s": round(self._producer_wait_s, 4),
                "fetch_s": round(self._fetch_s, 4),
                "target_depth": self._target,
                "max_depth": self._max_depth,
                "max_ahead": self._max_ahead,
            }


def _block_bytes(block) -> int:
    try:
        from ray_tpu_torch.data.block import BlockAccessor

        return BlockAccessor.for_block(block).size_bytes()
    except Exception:
        return 0
