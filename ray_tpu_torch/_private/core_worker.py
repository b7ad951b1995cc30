"""CoreWorker: embedded in every driver and worker process.

Parity: reference ``src/ray/core_worker/`` — task submission
(CoreWorker::SubmitTask core_worker.cc:1862) with lease multiplexing
(direct_task_transport.h:75), Put/Get (:1126/:1338), task execution
(ExecuteTask :2523, HandlePushTask :3028), retries (task_manager.h:173),
in-process memory store (memory_store.h:43) vs shared-memory store provider,
actor task queues (direct_actor_task_submitter.h:67).

Redesigns (TPU build): asyncio on one IO thread instead of asio+grpc;
owners resolve small args inline at submit; the GCS keeps the object
location directory; executing workers run user code on the process main
thread (JAX-friendly — device runtime stays on one thread).
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import logging
import os
import queue as queue_mod
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef, install_ref_hooks
from ray_tpu_torch._private.object_store import SharedMemoryStore, StoreFullError
from ray_tpu_torch._private.protocol import Address, TaskSpec

logger = logging.getLogger(__name__)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"


def _conduit_available() -> bool:
    try:
        from ray_tpu_torch._private import conduit

        return conduit.available()
    except Exception:
        return False


def _spec_from_slim(wire: List) -> TaskSpec:
    """Decode the slim actor-push wire form (see _push_actor_stream for
    the positional order; tests/test_basic.py pins the roundtrip)."""
    (task_id, actor_id, method, args, num_returns, seq_no, owner,
     retries, trace_ctx) = wire
    return TaskSpec(
        task_id=bytes(task_id),
        function_id=b"",
        name=method,
        args=args,
        num_returns=num_returns,
        resources={},
        max_retries=retries,
        owner=owner,
        actor_id=bytes(actor_id),
        method_name=method,
        seq_no=seq_no,
        trace_ctx=trace_ctx,
    )


def _spec_from_slim_plain(wire: List) -> TaskSpec:
    """Decode the slim PLAIN-task streamed-push wire form (the lease
    data plane, ``push_task_p`` — see _push_loop for the positional
    order). Only the fields the executor reads ride the wire; retry
    bookkeeping stays caller-side."""
    (task_id, function_id, job_id, name, args, num_returns, owner,
     trace_ctx, runtime_env) = wire
    return TaskSpec(
        task_id=bytes(task_id),
        function_id=bytes(function_id),
        job_id=bytes(job_id),
        name=name,
        args=args,
        num_returns=num_returns,
        resources={},
        owner=owner,
        trace_ctx=trace_ctx,
        runtime_env=runtime_env,
    )


class _StorePin:
    """Owns one outstanding store refcount for a sealed object; released when
    the last deserialized view dies (see serialization._PinnedSlice)."""

    __slots__ = ("_store", "_oid", "_released")

    def __init__(self, store, oid):
        self._store = store
        self._oid = oid
        self._released = False

    def release_now(self):
        if not self._released:
            self._released = True
            try:
                self._store.release(self._oid)
            except Exception:
                pass

    def __del__(self):
        self.release_now()


class _ActorWindow:
    """Thread-safe pipeline-window credits for one actor (r11 —
    replaces the asyncio.Semaphore): the conduit reaper thread releases
    a slot with NO loop hop when nothing is parked (the sync-RTT
    shape), and the caller-thread direct-submit path claims one without
    entering the loop. Parked acquirers (the pump at full depth) are
    loop futures woken via call_soon_threadsafe — the throughput path
    pays the hop only when the window is actually contended."""

    __slots__ = ("_credits", "_lock", "_waiters", "_loop", "_cap")

    def __init__(self, credits: int, loop):
        self._credits = credits
        self._cap = credits
        self._lock = threading.Lock()
        self._waiters: collections.deque = collections.deque()
        self._loop = loop

    def outstanding(self) -> int:
        """Claimed-but-unreleased credits (leak ledger input: zero when
        no calls are in flight)."""
        with self._lock:
            return self._cap - self._credits

    def try_acquire(self) -> bool:
        """Non-blocking claim; any thread."""
        with self._lock:
            if self._credits > 0:
                self._credits -= 1
                return True
            return False

    def available(self) -> bool:
        return self._credits > 0

    async def acquire(self):
        """Loop-side claim; parks until a release hands over a slot."""
        fut = None
        with self._lock:
            if self._credits > 0:
                self._credits -= 1
                return
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
        await fut

    def release(self):
        """Return a slot; any thread. A parked acquirer gets the slot
        handed over directly (credit never goes re-claimable in
        between, so FIFO order holds for the pump)."""
        wake = None
        with self._lock:
            while self._waiters:
                w = self._waiters.popleft()
                if not w.done():
                    wake = w
                    break
            if wake is None:
                self._credits += 1
        if wake is not None:
            def _wake(w=wake):
                if w.done():
                    self.release()  # waiter vanished: slot back to pool
                else:
                    w.set_result(None)

            self._loop.call_soon_threadsafe(_wake)


class _PendingObject:
    """One pending-or-resolved in-process object.

    SLIM ON PURPOSE: a 1M-queued-task envelope holds one of these per
    outstanding return, so there is no per-entry Event/Condition —
    ``ready`` is a plain flag (``resolve`` writes kind/value/locations
    BEFORE it, and the GIL orders those stores for readers that check
    ``ready`` first) and blocking waiters register listener callbacks
    under one class-wide lock instead of parking on per-entry
    primitives."""

    __slots__ = ("ready", "kind", "value", "locations", "_listeners")

    _lock = threading.Lock()  # listener registration vs resolve, all entries

    def __init__(self):
        self.ready = False
        # "value" | "packed" (lazily-decoded wire bytes) | "plasma"
        # | "error"
        self.kind = None
        self.value = None
        self.locations = ()
        self._listeners = None

    def resolve(self, kind, value=None, locations=()):
        self.kind = kind
        self.value = value
        self.locations = list(locations)
        with self._lock:
            self.ready = True
            cbs, self._listeners = self._listeners, None
        for cb in cbs or ():
            try:
                cb()
            except Exception:
                pass

    def add_listener(self, cb):
        """cb fires (from the resolving thread) when the entry resolves; fires
        immediately if already resolved. Used for event-driven get/wait."""
        with self._lock:
            if not self.ready:
                if self._listeners is None:
                    self._listeners = []
                self._listeners.append(cb)
                return
        cb()


class MemoryStore:
    """In-process store for small values + futures of pending returns."""

    def __init__(self):
        self._table: Dict[ObjectID, _PendingObject] = {}
        self._lock = threading.Lock()

    def entry(self, oid: ObjectID, create=True) -> Optional[_PendingObject]:
        with self._lock:
            e = self._table.get(oid)
            if e is None and create:
                e = self._table[oid] = _PendingObject()
            return e

    def put_value(self, oid: ObjectID, value):
        self.entry(oid).resolve("value", value)

    def put_packed(self, oid: ObjectID, packed):
        """Resolve with the UNDECODED wire bytes of an inlined task
        return: consumers deserialize on THEIR thread at first get
        (_materialize_entry) — the IO loop never pays the unpack."""
        self.entry(oid).resolve("packed", bytes(packed))

    def put_error(self, oid: ObjectID, error: BaseException):
        self.entry(oid).resolve("error", error)

    def put_plasma(self, oid: ObjectID, locations=()):
        self.entry(oid).resolve("plasma", locations=locations)

    def get(self, oid: ObjectID) -> Optional[_PendingObject]:
        with self._lock:
            return self._table.get(oid)

    def pop(self, oid: ObjectID):
        with self._lock:
            self._table.pop(oid, None)

    def __len__(self):
        return len(self._table)


class _GeneratorStream:
    """Caller-side state of ONE streaming generator task (parity: reference
    StreamingObjectRefGenerator bookkeeping in task_manager.cc).

    The executing worker reports yields one at a time; the consumer thread
    pulls refs out in order. ``reported``/``consumed`` drive backpressure:
    the report RPC's reply is DELAYED while unconsumed >= the configured
    limit, which blocks the executor's generator loop — flow control with
    no polling. Re-execution after a worker death re-reports from index 0;
    ``on_item`` only advances for the contiguous next index, so duplicates
    refresh object bytes without disturbing consumer progress."""

    def __init__(self, worker, spec):
        self._worker = worker
        self.spec = spec
        self.task_id = spec.task_id
        self.reported = 0  # contiguous items stored
        self.total: Optional[int] = None  # yield count once finished
        self.error: Optional[BaseException] = None
        self.consumed = 0
        self.cancelled = False  # consumer abandoned the stream
        self._cond = threading.Condition()
        self._bp_waiters: List = []  # asyncio futures (on worker.io.loop)

    def on_item(self, index: int):
        with self._cond:
            if index == self.reported:
                self.reported += 1
                self._cond.notify_all()

    def finalize(self, total: Optional[int] = None,
                 error: Optional[BaseException] = None):
        with self._cond:
            if total is not None and self.total is None:
                self.total = total
            if error is not None and self.error is None:
                self.error = error
            self._cond.notify_all()
        self._wake_bp()

    def next_ref(self, timeout: Optional[float] = None):
        """Next yield's ObjectRef (blocking); None = end of stream."""
        from ray_tpu_torch._private.protocol import yield_object_id

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self.consumed < self.reported:
                    i = self.consumed
                    self.consumed += 1
                    ref = ObjectRef(
                        yield_object_id(TaskID(self.task_id), i),
                        self._worker.address.to_wire(),
                    )
                    break
                if self.error is not None:
                    self._worker._gen_streams.pop(self.task_id, None)
                    raise self.error
                if self.total is not None and self.consumed >= self.total:
                    # fully drained: drop the caller-side stream record
                    # (late lineage re-reports are handled stream-less)
                    self._worker._gen_streams.pop(self.task_id, None)
                    return None
                if self.cancelled:
                    return None
                remaining = 0.2 if deadline is None else min(
                    0.2, deadline - time.monotonic()
                )
                if remaining <= 0:
                    raise exc.GetTimeoutError(
                        "no generator item reported within timeout"
                    )
                self._cond.wait(timeout=remaining)
        self._wake_bp()
        return ref

    def cancel(self):
        """Consumer abandons the stream: wake a parked backpressure ack so
        the next report is NACKed and the executor's generator loop stops.
        The stream record stays in _gen_streams until the task's final
        reply arrives (which removes it) so the NACK is deliverable."""
        with self._cond:
            if self.cancelled or (self.total is not None):
                return
            self.cancelled = True
            self._cond.notify_all()
        self._wake_bp()

    def _wake_bp(self):
        loop = self._worker.io.loop

        def wake():
            waiters, self._bp_waiters = self._bp_waiters, []
            for f in waiters:
                if not f.done():
                    f.set_result(None)

        try:
            loop.call_soon_threadsafe(wake)
        except RuntimeError:
            pass  # loop torn down at shutdown

    async def backpressure_wait(self, limit: int):
        """Await (on the IO loop) until the consumer drains below limit."""
        while (
            self.reported - self.consumed >= limit
            and self.error is None and self.total is None
            and not self.cancelled
        ):
            fut = asyncio.get_running_loop().create_future()
            self._bp_waiters.append(fut)
            await fut

    def __repr__(self):
        return (f"stream(reported={self.reported}, consumed={self.consumed},"
                f" total={self.total})")


class _LeaseState:
    def __init__(self):
        self.queue: collections.deque = collections.deque()
        self.active = 0  # granted leases currently looping
        self.requests_in_flight = 0
        self.strategy = None  # wire-form scheduling strategy for this key
        # push loops lingering on a warm lease (lease_keepalive_ms):
        # new submissions wake these before requesting fresh leases
        self.idle_wakes: set = set()


class CoreWorker:
    def __init__(
        self,
        mode: str,
        worker_id: bytes,
        node_id: bytes,
        raylet_addr: str,
        gcs_addr: str,
        store_path: str,
        session_dir: str,
        job_id: bytes,
    ):
        self.mode = mode
        self.worker_id = worker_id
        self.node_id = node_id
        self.job_id = job_id
        self.session_dir = session_dir
        self.io = rpc.EventLoopThread.get()
        self.store = SharedMemoryStore.attach(store_path)
        self.memory_store = MemoryStore()

        # Serve where our raylet serves: unix for same-host clusters, TCP when
        # the node is network-addressable (workers are peers in cross-host
        # actor/task pushes — parity: reference core worker gRPC server).
        if raylet_addr.startswith("tcp:"):
            host = rpc.parse_addr(raylet_addr)[1].rsplit(":", 1)[0]
            serve_addr = f"tcp:{host}:0"
        else:
            sock_dir = os.path.join(session_dir, "sockets")
            os.makedirs(sock_dir, exist_ok=True)
            serve_addr = "unix:" + os.path.join(
                sock_dir, f"w-{worker_id.hex()[:16]}.sock"
            )
        # Workers serve their task endpoint through the NATIVE conduit
        # engine when available (epoll/writev framing in C++, push_task
        # dispatched reaper-thread -> exec queue with replies sent
        # straight from the exec thread — parity: the reference's C++
        # core-worker gRPC server + task receiver). Drivers keep the
        # asyncio server: their inbound traffic is control-plane, and
        # the two transports share one wire format.
        use_conduit = (
            mode == MODE_WORKER
            and GLOBAL_CONFIG.native_wire
            and _conduit_available()
        )
        if use_conduit:
            from ray_tpu_torch._private.conduit_rpc import ConduitRpcServer

            self.server = ConduitRpcServer(
                serve_addr, rpc.handler_table(self),
                name=f"worker-{worker_id.hex()[:8]}",
                fast_dispatch=self._conduit_fast_push,
            )
        else:
            self.server = rpc.Server(
                serve_addr, rpc.handler_table(self),
                name=f"worker-{worker_id.hex()[:8]}",
            )
        self.io.run(self.server.start_async())
        self.my_addr = self.server.addr
        self.address = Address(worker_id, self.my_addr, node_id)
        # cached wire form: built per submission otherwise (hot path)
        self._addr_wire = self.address.to_wire()

        self.gcs_addr = gcs_addr
        self.gcs = rpc.Client.connect(
            gcs_addr, handler=rpc.handler_table(self), name="->gcs"
        )
        self.raylet = rpc.Client.connect(
            raylet_addr,
            handler=rpc.handler_table(self),
            name="->raylet",
        )
        # function/actor-class tables
        self._exported: set = set()
        import weakref

        self._export_memo = weakref.WeakKeyDictionary()
        self._fn_cache: Dict[bytes, Any] = {}

        # ownership / reference counting
        self._refcounts: Dict[ObjectID, int] = collections.defaultdict(int)
        self._owned: set = set()
        self._ref_lock = threading.Lock()
        # (oid, owner) of each deleted ObjectRef, appended by its
        # finalizer and applied on the IO loop (_drain_ref_deletions):
        # the finalizer may run from the cyclic GC on a thread that
        # holds _ref_lock, so it never takes it.
        self._ref_deletions: collections.deque = collections.deque()
        self._ref_drain_scheduled = False
        # -- distributed borrowing (parity: reference_count.h:61) --
        # owner side: oid -> worker_ids borrowing it; frees deferred while set
        self._borrowers: Dict[ObjectID, set] = {}
        self._borrower_conns: Dict[Any, set] = {}  # conn -> {(oid, wid)}
        self._deferred_free: set = set()
        # borrower side: oids whose owner we've registered with
        self._borrowing: set = set()
        # containment: outer oid -> ObjectRefs its serialized value contains
        self._contained: Dict[ObjectID, List] = {}
        # sender-side handoff pins: (expiry, refs) — keeps refs alive while a
        # reply carrying them is in flight and the receiver registers borrows
        self._handoff_pins: collections.deque = collections.deque()

        # task manager (owner side)
        self._pending_tasks: Dict[bytes, Dict] = {}
        # streaming generator tasks this worker CALLED: task_id -> stream
        # (kept after completion so lineage re-execution can re-report)
        self._gen_streams: Dict[bytes, "_GeneratorStream"] = {}
        self._cancelled: set = set()  # task_ids cancelled before dispatch
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._lineage_pinned: Dict[bytes, List] = {}  # task_id -> arg refs
        self._pull_failures: Dict[ObjectID, int] = collections.defaultdict(int)
        self._recovering: set = set()

        # lease/submit machinery (on IO loop)
        self._lease_states: Dict[Tuple, _LeaseState] = {}
        self._worker_conns: Dict[str, rpc.Connection] = {}
        self._conn_pending: Dict[str, asyncio.Future] = {}  # single-flight

        # actor client state
        self._actor_addr_cache: Dict[bytes, Optional[List]] = {}
        self._actor_state_cache: Dict[bytes, str] = {}
        self._actor_seq: Dict[bytes, int] = collections.defaultdict(int)
        self._actor_pinned: Dict[bytes, List] = {}
        self._actor_conc_cache: Dict[bytes, int] = {}
        self._actor_queues: Dict[bytes, collections.deque] = (
            collections.defaultdict(collections.deque)
        )
        self._actor_pumping: set = set()
        # per-actor pipelining window: bounds in-flight pushed calls.
        # _ActorWindow (thread-safe credits), NOT asyncio.Semaphore:
        # the reaper-thread completion path releases a slot without a
        # loop hop, and the direct-submit path claims one from the
        # caller thread.
        self._actor_windows: Dict[bytes, _ActorWindow] = {}
        # warm streamed conn per ordered actor (direct-submit path —
        # the caller thread cannot await _conn_to's cache)
        self._actor_stream_conns: Dict[bytes, Any] = {}
        # streaming push bookkeeping: conn -> {"addr", "specs": {tid: spec}}
        self._inflight_by_conn: Dict[Any, Dict] = {}
        # streamed LEASE pushes: task_id -> completion cb(ok) waking the
        # owning _push_loop (loop thread only; see _on_task_done)
        self._stream_done_cb: Dict[bytes, Any] = {}
        # executor side: conduit conns with batched task_done buffers
        self._done_conns: set = set()
        # cross-thread submit batching (one loop wakeup per burst)
        self._spawn_lock = threading.Lock()
        self._spawn_batch: List = []
        self._submit_specs: List = []  # plain-task specs (batch drain)
        self._spawn_scheduled = False

        # executor state (worker mode)
        # SimpleQueue: C-implemented put/get (no Python lock/condvar per
        # op) — the exec handoff runs at >10k items/s on the actor plane
        self._exec_queue: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._actor_instance = None
        self._actor_id: Optional[bytes] = None
        self._actor_concurrency = 1
        self._actor_is_async = False  # class defines async-def methods
        self._actor_threads = None  # ThreadPoolExecutor when concurrency > 1
        self._actor_aio_loop = None  # asyncio loop for async-def methods
        self._actor_aio_sem = None
        self._current_task_name = ""
        self._shutdown = threading.Event()
        # task-return inlining counters (executor side: returns encoded
        # into completion frames; owner side: ObjectRefs materialized
        # from them) — surfaced via rpc_task_stats into node_stats and
        # the perf bench's micro detail
        self.task_inline_hits = 0
        self.task_inline_bytes = 0
        # task-event buffer (batched to the GCS task manager)
        self._task_events: List[Dict] = []
        self._task_event_lock = threading.Lock()
        self._task_events_flushed = time.monotonic()
        self._task_events_on = True  # refined after the config handshake

        install_ref_hooks(self._on_ref_created, self._on_ref_deleted)

        # Register LAST: the raylet may push tasks the moment it sees us.
        reply = self.raylet.call(
            "register_worker",
            [worker_id, self.my_addr, mode == MODE_DRIVER],
        )
        GLOBAL_CONFIG.load(reply["config"])
        if mode == MODE_WORKER:
            # Die with the raylet: a worker without its node daemon is orphaned
            # (parity: reference workers exit on raylet socket disconnect).
            def _raylet_gone(conn):
                os._exit(1)

            self.raylet.conn.on_close = _raylet_gone
        # pubsub channels this worker holds with the GCS: replayed whole on
        # reconnect (a restarted GCS loses its subscriber registry)
        self._gcs_channels: set = set()

        def _resub(client):
            # direct conn call — call() would re-enter the reconnect lock
            if self._gcs_channels:
                client.io.run(client.conn.call_async(
                    "subscribe", sorted(self._gcs_channels), timeout=10
                ))

        self.gcs.on_reconnect = _resub
        if mode == MODE_DRIVER and GLOBAL_CONFIG.log_to_driver:
            # Receive worker stdout/stderr lines (log monitor pipeline).
            try:
                self.gcs_subscribe(["logs"])
            except Exception:
                pass
        # cached switch read twice per submission: a plain instance bool
        # beats the config registry's __getattr__ on the hot path, and
        # with events off (no GCS task-event consumer) _emit_task_event
        # is one attribute load + branch — effectively free
        self._task_events_on = bool(GLOBAL_CONFIG.task_events_enabled)
        if self._task_events_on:
            async def _event_flusher():
                while not self._shutdown.is_set():
                    await asyncio.sleep(1.0)
                    self._flush_task_events()

            self.io.submit(_event_flusher())

    # ================= reference counting =================
    def _on_ref_created(self, ref: ObjectRef):
        with self._ref_lock:
            self._refcounts[ref.id] += 1
            first = self._refcounts[ref.id] == 1
        if first and not self._shutdown.is_set():
            owner = ref.owner_address
            if (
                owner
                and bytes(owner[0]) != self.worker_id
                and ref.id not in self._owned
                and ref.id not in self._borrowing
            ):
                # First sight of someone else's ref: we are now a borrower.
                # Register with the owner so it defers the free while we
                # hold it (parity: reference borrowing protocol).
                self._borrowing.add(ref.id)
                self.io.submit(self._send_borrow(ref.id, owner, add=True))

    def _on_ref_deleted(self, ref: ObjectRef):
        # ObjectRef.__del__, possibly run by the cyclic GC inside a
        # section that holds _ref_lock or another lock the release path
        # takes (the memory store's): it takes no lock. The decrement is
        # queued and applied on the IO loop, outside every such section.
        self._ref_deletions.append((ref.id, ref.owner_address))
        if not self._ref_drain_scheduled:
            self._ref_drain_scheduled = True
            self.io.call_soon(self._drain_ref_deletions)

    def _drain_ref_deletions(self):
        """IO loop: apply the queued decrements, then release each object
        whose last local ref died (free it if owned, else end the
        borrow)."""
        self._ref_drain_scheduled = False
        gone = []
        with self._ref_lock:
            while self._ref_deletions:
                oid, owner = self._ref_deletions.popleft()
                n = self._refcounts.get(oid, 0) - 1
                if n <= 0:
                    self._refcounts.pop(oid, None)
                    gone.append((oid, owner, oid in self._owned))
                else:
                    self._refcounts[oid] = n
        if self._shutdown.is_set():
            return
        for oid, owner, owned in gone:
            if owned:
                if self._borrowers.get(oid):
                    self._deferred_free.add(oid)  # freed when borrowers drain
                else:
                    self._free_object(oid)
            elif oid in self._borrowing:
                self._borrowing.discard(oid)
                self.io.submit(self._send_borrow(oid, owner, add=False))

    async def _send_borrow(self, oid: ObjectID, owner, add: bool):
        try:
            conn = await self._conn_to(owner[1])
            await conn.call_async(
                "add_borrower" if add else "remove_borrower",
                [oid.binary(), self.worker_id],
                timeout=30,
            )
        except Exception as e:
            logger.debug("borrow %s notify failed for %s: %s",
                         "add" if add else "remove", oid.hex()[:12], e)

    def gcs_subscribe(self, channels):
        """Subscribe to GCS pubsub channels, remembered so the client's
        on_reconnect hook can replay the whole subscription set into a
        restarted GCS (whose subscriber registry died with it).
        ``dedup=False``: subscribe is connection-affine — a retry landing
        on a fresh conn must RE-RUN the handler (registering that conn),
        not be answered from the request-id reply cache."""
        snap = self.gcs.call("subscribe", list(channels), dedup=False)
        self._gcs_channels.update(channels)
        return snap

    async def rpc_publish(self, conn, data):
        """GCS pubsub push. Drivers print forwarded worker log lines
        (parity: ray's log monitor -> driver stream)."""
        channel, payload = data
        if channel == "logs" and self.mode == MODE_DRIVER:
            import sys

            for entry in payload:
                tag = f"({entry['worker'][:8]}, {entry['node'][:8]})"
                for line in entry["lines"]:
                    print(f"{tag} {line}", file=sys.stderr)
        return True

    async def rpc_add_borrower(self, conn, data):
        oid_bytes, borrower_id = data
        oid = ObjectID(bytes(oid_bytes))
        if oid not in self._owned:
            return False  # already freed; the borrower gets no protection
        self._borrowers.setdefault(oid, set()).add(bytes(borrower_id))
        # Borrows die with the borrower's connection: a killed worker can't
        # send remove_borrower, and a leaked borrow would pin the object (and
        # its store bytes) forever.
        if conn not in self._borrower_conns:
            self._borrower_conns[conn] = set()
            conn.add_close_callback(self._on_borrower_conn_close)
        self._borrower_conns[conn].add((oid, bytes(borrower_id)))
        return True

    def _drop_borrow(self, oid: ObjectID, borrower_id: bytes):
        s = self._borrowers.get(oid)
        if s is not None:
            s.discard(borrower_id)
            if not s:
                self._borrowers.pop(oid, None)
                if oid in self._deferred_free:
                    self._deferred_free.discard(oid)
                    self._free_object(oid)

    async def rpc_remove_borrower(self, conn, data):
        oid_bytes, borrower_id = data
        self._drop_borrow(ObjectID(bytes(oid_bytes)), bytes(borrower_id))
        entries = self._borrower_conns.get(conn)
        if entries is not None:
            entries.discard((ObjectID(bytes(oid_bytes)), bytes(borrower_id)))
        return True

    def _on_borrower_conn_close(self, conn):
        for oid, borrower_id in self._borrower_conns.pop(conn, set()):
            self._drop_borrow(oid, borrower_id)

    def _free_object(self, oid: ObjectID):
        # Inline memory-store values (small task returns) never had a
        # plasma copy or a GCS location entry — freeing them is pure local
        # bookkeeping. The cluster-wide free RPC below would otherwise run
        # once per actor call on the hot path.
        e = self.memory_store.get(oid)
        self.memory_store.pop(oid)
        self._owned.discard(oid)
        self._lineage.pop(oid, None)
        self._deferred_free.discard(oid)
        self._contained.pop(oid, None)  # drop containment pins (inner refs)
        # kind is re-read AFTER the pop: a concurrent
        # _resolve_dependencies promotion flips it to "plasma" only
        # once the store copy exists, so an inline verdict here plus
        # the promotion's own freed-entry check (see
        # _resolve_dependencies) covers every interleaving
        if e is not None and e.ready and e.kind in ("value", "packed"):
            # value/packed entries were never written to the local store,
            # so the contains/delete probes and the cluster-wide free RPC
            # below would be pure per-task overhead on the hot path
            return
        self._free_store_copy(oid)

    def _free_store_copy(self, oid: ObjectID):
        """Delete the local store copy and fan out the cluster-wide
        free (one RPC: the GCS forwards to every node holding a copy —
        in-store or spilled — and drops the location entry). Shared by
        _free_object and the promotion-orphan path; idempotent."""
        try:
            if self.store.contains(oid):
                self.store.delete(oid)
        except Exception:
            pass
        try:
            self.io.submit(
                self.gcs.conn.call_async("free_object", oid.binary(),
                                         timeout=10)
            )
        except Exception:
            pass

    def _pin_handoff(self, refs: List, ttl: float = 60.0):
        """Keep refs alive across a reply's flight so the receiver can
        register its borrow with the owner before any free can land."""
        if refs:
            self._handoff_pins.append((time.monotonic() + ttl, refs))

    def _prune_handoff_pins(self):
        now = time.monotonic()
        while self._handoff_pins and self._handoff_pins[0][0] < now:
            self._handoff_pins.popleft()

    # ================= serialization helpers =================
    def _create_with_spill(self, oid: ObjectID, total: int):
        """Allocate in the store; on FULL, escalate to the raylet's spill
        path (which moves sealed LRU objects to disk) and retry — the
        reference create-request-queue + LocalObjectManager interplay
        (create_request_queue.h / local_object_manager.h:41)."""
        deadline = time.monotonic() + 30.0
        zero_streak = 0
        while True:
            try:
                return self.store.create_buffer(oid, total)
            except StoreFullError as full:
                if not GLOBAL_CONFIG.object_spilling_enabled:
                    raise exc.OutOfMemoryError(
                        f"object store full putting {total} bytes for "
                        f"{oid.hex()} (spilling disabled)"
                    ) from full
                try:
                    freed = self.raylet.call("spill_now", total, timeout=30)
                except Exception:
                    freed = 0
                # freed == 0 does NOT mean no space appeared: a concurrent
                # spiller (the memory monitor, another client) may have
                # taken the candidates — always retry the create, and only
                # give up after several barren rounds.
                zero_streak = 0 if freed else zero_streak + 1
                if zero_streak >= 3 or time.monotonic() > deadline:
                    raise exc.OutOfMemoryError(
                        f"object store full putting {total} bytes for "
                        f"{oid.hex()}; spilling freed nothing (all objects "
                        f"pinned or in flight)"
                    ) from full
                if not freed:
                    time.sleep(0.05)  # let the concurrent spiller finish

    def _write_to_store(self, oid: ObjectID, value) -> None:
        """Serialize + seal into the local shared-memory store (no GCS I/O).
        Compute-thread variant — never call from the IO loop (the spill
        escalation uses the sync RPC facade)."""
        meta, views, total = serialization.packed_size(value)
        buf = self._create_with_spill(oid, total)
        try:
            serialization.pack_into(meta, views, buf)
        except BaseException:
            self.store.abort(oid)
            raise
        finally:
            del buf
        self.store.seal(oid)
        self.store.release(oid)

    async def _write_to_store_async(self, oid: ObjectID, value) -> None:
        """IO-loop twin of _write_to_store: spill escalation via await."""
        meta, views, total = serialization.packed_size(value)
        zero_streak = 0
        deadline = time.monotonic() + 30.0
        while True:
            try:
                buf = self.store.create_buffer(oid, total)
                break
            except StoreFullError as full:
                if not GLOBAL_CONFIG.object_spilling_enabled:
                    raise exc.OutOfMemoryError(
                        f"object store full putting {total} bytes for "
                        f"{oid.hex()} (spilling disabled)"
                    ) from full
                try:
                    freed = await self.raylet.conn.call_async(
                        "spill_now", total, timeout=30
                    )
                except Exception:
                    freed = 0
                zero_streak = 0 if freed else zero_streak + 1
                if zero_streak >= 3 or time.monotonic() > deadline:
                    raise exc.OutOfMemoryError(
                        f"object store full putting {total} bytes for "
                        f"{oid.hex()}; spilling freed nothing"
                    ) from full
                if not freed:
                    await asyncio.sleep(0.05)
        try:
            serialization.pack_into(meta, views, buf)
        except BaseException:
            self.store.abort(oid)
            raise
        finally:
            del buf
        self.store.seal(oid)
        self.store.release(oid)

    def _put_to_plasma(self, oid: ObjectID, value) -> None:
        """Blocking variant for compute threads (NOT the IO loop)."""
        self._write_to_store(oid, value)
        # Location registration rides the IO loop instead of blocking the
        # put (one RPC round trip per put otherwise). A consumer racing
        # ahead of the registration sees a failed pull and re-requests —
        # the get path's time-based re-pull absorbs the window.
        self.io.submit(self._register_location(oid))

    async def _register_location(self, oid: ObjectID):
        wire = [oid.binary(), self.node_id]
        try:
            await self.gcs.conn.call_async("add_object_location", wire,
                                           timeout=30)
        except Exception:
            # conn blip: retry through the RECONNECTING sync client off the
            # loop (silently dropping a registration would strand the
            # object for every remote puller)
            try:
                await asyncio.to_thread(
                    lambda: self.gcs.call("add_object_location", wire,
                                          timeout=30)
                )
            except Exception as e:
                logger.warning("location registration failed for %s: %s",
                               oid.hex()[:12], e)

    def put(self, value, _owner_inline=False) -> ObjectRef:
        """ray.put: store in the local shared-memory store; owner = self."""
        oid = ObjectID.for_put()
        self._put_to_plasma(oid, value)
        contained = serialization.take_contained_refs()
        if contained:
            # The stored bytes reference these objects: keep them alive for
            # the outer object's lifetime (containment edge).
            self._contained[oid] = contained
        self._owned.add(oid)
        self.memory_store.put_plasma(oid, [self.node_id])
        return ObjectRef(oid, self._addr_wire)

    # ================= get =================
    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        """Event-driven get: blocks on entry-resolution callbacks, not a busy
        poll (parity: reference CoreWorker::Get blocks in the memory store /
        plasma with wakeups). A 0.25s backstop re-arms pulls after failures.

        O(n) in the number of refs: each unresolved memory-store entry gets
        an INDEX-CARRYING listener pushing onto a ready queue, so a wakeup
        revisits only the refs that resolved — not the whole remaining set
        (a burst get() of 10k pipelined calls was quadratic before r4).
        Plasma/remote refs (no local entry to listen on) stay in a small
        poll set rescanned per wakeup."""
        deadline = None if timeout is None else time.monotonic() + timeout
        n = len(refs)
        results: List[Any] = [_NOT_READY] * n
        requested_pull: Dict[ObjectID, float] = {}
        wake = threading.Event()
        ready: collections.deque = collections.deque()  # resolved indices
        poll: Dict[int, ObjectRef] = {}  # plasma/remote: rescan on wake
        unresolved = 0

        def check(i: int, ref: ObjectRef):
            """Try one ref; returns True if resolved into results[i]."""
            nonlocal unresolved
            e = self.memory_store.get(ref.id)
            if e is not None and not e.ready:
                # add_listener fires the callback immediately if the entry
                # resolved between the get() above and here
                e.add_listener(lambda i=i: (ready.append(i), wake.set()))
                return False
            val = self._try_get_one(ref, requested_pull, wake, set())
            if val is _NOT_READY:
                poll[i] = ref  # plasma pull in flight
                return False
            results[i] = val
            poll.pop(i, None)
            return True

        for i, ref in enumerate(refs):
            if not check(i, ref):
                unresolved += 1
        while unresolved > 0:
            if not ready and not wake.is_set():
                if deadline is not None and time.monotonic() > deadline:
                    raise exc.GetTimeoutError(
                        f"Get timed out on {unresolved} of {n} objects"
                    )
                budget = 0.25 if deadline is None else min(
                    0.25, max(0.0, deadline - time.monotonic())
                )
                wake.wait(budget)
            wake.clear()
            while ready:
                i = ready.popleft()
                if results[i] is not _NOT_READY:
                    continue
                if check(i, refs[i]):
                    unresolved -= 1
            for i in list(poll):
                if results[i] is not _NOT_READY:
                    continue
                if check(i, refs[i]):
                    unresolved -= 1
        out = []
        for v in results:
            if isinstance(v, _Err):
                raise v.error
            out.append(v)
        return out

    @staticmethod
    def _materialize_entry(e: _PendingObject):
        """Decode a lazily-stored packed return in place (consumer
        thread — the IO loop stores the wire bytes without paying the
        unpack). Racing materializers may both deserialize (harmless: a
        loser's value is dropped) but exactly one commits, and the
        packed bytes are snapshotted under the lock so a racer can never
        unpack an already-decoded value."""
        with _PendingObject._lock:
            if e.kind != "packed":
                return
            packed = e.value
        value = serialization.unpack(packed)
        err = isinstance(value, exc.ErrorObject)
        with _PendingObject._lock:
            if e.kind == "packed":
                e.value = value.error if err else value
                e.kind = "error" if err else "value"

    def _try_get_one(self, ref: ObjectRef, requested_pull, wake=None,
                     listening=None):
        e = self.memory_store.get(ref.id)
        if e is not None and e.ready:
            if e.kind == "packed":
                self._materialize_entry(e)
            if e.kind == "value":
                return e.value
            if e.kind == "error":
                return _Err(e.value)
            # plasma
            return self._read_plasma(ref, requested_pull, wake, listening)
        if e is None:
            # Not a known pending return: plasma-or-remote path.
            return self._read_plasma(ref, requested_pull, wake, listening)
        if wake is not None and ref.id not in listening:
            listening.add(ref.id)
            e.add_listener(wake.set)
        return _NOT_READY

    def _read_plasma(self, ref: ObjectRef, requested_pull, wake=None,
                     listening=None):
        # writable=True: the pre-3.12 pin carrier (ctypes.from_buffer) needs
        # a writable source; unpack() re-wraps every consumer view read-only,
        # so the writable view never escapes this function.
        # raylint: disable=R5 — feeds unpack()'s _pinned_buffer path only
        view = self.store.get(ref.id, timeout=0, writable=True)
        if view is not None:
            # The store ref taken by get() is owned by `pin`: it lives until
            # every zero-copy view deserialized from the buffer dies, so LRU
            # eviction can't reuse the bytes under live numpy arrays
            # (ADVICE r1: use-after-free under memory pressure).
            pin = _StorePin(self.store, ref.id)
            try:
                value = serialization.unpack(view, pin=pin)
            except BaseException:
                pin.release_now()
                raise
            del pin  # dropped with the last view (or right here if none)
            if isinstance(value, exc.ErrorObject):
                return _Err(value.error)
            return value
        failures = self._pull_failures.get(ref.id, 0)
        if failures > 0:
            if self._maybe_recover(ref):
                self._pull_failures.pop(ref.id, None)
            elif failures >= 3:
                self._pull_failures.pop(ref.id, None)
                return _Err(exc.ObjectLostError(
                    object_ref_hex=ref.hex(),
                    reason="all copies lost and no lineage to reconstruct",
                ))
        # Time-based re-request: pulls are idempotent, and one-shot request
        # tracking can stall if a failure is cleared while no pull is in
        # flight (e.g. right as a reconstruction completes).
        self._request_pull(ref, requested_pull, wake)
        return _NOT_READY

    async def _pull_async(self, ref: ObjectRef, wake=None):
        try:
            ok = await self.raylet.conn.call_async(
                "pull_object", ref.binary(), timeout=60
            )
            if ok:
                self._pull_failures.pop(ref.id, None)
                if wake is not None:
                    wake.set()
                return
            # Fall back to asking the owner directly (memory-store values).
            owner = ref.owner_address
            if owner and owner[1] != self.my_addr:
                conn = await self._conn_to(owner[1])
                data = await conn.call_async("get_object", ref.binary(), timeout=30)
                if data is not None:
                    value = serialization.unpack(data)
                    if isinstance(value, exc.ErrorObject):
                        self.memory_store.put_error(ref.id, value.error)
                    else:
                        self.memory_store.put_value(ref.id, value)
                    self._pull_failures.pop(ref.id, None)
                    if wake is not None:
                        wake.set()
                    return
            self._pull_failures[ref.id] += 1
        except Exception as e:
            logger.debug("pull failed for %s: %s", ref.hex()[:12], e)
            self._pull_failures[ref.id] += 1
        finally:
            if wake is not None:
                wake.set()  # wake the getter to re-evaluate (failure counting)

    # ---- lineage reconstruction (parity: reference ObjectRecoveryManager
    # object_recovery_manager.h:41 + TaskManager::ResubmitTask task_manager.h:234;
    # here the owner resubmits the creating task when every copy is lost) ----
    def _maybe_recover(self, ref: ObjectRef) -> bool:
        if not GLOBAL_CONFIG.lineage_pinning_enabled:
            return False
        spec = self._lineage.get(ref.id)
        if spec is None:
            return False
        if spec.task_id in self._recovering:
            return True  # already resubmitted, keep waiting
        self._recovering.add(spec.task_id)
        logger.info("reconstructing %s via task %s", ref.hex()[:12], spec.name)
        self._pending_tasks[spec.task_id] = {
            "spec": spec,
            "retries_left": max(spec.max_retries, 1),
            "pinned": self._lineage_pinned.get(spec.task_id, []),
        }
        self.io.submit(self._submit_async(spec))
        return True

    async def rpc_report_generator_item(self, conn, data: Dict):
        """Executor -> caller: one streaming-generator yield (parity:
        reference ReportGeneratorItemReturns, core_worker.proto). The CALLER
        stores the object under its deterministic id and owns it from here
        (lineage registered, so a lost yield resubmits the task). The reply
        is delayed while the consumer is behind — that delay IS the
        backpressure on the executing generator."""
        task_id = bytes(data["task_id"])
        index = int(data["index"])
        stream = self._gen_streams.get(task_id)
        from ray_tpu_torch._private.protocol import yield_object_id

        oid = yield_object_id(TaskID(task_id), index)
        if data["kind"] == "v":
            value = serialization.unpack(bytes(data["payload"]))
            if isinstance(value, exc.ErrorObject):
                self.memory_store.put_error(oid, value.error)
            else:
                self.memory_store.put_value(oid, value)
        else:
            self.memory_store.put_plasma(oid, [bytes(data["node"])])
        self._owned.add(oid)
        if stream is None:
            # stream record already drained/dropped: this is a lineage
            # re-execution recreating lost yields — store and ack, no
            # consumer bookkeeping needed
            return {"ok": True}
        if GLOBAL_CONFIG.lineage_pinning_enabled:
            self._lineage[oid] = stream.spec
        stream.on_item(index)
        await stream.backpressure_wait(
            GLOBAL_CONFIG.streaming_generator_backpressure_items
        )
        # a cancelled stream NACKs so the executor stops generating
        return {"ok": not stream.cancelled}

    async def rpc_get_object(self, conn, oid_bytes: bytes):
        """Serve an owned object's value to a borrower."""
        oid = ObjectID(oid_bytes)
        e = self.memory_store.get(oid)
        if e is not None and e.ready:
            with _PendingObject._lock:
                kind, value = e.kind, e.value
            if kind == "packed":
                return value  # already the wire form: no decode/re-pack
            if kind == "value":
                return serialization.pack(value)
            if kind == "error":
                return serialization.pack(exc.ErrorObject(value))
        view = self.store.get(oid, timeout=0)
        if view is not None:
            try:
                return bytes(view)
            finally:
                view.release()
                self.store.release(oid)
        return None

    # ================= wait =================
    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        """Event-driven wait (same wakeup scheme as get). Borrowed refs with
        no local entry are actively pulled so a remotely-ready object counts
        as ready (ADVICE r1: wait() used to block on them until timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        requested: Dict[ObjectID, float] = {}
        wake = threading.Event()
        listening: set = set()
        while True:
            wake.clear()
            still = []
            for ref in pending:
                e = self.memory_store.get(ref.id)
                resolved = e is not None and e.ready
                local = self.store.contains(ref.id)
                if resolved and e.kind == "plasma" and not local:
                    # Object exists remotely: that's "ready" per reference
                    # semantics; fetch_local additionally pulls the value.
                    if fetch_local:
                        self._request_pull(ref, requested, wake)
                        done = False  # wait for the local copy
                    else:
                        done = True
                elif e is None and not local:
                    # Unknown here (borrowed ref, no entry): resolve by
                    # pulling — the pull lands it locally (or its owner value
                    # in the memory store), flipping it to ready. Entries that
                    # exist but are unresolved are OUR pending task returns:
                    # pulling those would only rack up pull failures.
                    self._request_pull(ref, requested, wake)
                    done = False
                else:
                    done = resolved or local
                    if not done and e is not None and ref.id not in listening:
                        listening.add(ref.id)
                        e.add_listener(wake.set)
                if done:
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            budget = 0.25 if deadline is None else min(
                0.25, max(0.0, deadline - time.monotonic())
            )
            wake.wait(budget)
        if len(ready) > num_returns:
            # contract parity: at MOST num_returns in the ready list, even
            # when one scan finds more (extras stay waitable)
            pending = ready[num_returns:] + pending
            ready = ready[:num_returns]
        return ready, pending

    def _request_pull(self, ref: ObjectRef, requested: Dict, wake=None):
        now = time.monotonic()
        if now - requested.get(ref.id, 0.0) > 0.2:
            requested[ref.id] = now
            self.io.submit(self._pull_async(ref, wake))

    # ================= function table =================
    def _export(self, prefix: str, obj) -> bytes:
        # Per-object memo: re-pickling the same function for every one of
        # 100k submits would dominate submission cost. WeakKeyDictionary
        # so the memo can't outlive (or pin) the function object.
        try:
            cached = self._export_memo.get(obj)
        except TypeError:
            cached = None  # unhashable/unweakrefable: pickle every time
        if cached is not None:
            return cached
        blob = cloudpickle.dumps(obj)
        fid = hashlib.sha256(blob).digest()[:16]
        key = f"{prefix}:{self.job_id.hex()}:{fid.hex()}"
        if key not in self._exported:
            self.gcs.call("kv_put", [key, blob, False])
            self._exported.add(key)
        try:
            self._export_memo[obj] = fid
        except TypeError:
            pass
        return fid

    def _fetch(self, prefix: str, fid: bytes, job_id: Optional[bytes] = None):
        if fid in self._fn_cache:
            return self._fn_cache[fid]
        job = job_id if job_id else self.job_id
        key = f"{prefix}:{bytes(job).hex()}:{fid.hex()}"
        deadline = time.monotonic() + 30
        while True:
            blob = self.gcs.call("kv_get", key)
            if blob is not None:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"function {key} not found in GCS")
            time.sleep(0.05)
        obj = cloudpickle.loads(blob)
        self._fn_cache[fid] = obj
        return obj

    # ================= task submission (owner) =================
    def _encode_args(self, args_values):
        """Returns (wire_args, pinned_refs). Pinned refs (pass-by-ref args and
        plasma promotions of large values) must outlive the task: the caller
        stores them in the pending-task record so GC can't free the objects
        before the executor reads them."""
        self._prune_handoff_pins()  # drivers prune here; workers in exec loop
        wire, pinned = [], []
        for a in args_values:
            if isinstance(a, ObjectRef):
                wire.append(["r", a.binary(), a.owner_address])
                pinned.append(a)
            else:
                packed = serialization.pack(a)
                # Refs nested inside the value must outlive the task too.
                pinned.extend(serialization.take_contained_refs())
                if len(packed) > GLOBAL_CONFIG.inline_object_max_bytes:
                    ref = self.put(a)
                    wire.append(["r", ref.binary(), ref.owner_address])
                    pinned.append(ref)
                else:
                    wire.append(["v", packed])
        return wire, pinned

    def submit_task(
        self,
        fn,
        args_wire: List,
        *,
        name: str = "",
        num_returns: int = 1,
        resources: Optional[Dict] = None,
        max_retries: Optional[int] = None,
        retry_exceptions: bool = False,
        scheduling_strategy=None,
        pinned=None,
        runtime_env: Optional[Dict] = None,
    ) -> List[ObjectRef]:
        fid = self._export("fn", fn)
        task_id = TaskID.for_task()
        spec = TaskSpec(
            task_id=task_id.binary(),
            function_id=fid,
            job_id=self.job_id,
            name=name,
            args=args_wire,
            num_returns=num_returns,
            resources=resources or {"CPU": 1},
            max_retries=(
                GLOBAL_CONFIG.default_max_retries
                if max_retries is None
                else max_retries
            ),
            retry_exceptions=retry_exceptions,
            owner=self._addr_wire,
            scheduling_strategy=scheduling_strategy,
            runtime_env=self._process_runtime_env(runtime_env),
            trace_ctx=(
                _tracing.ctx_for_submit(task_id.binary())
                if GLOBAL_CONFIG.tracing_enabled else None
            ),
        )
        refs = []
        for oid in spec.return_ids():
            self.memory_store.entry(oid)  # create pending entry
            self._owned.add(oid)
            refs.append(ObjectRef(oid, self._addr_wire))
        self._pending_tasks[spec.task_id] = {
            "spec": spec,
            "retries_left": spec.max_retries,
            "pinned": pinned or [],
        }
        if num_returns == -2:
            # streaming generator: the caller owns every yield; hand back
            # the stream handle instead of plain refs
            from ray_tpu_torch._private.object_ref import (
                StreamingObjectRefGenerator,
            )

            stream = _GeneratorStream(self, spec)
            self._gen_streams[spec.task_id] = stream
            refs = [StreamingObjectRefGenerator(stream, refs[0])]
        self._emit_task_event(spec, "PENDING_NODE_ASSIGNMENT")
        self._io_spawn_submit(spec)
        return refs

    def _io_spawn(self, coro):
        """Schedule a coroutine on the IO loop with burst batching: a
        10k-call submission loop pays ONE loop wakeup per drained batch
        instead of one self-pipe write + Future per call
        (run_coroutine_threadsafe). Fire-and-forget — errors surface
        through the task machinery, not the spawner."""
        with self._spawn_lock:
            self._spawn_batch.append(coro)
            if self._spawn_scheduled:
                return
            self._spawn_scheduled = True
        self.io.loop.call_soon_threadsafe(self._drain_spawn)

    def _io_spawn_submit(self, spec: TaskSpec):
        """Queue a PLAIN-task spec for loop-side submission. Batch-aware
        hot path: the drain enqueues ref-free specs STRAIGHT into their
        lease queues as plain function work — no per-task asyncio task,
        no coroutine switch — and kicks each touched lease key once per
        burst. Specs with ObjectRef args still get a coroutine (their
        dependency resolution awaits entry resolution)."""
        with self._spawn_lock:
            self._submit_specs.append(spec)
            if self._spawn_scheduled:
                return
            self._spawn_scheduled = True
        self.io.loop.call_soon_threadsafe(self._drain_spawn)

    @staticmethod
    def _swallow_task_exc(t):
        if not t.cancelled() and t.exception() is not None:
            # submit machinery reports failures through _fail_task; an
            # exception escaping here is a teardown race, not user-facing
            logger.debug("background submit failed: %r", t.exception())

    def _drain_spawn(self):
        with self._spawn_lock:
            batch, self._spawn_batch = self._spawn_batch, []
            specs, self._submit_specs = self._submit_specs, []
            self._spawn_scheduled = False
        loop = asyncio.get_running_loop()
        for coro in batch:
            loop.create_task(coro).add_done_callback(self._swallow_task_exc)
        if specs:
            self._submit_specs_now(specs, loop)

    def _submit_specs_now(self, specs: List[TaskSpec], loop):
        """Loop-side burst submission (see _io_spawn_submit)."""
        touched: Dict[Tuple, _LeaseState] = {}
        for spec in specs:
            if any(a[0] == "r" for a in spec.args):
                loop.create_task(
                    self._submit_async(spec)
                ).add_done_callback(self._swallow_task_exc)
                continue
            info = self._pending_tasks.get(spec.task_id)
            if info is not None:
                info["state"] = "queued"
            key = self._lease_key(spec)
            st = self._lease_states.get(key)
            if st is None:
                st = self._lease_states[key] = _LeaseState()
                st.strategy = spec.scheduling_strategy
            st.queue.append(spec)
            touched[key] = st
        for key, st in touched.items():
            self._maybe_request_lease(key, st)

    # ================= task events (observability) =================
    # Parity: reference TaskEventBuffer (task_event_buffer.h:199) batching
    # per-task state transitions to the GCS task manager (gcs_task_manager
    # .h:61) — powers `ray_tpu_torch status` / list_tasks / timeline().

    def _emit_task_event(self, spec, state: str, error: str = ""):
        # Hot path: append a TUPLE; the wire dicts are built at flush
        # (dict construction + f-strings per submission cost real
        # microseconds at 10k tasks/s). Flush every 512 events or 1s.
        if not self._task_events_on:
            return
        with self._task_event_lock:
            self._task_events.append(
                (spec.task_id, spec.name, spec.method_name, state,
                 time.time(), spec.actor_id, error, spec.trace_ctx)
            )
            flush_due = (
                len(self._task_events) >= 512
                or time.monotonic() - self._task_events_flushed > 1.0
            )
        if flush_due:
            self._flush_task_events()

    def _flush_task_events(self):
        with self._task_event_lock:
            batch, self._task_events = self._task_events, []
            self._task_events_flushed = time.monotonic()
        if not batch:
            return
        events = []
        for (task_id, name, method, state, ts, actor_id, error,
             trace_ctx) in batch:
            ev = {
                "task_id": task_id,
                "name": name if not method else f"{name}.{method}",
                "state": state,
                "ts": ts,
                "node": self.node_id,
                "worker": self.worker_id,
                "actor_id": actor_id,
                "error": error,
            }
            if trace_ctx:
                ev["trace_id"], ev["parent_span_id"], ev["span_id"] = (
                    trace_ctx
                )
            events.append(ev)
        try:
            self.io.submit(
                self.gcs.conn.call_async("add_task_events", events,
                                         timeout=10)
            )
        except Exception:
            pass  # observability is best-effort

    @staticmethod
    def _freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(CoreWorker._freeze(x) for x in v)
        if isinstance(v, dict):  # e.g. label-strategy constraint maps
            return tuple(sorted(
                (k, CoreWorker._freeze(x)) for k, x in v.items()
            ))
        return v

    def _lease_key(self, spec: TaskSpec) -> Tuple:
        # Leases are multiplexed only across tasks with identical resource
        # AND strategy requirements (a SPREAD task must not ride an
        # affinity-placed lease).
        return (
            tuple(sorted((spec.resources or {}).items())),
            self._freeze(spec.scheduling_strategy)
            if spec.scheduling_strategy is not None
            else None,
        )

    async def _submit_async(self, spec: TaskSpec):
        try:
            await self._resolve_dependencies(spec)
        except Exception as e:
            self._fail_task(spec, e)
            return
        info = self._pending_tasks.get(spec.task_id)
        if info is not None:
            info["state"] = "queued"
        key = self._lease_key(spec)
        st = self._lease_states.get(key)
        if st is None:
            st = self._lease_states[key] = _LeaseState()
            st.strategy = spec.scheduling_strategy
        st.queue.append(spec)
        self._maybe_request_lease(key, st)

    async def _wait_entry(self, e: _PendingObject):
        """Await entry resolution on the IO loop without polling."""
        if e.ready:
            return
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def _on_resolve():
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None)
            )

        e.add_listener(_on_resolve)
        await fut

    async def _resolve_dependencies(self, spec: TaskSpec):
        """Inline small owned values; leave plasma refs for the executor."""
        for i, a in enumerate(spec.args):
            if a[0] != "r":
                continue
            oid = ObjectID(bytes(a[1]))
            e = self.memory_store.get(oid)
            if e is None:
                continue  # borrowed / plasma ref: executor will fetch
            await self._wait_entry(e)
            if e.kind == "packed":
                # lazily-stored inlined return used as an arg: the
                # entry already IS the wire form — decode once (cached;
                # reveals a pathological error value) but ship the
                # ORIGINAL bytes, skipping the re-pack a chained
                # small-task pipeline would otherwise pay per hop
                with _PendingObject._lock:
                    packed = e.value if e.kind == "packed" else None
                self._materialize_entry(e)
                if (
                    packed is not None
                    and e.kind == "value"
                    and len(packed) <= GLOBAL_CONFIG.inline_object_max_bytes
                ):
                    spec.args[i] = ["v", packed]
                    continue
                # oversized or error: fall through to the paths below
            if e.kind == "value":
                packed = serialization.pack(e.value)
                if len(packed) <= GLOBAL_CONFIG.inline_object_max_bytes:
                    spec.args[i] = ["v", packed]
                else:
                    # NOTE: runs on the IO loop — must use async RPC variants
                    # throughout (the sync facades would deadlock the loop:
                    # ADVICE r1, and the spill escalation likewise).
                    await self._write_to_store_async(oid, e.value)
                    await self.gcs.conn.call_async(
                        "add_object_location", [oid.binary(), self.node_id]
                    )
                    e.kind = "plasma"
                    if self.memory_store.get(oid) is None:
                        # the last ref was dropped while the promotion
                        # was in flight: _free_object took the inline
                        # fast path (no store copy existed when it ran),
                        # so the just-created store copy + location
                        # entry are ours to clean up (idempotent vs a
                        # racing free)
                        self._free_store_copy(oid)
            elif e.kind == "error":
                raise e.value

    def _maybe_request_lease(self, key: Tuple, st: _LeaseState):
        # Every ACTIVE lease is busy executing its current task, so queued
        # tasks need their own leases: counting active leases as capacity
        # here would serialize the whole queue behind one slow task (e.g.
        # one mid-transfer arg staging) on a cluster with idle workers.
        # Late grants that find the queue empty return immediately. The
        # in-flight request count is CAPPED: a deep queue (100k tasks)
        # must not park one lease request per task at the raylet.
        woken = 0
        while st.idle_wakes and woken < len(st.queue):
            # warm leases first: a lingering push loop resumes instantly,
            # no raylet round trip (lease_keepalive_ms). Wake only as
            # many as there are queued tasks — waking the whole pool for
            # one task would churn the spares back to the raylet.
            st.idle_wakes.pop().set()
            woken += 1
        want = min(len(st.queue), GLOBAL_CONFIG.max_lease_requests_in_flight)
        have = st.requests_in_flight + woken
        for _ in range(min(want - have, 8)):
            st.requests_in_flight += 1
            rpc.spawn(self._lease_loop(key, st))

    async def _lease_loop(self, key: Tuple, st: _LeaseState):
        granted = False
        try:
            res_items, _ = key
            resources = dict(res_items)
            strategy = st.strategy  # original wire form (key is frozen)
            raylet_conn = self.raylet.conn
            grant = None
            for _hop in range(8):  # bounded spillback chain
                try:
                    # No client timeout: the raylet queues indefinitely and
                    # reclaims via conn death — a timed-out-but-later-granted
                    # lease would leak the worker (ADVICE r1).
                    reply = await raylet_conn.call_async(
                        "request_worker_lease",
                        {"resources": resources, "strategy": strategy,
                         "hops": _hop},
                        timeout=None,
                    )
                except Exception:
                    if self._shutdown.is_set() or self.raylet.conn.closed:
                        # teardown (or a dead raylet): fail the queue
                        # instead of resubmitting — the finally's re-kick
                        # would otherwise spin lease loops against a
                        # closed conn forever and wedge shutdown
                        while st.queue:
                            self._fail_task(st.queue.popleft(), exc.
                                            WorkerCrashedError(
                                "cluster shutting down / raylet gone"
                            ))
                    return
                if reply.get("granted"):
                    grant = reply
                    break
                if reply.get("spillback"):
                    raylet_conn = await self._conn_to(reply["spillback"])
                    continue
                if reply.get("infeasible"):
                    while st.queue:
                        spec = st.queue.popleft()
                        self._fail_task(
                            spec,
                            RuntimeError(
                                f"Task {spec.name} is infeasible: no node has "
                                f"resources {resources}"
                            ),
                        )
                    return
            if grant is None:
                return
            granted = True
            st.requests_in_flight -= 1
            st.active += 1
            await self._push_loop(key, st, grant, raylet_conn)
        finally:
            if not granted:
                st.requests_in_flight -= 1
                if st.queue and not self._shutdown.is_set():
                    self._maybe_request_lease(key, st)

    def _plasma_arg_wire(self, spec: TaskSpec) -> List:
        """[[oid_bytes, owner_wire], ...] for the spec's plasma args."""
        out = []
        for a in spec.args:
            if a[0] != "r":
                continue
            oid = ObjectID(bytes(a[1]))
            e = self.memory_store.get(oid)
            if e is not None and e.ready and e.kind != "plasma":
                continue
            out.append([bytes(a[1]), a[2]])
        return out

    async def _push_loop(self, key, st: _LeaseState, grant, raylet_conn):
        """Pushes queued tasks over one lease with a configurable
        in-flight window (``lease_push_pipeline_depth``, default 1).

        Depth 1 preserves the safe default: one task executes per lease
        at a time, because a task blocked in a nested get() must not
        strand tasks committed behind it on a serial worker (queued tasks
        get their own leases via _maybe_request_lease instead). Flat
        data-parallel workloads can raise the depth (the perf gate runs
        at 8) so the push RTT overlaps worker execution — parity:
        reference max_tasks_in_flight_per_worker lease multiplexing.
        Either way the NEXT queued task's plasma args are prefetch-staged
        on the worker's node while the current one runs.

        Round 5: pushes STREAM — one corked ``push_task_p`` notify per
        task out, completions back as (batched) ``task_done`` notifies
        handled inline in the read loop, exactly like the actor data
        plane. The per-push asyncio future + asyncio.wait re-arming of
        the round-4 request/reply form cost ~30us/task of pure driver
        overhead at depth 8."""
        worker_addr = grant["worker"]
        lease_id = grant["lease_id"]
        reusable = True
        depth = max(1, GLOBAL_CONFIG.lease_push_pipeline_depth)
        inflight = 0
        wake = asyncio.Event()

        def on_done(ok: bool):
            nonlocal inflight, reusable
            inflight -= 1
            if not ok:
                reusable = False
            wake.set()

        try:
            try:
                conn = await self._conn_to(worker_addr[1])
            except Exception:
                reusable = False
                return
            reg = self._inflight_by_conn.get(conn)
            if reg is None:
                reg = self._inflight_by_conn[conn] = {
                    "addr": worker_addr, "specs": {},
                }
                conn.sync_notify["task_done"] = self._on_task_done
                conn.sync_notify["task_done_batch"] = self._on_task_done_batch
                # the same worker conn may later carry actor pushes:
                # their singleton completions ride the reaper fast path
                conn.sync_notify_fast["task_done"] = self._on_task_done_reaper
                conn.sync_notify_fast["task_done_batch"] = (
                    self._on_task_done_batch_reaper
                )
                conn.add_close_callback(self._on_actor_conn_close)
            while True:
                pushed = False
                while reusable and st.queue and inflight < depth:
                    spec = st.queue.popleft()
                    if spec.task_id in self._cancelled:
                        self._cancelled.discard(spec.task_id)
                        self._fail_task(spec, exc.TaskCancelledError(
                            f"task {spec.name} was cancelled before execution"
                        ))
                        continue
                    info = self._pending_tasks.get(spec.task_id)
                    if info is not None:
                        info["state"] = "running"
                    if st.queue:
                        # prefetch hint: stage the next task's plasma args
                        # on this node while the current task executes
                        nxt = self._plasma_arg_wire(st.queue[0])
                        if nxt:
                            self.io.submit(conn.call_async(
                                "stage_args_hint", nxt, timeout=None
                            ))
                    reg["specs"][spec.task_id] = spec
                    self._stream_done_cb[spec.task_id] = on_done
                    try:
                        conn.send_notify_corked("push_task_p", [
                            spec.task_id, spec.function_id, spec.job_id,
                            spec.name, spec.args, spec.num_returns,
                            spec.owner, spec.trace_ctx, spec.runtime_env,
                        ])
                    except rpc.SendError:
                        reg["specs"].pop(spec.task_id, None)
                        self._stream_done_cb.pop(spec.task_id, None)
                        st.queue.appendleft(spec)  # re-lease elsewhere
                        reusable = False
                        break
                    inflight += 1
                    pushed = True
                if pushed:
                    conn.flush_cork()
                if inflight == 0 and (not st.queue or not reusable):
                    keepalive = GLOBAL_CONFIG.lease_keepalive_ms
                    if not reusable or keepalive <= 0:
                        break
                    # linger on the warm lease: a burst submitter's next
                    # batch reuses this worker without a lease round trip
                    ev = asyncio.Event()
                    st.idle_wakes.add(ev)
                    try:
                        await asyncio.wait_for(
                            ev.wait(), keepalive / 1000.0
                        )
                    except (asyncio.TimeoutError, TimeoutError):
                        st.idle_wakes.discard(ev)
                        break  # keepalive expired: return the worker
                    st.idle_wakes.discard(ev)
                    # woken: re-enter the loop — if a sibling already
                    # drained the queue, linger again rather than churn
                    # the warm lease back to the raylet
                    continue
                await wake.wait()
                wake.clear()
        finally:
            st.active -= 1
            try:
                await raylet_conn.call_async(
                    "return_worker", [lease_id, reusable], timeout=10
                )
            except Exception:
                pass
            if st.queue:
                self._maybe_request_lease(key, st)

    @staticmethod
    def _reply_is_fast(spec: TaskSpec, reply: Dict) -> bool:
        """The overwhelmingly common reply shape — one return, no
        errors, no contained refs — completable without the
        zip/enumerate machinery (and, for singleton actor completions,
        directly on the conduit reaper thread)."""
        return (
            spec.num_returns == 1
            and reply.get("error") is None
            and not reply.get("system_error")
            and not reply.get("contained")
        )

    def _complete_fast_return(self, spec: TaskSpec, reply: Dict,
                              worker_addr):
        """Resolve a fast-shape reply (``_reply_is_fast``). Thread-safe:
        every touched structure is a GIL-atomic dict/set/deque op or the
        locked memory store, so the reaper-thread singleton fast path
        and the IO loop can both run it (worth ~10us/call at pipelined
        actor rates vs the general path)."""
        kind, payload = reply["returns"][0]
        oid = spec.return_ids()[0]
        if kind == "v":
            # materialize the ObjectRef straight from the completion
            # frame: no store round trip, and no unpack on the IO
            # loop — consumers decode on their own thread
            self.task_inline_hits += 1
            self.task_inline_bytes += len(payload)
            self.memory_store.put_packed(oid, payload)
        else:
            self.memory_store.put_plasma(oid, [worker_addr[2]])
        self._cancelled.discard(spec.task_id)
        info = self._pending_tasks.pop(spec.task_id, None)
        self._recovering.discard(spec.task_id)
        if info and info.get("pinned"):
            self._pin_handoff(info["pinned"])
        if GLOBAL_CONFIG.lineage_pinning_enabled:
            self._lineage[oid] = spec
            self._pull_failures.pop(oid, None)
            if info and info.get("pinned"):
                self._lineage_pinned[spec.task_id] = info["pinned"]

    def _handle_task_reply(self, spec: TaskSpec, reply: Dict, worker_addr):
        if self._reply_is_fast(spec, reply):
            self._complete_fast_return(spec, reply, worker_addr)
            return
        returns = reply.get("returns", [])
        self._cancelled.discard(spec.task_id)  # too late to cancel
        info = self._pending_tasks.get(spec.task_id)
        if reply.get("system_error"):
            e = exc.WorkerCrashedError(reply["system_error"])
            self._handle_worker_failure(spec, e)
            return
        user_error = reply.get("error")
        if user_error is not None and spec.retry_exceptions and info and (
            info["retries_left"] > 0
        ):
            info["retries_left"] -= 1
            self.io.submit(self._submit_async(spec))
            return
        contained_map = reply.get("contained") or {}
        for idx, (oid_bytes, (kind, payload)) in enumerate(zip(
            [r.binary() for r in spec.return_ids()], returns
        )):
            oid = ObjectID(oid_bytes)
            contained = contained_map.get(str(idx))
            if contained:
                # As the return's owner, hold the inner refs for the outer
                # object's lifetime (registers our borrow with their owners).
                self._contained[oid] = [
                    ObjectRef(ObjectID(bytes(b)), owner)
                    for b, owner in contained
                ]
            if kind == "v":
                value = serialization.unpack(payload)
                if isinstance(value, exc.ErrorObject):
                    self.memory_store.put_error(oid, value.error)
                else:
                    self.memory_store.put_value(oid, value)
            elif kind == "p":
                self.memory_store.put_plasma(oid, [worker_addr[2]])
        if spec.num_returns == -2:
            stream = self._gen_streams.get(spec.task_id)
            if stream is not None:
                if user_error is not None:
                    ent = self.memory_store.get(spec.return_ids()[0])
                    err = (
                        ent.value
                        if ent is not None and ent.kind == "error"
                        else exc.TaskError(function_name=spec.name,
                                           traceback_str=str(user_error),
                                           cause=None)
                    )
                    stream.finalize(error=err)
                else:
                    stream.finalize(total=int(reply.get("num_yields", 0)))
                if stream.cancelled:
                    self._gen_streams.pop(spec.task_id, None)
        info = self._pending_tasks.pop(spec.task_id, None)
        self._recovering.discard(spec.task_id)
        if info and info.get("pinned"):
            # Keep arg refs alive past the reply: the executor's add_borrower
            # for them may still be in flight on another connection.
            self._pin_handoff(info["pinned"])
        if GLOBAL_CONFIG.lineage_pinning_enabled:
            for r in spec.return_ids():
                self._lineage[r] = spec
                self._pull_failures.pop(r, None)
            if info and info.get("pinned"):
                # Lineage keeps arg objects resurrectable for resubmission.
                self._lineage_pinned[spec.task_id] = info["pinned"]

    def _handle_worker_failure(self, spec: TaskSpec, error: BaseException):
        info = self._pending_tasks.get(spec.task_id)
        if info and info["retries_left"] > 0:
            info["retries_left"] -= 1
            logger.info(
                "retrying task %s (%d retries left)",
                spec.name, info["retries_left"],
            )
            self.io.submit(self._submit_async(spec))
            return
        self._fail_task(spec, exc.WorkerCrashedError(str(error)))

    def _fail_task(self, spec: TaskSpec, error: BaseException):
        info = self._pending_tasks.pop(spec.task_id, None)
        if info and info.get("pinned"):
            self._pin_handoff(info["pinned"])
        if not isinstance(error, exc.RayTpuError):
            # str() of a bare TimeoutError/CancelledError is "" — keep
            # the type name in the surfaced diagnostics
            error = exc.TaskError(
                function_name=spec.name,
                traceback_str=str(error) or repr(error), cause=error
            )
        for r in spec.return_ids():
            self.memory_store.put_error(r, error)
        if spec.num_returns == -2:
            stream = self._gen_streams.get(spec.task_id)
            if stream is not None:
                stream.finalize(error=error)
                if stream.cancelled:
                    self._gen_streams.pop(spec.task_id, None)

    async def _conn_to(self, addr: str) -> rpc.Connection:
        """Single-flight connection cache: with pipelined submission many
        coroutines race here for a cold address — they must share ONE
        socket (ordering of actor pushes rides connection FIFO) instead of
        each opening a duplicate.

        With the native wire enabled these conns ride the conduit engine
        (``native_push_conns``): corked push bursts flush as one
        ``cd_push_batch``, and frame parsing/socket IO happen on the
        engine/reaper threads instead of the asyncio loop. The wire
        format is transport-independent, so either side may be an
        asyncio peer."""
        conn = self._worker_conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        pending = self._conn_pending.get(addr)
        if pending is None:
            pending = self._conn_pending[addr] = (
                asyncio.get_running_loop().create_future()
            )
            try:
                if (
                    GLOBAL_CONFIG.native_wire
                    and GLOBAL_CONFIG.native_push_conns
                    # may compile the shim on first call — off-loop (R7)
                    and await asyncio.to_thread(_conduit_available)
                ):
                    from ray_tpu_torch._private.conduit_rpc import connect_conduit

                    conn = await connect_conduit(
                        addr, handler=rpc.handler_table(self),
                        name=f"->{addr[-20:]}",
                    )
                else:
                    reader, writer = await rpc.open_connection(addr)
                    conn = rpc.Connection(
                        reader, writer, rpc.handler_table(self),
                        name=f"->{addr[-20:]}",
                    )
                    conn.start()
                self._worker_conns[addr] = conn
            except BaseException as e:
                if not pending.done():
                    pending.set_exception(e)
                    pending.exception()  # mark retrieved (may be no waiters)
                self._conn_pending.pop(addr, None)
                raise
            if not pending.done():
                pending.set_result(conn)
            self._conn_pending.pop(addr, None)
            return conn
        return await pending

    # ================= actors (owner side) =================
    def create_actor(
        self,
        cls,
        args_wire: List,
        *,
        name: str = "",
        actor_name: str = "",
        num_returns: int = 0,
        resources: Optional[Dict] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        scheduling_strategy=None,
        pinned=None,
        method_meta: Optional[Dict] = None,
        runtime_env: Optional[Dict] = None,
    ) -> bytes:
        cid = self._export("cls", cls)
        actor_id = ActorID.from_random().binary()
        task_id = TaskID.for_task()
        spec = TaskSpec(
            task_id=task_id.binary(),
            function_id=cid,
            job_id=self.job_id,
            name=name or getattr(cls, "__name__", "actor"),
            args=args_wire,
            num_returns=0,
            resources=resources or {"CPU": 1},
            owner=self._addr_wire,
            actor_id=actor_id,
            actor_creation=True,
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            scheduling_strategy=scheduling_strategy,
            runtime_env=self._process_runtime_env(runtime_env),
            trace_ctx=(
                _tracing.ctx_for_submit(task_id.binary())
                if GLOBAL_CONFIG.tracing_enabled else None
            ),
        )
        wire = spec.to_wire()
        wire["name_register"] = actor_name
        wire["method_meta"] = method_meta or {}
        if pinned:
            self._actor_pinned[actor_id] = pinned
        reply = self.gcs.call("create_actor", wire)
        if not reply.get("ok"):
            raise ValueError(reply.get("error", "actor creation failed"))
        self._actor_conc_cache[actor_id] = max(1, max_concurrency)
        return actor_id

    def submit_actor_task(
        self,
        actor_id: bytes,
        method_name: str,
        args_wire: List,
        *,
        num_returns: int = 1,
        max_task_retries: int = 0,
        pinned=None,
    ) -> List[ObjectRef]:
        task_id = TaskID.for_task()
        self._actor_seq[actor_id] += 1
        spec = TaskSpec(
            task_id=task_id.binary(),
            function_id=b"",
            name=method_name,
            args=args_wire,
            num_returns=num_returns,
            resources={},
            max_retries=max_task_retries,
            owner=self._addr_wire,
            actor_id=actor_id,
            method_name=method_name,
            seq_no=self._actor_seq[actor_id],
            trace_ctx=(
                _tracing.ctx_for_submit(task_id.binary())
                if GLOBAL_CONFIG.tracing_enabled else None
            ),
        )
        refs = []
        for oid in spec.return_ids():
            self.memory_store.entry(oid)
            self._owned.add(oid)
            refs.append(ObjectRef(oid, self._addr_wire))
        self._pending_tasks[spec.task_id] = {
            "spec": spec, "retries_left": 0, "pinned": pinned or [],
        }
        if num_returns == -2:
            from ray_tpu_torch._private.object_ref import (
                StreamingObjectRefGenerator,
            )

            stream = _GeneratorStream(self, spec)
            self._gen_streams[spec.task_id] = stream
            refs = [StreamingObjectRefGenerator(stream, refs[0])]
        self._emit_task_event(spec, "PENDING_NODE_ASSIGNMENT")
        # Latency path (r11): a lone call on a warm ordered stream
        # pushes its frame straight from THIS thread — no IO-loop
        # wakeup on the submit leg (the self-pipe write + pump
        # scheduling cost ~100us+ under cross-thread GIL traffic).
        if self._direct_actor_submit(spec):
            return refs
        # EVERY submission appends to the per-actor deque synchronously
        # (GIL-atomic) — the submit thread, not a loop coroutine, fixes
        # the order, so a mixed fast/slow enqueue can never invert two
        # calls on an ordered actor. The pump resolves concurrency mode
        # and only runs when none is active (coroutine-per-call costs
        # ~15us at pipelined rates).
        self._actor_queues[actor_id].append(spec)
        if actor_id not in self._actor_pumping:
            self._io_spawn(self._actor_pump(actor_id))
        return refs

    def _direct_actor_submit(self, spec: TaskSpec) -> bool:
        """Caller-thread direct push (the sync-RTT submit leg).

        Safe only when order cannot be disturbed: the actor is ORDERED
        (max_concurrency == 1), its queue is empty and no pump is
        registered (every earlier call is already on the wire — a pump
        holds its registration from entry, through popleft, until after
        its sends), the args carry no ObjectRef deps to resolve, the
        streamed conn is warm+open, and a window credit is free without
        parking. The executor runs frames in arrival order, so a frame
        sent here serializes correctly after everything the pump sent.
        Anything else falls back to the queue+pump path."""
        if not GLOBAL_CONFIG.actor_direct_submit:
            return False
        aid = spec.actor_id
        if self._actor_conc_cache.get(aid) != 1:
            return False
        if self._actor_queues[aid] or aid in self._actor_pumping:
            return False
        if spec.task_id in self._cancelled:
            return False
        for a in spec.args:
            if a[0] == "r":
                return False
        conn = self._actor_stream_conns.get(aid)
        if conn is None or conn.closed:
            return False
        reg = self._inflight_by_conn.get(conn)
        if reg is None:
            return False
        win = self._actor_windows.get(aid)
        if win is None or not win.try_acquire():
            return False
        info = self._pending_tasks.get(spec.task_id)
        if info is not None:
            info["state"] = "running"
        reg["specs"][spec.task_id] = spec
        try:
            # same slim wire as _push_actor_stream, as ONE immediate
            # frame (no cork: nothing to batch with, and the flush
            # would cost another call anyway); send_frame is
            # any-thread-safe and chaos-gated
            conn.send_frame(rpc._NOTIFY, None, "push_task_c", [
                spec.task_id, spec.actor_id, spec.method_name, spec.args,
                spec.num_returns, spec.seq_no, spec.owner,
                spec.max_retries, spec.trace_ctx,
            ])
        except Exception:
            # dead/failing conn: undo and let the pump's cold path
            # (address refresh + retries) own this call
            reg["specs"].pop(spec.task_id, None)
            if info is not None:
                info["state"] = "queued"
            win.release()
            self._actor_stream_conns.pop(aid, None)
            return False
        return True

    async def _enqueue_actor_task(self, spec: TaskSpec):
        """Per-actor FIFO with PIPELINED pushes (round 4): the pump still
        guarantees submission-order sends — a task stuck resolving a
        dependency stalls the stream so later calls can't overtake — but
        it no longer awaits each round trip before pushing the next.  Up
        to ``actor_pipeline_depth`` calls ride the connection in flight;
        the executor enforces serial in-arrival-order execution
        (rpc_push_task's per-caller ticket queue), so semantics match the
        reference's sequential actor submit queues
        (direct_actor_task_submitter) at per-message rather than
        per-round-trip cost.

        Actors declared with max_concurrency > 1 opt OUT of ordering
        (reference semantics): their tasks are pushed without waiting for
        earlier replies, so the executor's thread pool / asyncio loop can
        actually interleave them."""
        self._actor_queues[spec.actor_id].append(spec)
        await self._actor_pump(spec.actor_id)

    async def _actor_pump(self, aid: bytes):
        """Drain one actor's queue (single pump per actor; see
        _enqueue_actor_task's docstring for the pipelining contract).
        The pump owns the concurrency-mode decision: max_concurrency > 1
        actors opt OUT of ordering (reference semantics), so their
        queued specs fan out as concurrent submit coroutines instead of
        the ordered streaming pushes below."""
        q = self._actor_queues[aid]
        if aid in self._actor_pumping or not q:
            return
        self._actor_pumping.add(aid)
        if aid not in self._actor_conc_cache:
            # handle arrived from elsewhere (arg / get_actor): fetch the
            # record first — choosing the ordered pump for a concurrent
            # actor would serialize (or deadlock) wait/signal patterns
            try:
                await self._actor_address(aid)
            except BaseException:
                # pump must never wedge: deregister so the next submit
                # re-kicks (queued specs stay queued)
                self._actor_pumping.discard(aid)
                raise
            finally:
                self._actor_conc_cache.setdefault(aid, 1)
        if self._actor_conc_cache.get(aid, 1) > 1:
            try:
                while q:
                    rpc.spawn(self._submit_actor_async(q.popleft()))
            finally:
                self._actor_pumping.discard(aid)
                if q:
                    rpc.spawn(self._actor_pump(aid))
            return
        corked = None  # conn holding corked pushes awaiting flush
        ncork = 0

        def uncork():
            nonlocal corked, ncork
            if corked is not None:
                corked.flush_cork()
                corked, ncork = None, 0

        try:
            win = self._actor_windows.get(aid)
            if win is None:
                win = self._actor_windows[aid] = _ActorWindow(
                    max(1, GLOBAL_CONFIG.actor_pipeline_depth),
                    asyncio.get_running_loop(),
                )
            while q:
                s = q.popleft()
                if s.task_id in self._cancelled:
                    self._cancelled.discard(s.task_id)
                    self._fail_task(s, exc.TaskCancelledError(
                        f"actor task {s.name} was cancelled before execution"
                    ))
                    continue
                if any(a[0] == "r" for a in s.args):
                    # this call's ObjectRef args may be produced by the
                    # corked (unsent!) pushes — flush before waiting
                    uncork()
                try:
                    await self._resolve_dependencies(s)
                except Exception as e:
                    self._fail_task(s, e)
                    continue
                if not win.available():
                    # about to wait on the peer for a window slot: the
                    # corked pushes must hit the wire first (the replies
                    # that release slots depend on them)
                    uncork()
                await win.acquire()
                # Streaming push (one CORKED notify frame per call — a
                # burst goes out in one transport write): the slot is
                # released on task_done / conn close.
                conn = await self._push_actor_stream(s)
                if conn is not None:
                    corked = conn
                    ncork += 1
                    if ncork >= 32 or not q:
                        uncork()
                    continue
                # Cold or failing path: await the full round trip INLINE.
                # Serializing here is what keeps submission order when N
                # calls race a pending actor — concurrent slow pushes
                # would resume from the ALIVE-poll in arbitrary order.
                uncork()
                try:
                    await self._submit_actor_async(s, deps_resolved=True)
                except Exception as e:  # e.g. GCS conn died at shutdown
                    self._fail_task(s, e)
                finally:
                    win.release()
        finally:
            # in the finally: a cancelled/failing pump must still put its
            # corked pushes on the wire — their callers' refs hang forever
            # otherwise (the conn is healthy, so no close-path recovery)
            uncork()
            self._actor_pumping.discard(aid)
            if q:
                # a submit-thread append raced the exit (it saw the pump
                # still registered and skipped the kick): re-kick so the
                # straggler doesn't strand until the next call
                rpc.spawn(self._actor_pump(aid))

    async def _actor_address(self, actor_id: bytes, wait_alive=True):
        """Resolve an actor's address. While the actor is PENDING/RESTARTING
        and ``wait_alive``, waits INDEFINITELY (reference semantics: calls on
        a not-yet-placed actor block until placement — the GCS owns the
        timeout-vs-infeasible decision, not the caller). Returns the DEAD
        record when dead; None only when no record exists (or when
        ``wait_alive=False`` and the actor is not yet ALIVE)."""
        sleep = 0.05
        while True:
            try:
                rec = await self.gcs.conn.call_async("get_actor", actor_id,
                                                     timeout=30)
            except Exception:
                # idempotent read: a chaos-dropped frame (or a GCS link
                # mid-reconnect) must cost one poll interval, NOT fail
                # the caller's task with a bare TimeoutError — but never
                # spin against a tearing-down worker
                if self._shutdown.is_set() or self.gcs._closed_by_user:
                    raise
                if self.gcs.conn.closed:
                    # the GCS went away (a restart, or a failover to the
                    # standby): reconnect through the managed client,
                    # which cycles the endpoint list (2 s an endpoint, as
                    # its own call's replay does), then ask again
                    try:
                        await asyncio.to_thread(self.gcs._maybe_reconnect,
                                                2.0)
                    except Exception:
                        pass  # no endpoint serves yet: the next poll
                await asyncio.sleep(sleep)
                sleep = min(0.25, sleep * 1.5)
                continue
            if rec is None:
                return None
            self._actor_state_cache[actor_id] = rec["state"]
            if "max_concurrency" in rec:
                self._actor_conc_cache[actor_id] = max(
                    1, rec["max_concurrency"] or 1
                )
            if rec["state"] == "ALIVE" and rec["address"]:
                self._actor_addr_cache[actor_id] = rec["address"]
                return rec["address"]
            if rec["state"] == "DEAD":
                return rec
            if not wait_alive:
                return None
            await asyncio.sleep(sleep)
            sleep = min(0.25, sleep * 1.5)

    async def _submit_actor_async(self, spec: TaskSpec,
                                  deps_resolved: bool = False):
        if not deps_resolved:  # pipelined pump already did both checks
            if spec.task_id in self._cancelled:
                self._cancelled.discard(spec.task_id)
                self._fail_task(spec, exc.TaskCancelledError(
                    f"actor task {spec.name} was cancelled before execution"
                ))
                return
            try:
                await self._resolve_dependencies(spec)
            except Exception as e:
                self._fail_task(spec, e)
                return
        attempts = 0
        while True:
            attempts += 1
            addr = self._actor_addr_cache.get(spec.actor_id)
            if addr is None:
                got = await self._actor_address(spec.actor_id)
                # None now means "no record at all" (GCS lost/never had it);
                # pending/restarting waits happen inside _actor_address
                if got is None or isinstance(got, dict) and got.get("state") == "DEAD":
                    cause = got.get("death_cause", "") if isinstance(got, dict) else ""
                    self._fail_task(
                        spec,
                        exc.ActorDiedError(
                            actor_id=spec.actor_id.hex(), reason=cause or "actor dead"
                        ),
                    )
                    return
                addr = got
            try:
                conn = await self._conn_to(addr[1])
            except Exception:
                # couldn't even connect: stale address, retry
                self._actor_addr_cache.pop(spec.actor_id, None)
                if attempts >= 5:
                    self._fail_task(
                        spec,
                        exc.ActorUnavailableError(
                            actor_id=spec.actor_id.hex(),
                            reason="worker unreachable",
                        ),
                    )
                    return
                await asyncio.sleep(0.2 * attempts)
                continue
            info = self._pending_tasks.get(spec.task_id)
            if info is not None:
                info["state"] = "running"
            try:
                reply = await conn.call_async("push_task", spec.to_wire(),
                                              timeout=None)
            except rpc.SendError:
                # Never reached the actor: safe to retry on a fresh address
                # (common after a restart invalidates the cached connection).
                self._actor_addr_cache.pop(spec.actor_id, None)
                if attempts >= 5:
                    self._fail_task(
                        spec,
                        exc.ActorUnavailableError(
                            actor_id=spec.actor_id.hex(),
                            reason="worker unreachable",
                        ),
                    )
                    return
                await asyncio.sleep(0.2 * attempts)
                continue
            except Exception:
                # In-flight when the actor died: the method may have
                # (partially) executed. Default: fail (reference
                # RayActorError semantics). With max_task_retries > 0 the
                # user opted into at-least-once: wait for the restarted
                # incarnation and resubmit (reference max_task_retries).
                self._actor_addr_cache.pop(spec.actor_id, None)
                if spec.max_retries != 0:  # negative = infinite retries
                    if spec.max_retries > 0:
                        spec.max_retries -= 1
                    attempts = 0  # new incarnation: fresh connect budget
                    await asyncio.sleep(0.2)
                    continue
                self._fail_task(
                    spec,
                    exc.ActorDiedError(
                        actor_id=spec.actor_id.hex(),
                        reason="actor died while executing this method",
                    ),
                )
                return
            if reply.get("system_error") and spec.max_retries != 0:
                # e.g. "actor instance not initialized": the retried task
                # beat the restarted actor's creation — retry, don't route
                # into the plain-task worker-failure path
                if spec.max_retries > 0:
                    spec.max_retries -= 1
                self._actor_addr_cache.pop(spec.actor_id, None)
                await asyncio.sleep(0.2)
                continue
            self._handle_task_reply(spec, reply, addr)
            return

    # ----- streaming actor push (round 4 data plane) -----
    # One NOTIFY frame per call out ("push_task_c"/"push_task_p"), one NOTIFY frame per
    # completion back ("task_done"), handled INLINE in the read loop — no
    # per-call asyncio future on either side. Parity: the role of the
    # reference's C++ direct actor transport (task_manager + actor submit
    # queues exchanging protobufs over a held gRPC stream).

    async def _push_actor_stream(self, spec: TaskSpec):
        """Send via the streaming path (CORKED — the pump flushes).
        Returns the connection on success, None -> caller uses the slow
        coroutine (cold address, dead conn, send failure)."""
        addr = self._actor_addr_cache.get(spec.actor_id)
        if addr is None:
            return None
        try:
            conn = await self._conn_to(addr[1])
        except Exception:
            return None
        reg = self._inflight_by_conn.get(conn)
        if reg is None:
            reg = self._inflight_by_conn[conn] = {"addr": addr, "specs": {}}
            conn.sync_notify["task_done"] = self._on_task_done
            conn.sync_notify["task_done_batch"] = self._on_task_done_batch
            # singleton completions short-circuit on the reaper thread
            # (sync-RTT latency path; no-op on asyncio transports)
            conn.sync_notify_fast["task_done"] = self._on_task_done_reaper
            conn.sync_notify_fast["task_done_batch"] = (
                self._on_task_done_batch_reaper
            )
            conn.add_close_callback(self._on_actor_conn_close)
        # warm-conn registry for the caller-thread direct-submit path
        # (only ordered actors ride the streamed pump)
        self._actor_stream_conns[spec.actor_id] = conn
        info = self._pending_tasks.get(spec.task_id)
        if info is not None:
            info["state"] = "running"
        reg["specs"][spec.task_id] = spec
        try:
            # slim wire: actor pushes carry only the 9 live fields (the
            # full dict form is 5x the bytes and 4x the decode time);
            # trace_ctx rides along (None unless tracing is enabled) so
            # distributed traces don't gap on the warm fast path
            conn.send_notify_corked("push_task_c", [
                spec.task_id, spec.actor_id, spec.method_name, spec.args,
                spec.num_returns, spec.seq_no, spec.owner,
                spec.max_retries, spec.trace_ctx,
            ])
        except rpc.SendError:
            reg["specs"].pop(spec.task_id, None)
            return None
        return conn

    def _release_window(self, actor_id: bytes):
        sem = self._actor_windows.get(actor_id)
        if sem is not None:
            sem.release()

    def _on_task_done_batch(self, conn, batch):
        """One frame, N completions — the worker batches task_done
        while its exec queue stays busy (one read-loop iteration and one
        unpack amortize across the batch)."""
        for entry in batch:
            self._on_task_done(conn, entry)

    # ----- reaper-thread singleton completion (r11 latency path) -----
    # A sync actor round trip pays engine->reaper->loop->caller on the
    # return leg: the coalesced reaper->loop wakeup that makes BURSTS
    # cheap (one self-pipe write per batch) adds a whole loop
    # scheduling hop to a LONE completion. These handlers consume a
    # singleton task_done on the reaper thread itself — the memory
    # store resolves and the blocked get() caller wakes immediately,
    # and the pipeline-window release (_ActorWindow, thread-safe) frees
    # the slot without a loop hop too. Batches (>1 completion
    # per frame) and every retry/error/stream shape return False and
    # keep the PR-4 coalesced throughput path.

    def _on_task_done_batch_reaper(self, conn, batch) -> bool:
        if len(batch) != 1:
            return False  # burst: the coalesced loop path amortizes it
        return self._on_task_done_reaper(conn, batch[0])

    def _on_task_done_reaper(self, conn, data) -> bool:
        if not GLOBAL_CONFIG.task_done_reaper_fastpath:
            return False
        task_id, reply = data
        reg = self._inflight_by_conn.get(conn)
        if reg is None:
            return False
        tid = bytes(task_id)
        spec = reg["specs"].get(tid)
        if (
            spec is None
            or spec.actor_id is None  # lease pushes signal loop state
            or not self._reply_is_fast(spec, reply)
        ):
            return False
        # committed: pop exactly once (GIL-atomic); the loop-path
        # handler finding no spec is a no-op, so a racing close/fail
        # sweep can't double-complete
        if reg["specs"].pop(tid, None) is None:
            return False
        try:
            self._complete_fast_return(spec, reply, reg["addr"])
        finally:
            # the slot MUST free once the pop committed — a raising
            # completion otherwise leaks a pipeline credit forever
            # (the loop-path handler no-ops on the popped spec).
            # _ActorWindow.release is thread-safe: with no parked
            # acquirer (the sync shape) it frees with zero loop traffic
            self._release_window(spec.actor_id)
        return True

    def _on_task_done(self, conn, data):
        """Inline (read-loop) completion of a streamed actor or lease
        call."""
        task_id, reply = data
        reg = self._inflight_by_conn.get(conn)
        if reg is None:
            return
        spec = reg["specs"].pop(bytes(task_id), None)
        if spec is None:
            return
        if spec.actor_id is None:
            # streamed LEASE push: reply semantics (incl. system_error
            # retries) live in _handle_task_reply; the window slot in
            # the owning _push_loop MUST free even if reply handling
            # raises (e.g. an undeserializable return) — a swallowed
            # exception here would strand the lease forever
            cb = self._stream_done_cb.pop(spec.task_id, None)
            try:
                self._handle_task_reply(spec, reply, reg["addr"])
            finally:
                if cb is not None:
                    cb(not reply.get("system_error"))
            return
        self._release_window(spec.actor_id)
        if reply.get("system_error") and spec.max_retries != 0:
            # e.g. restarted actor not yet initialized: retry via the slow
            # path after a beat (parity with _submit_actor_async)
            if spec.max_retries > 0:
                spec.max_retries -= 1
            self._actor_addr_cache.pop(spec.actor_id, None)
            loop = asyncio.get_running_loop()
            loop.call_later(
                0.2,
                lambda: loop.create_task(
                    self._submit_actor_async(spec, deps_resolved=True)
                ),
            )
            return
        self._handle_task_reply(spec, reply, reg["addr"])

    def _on_actor_conn_close(self, conn):
        """The actor's worker died with streamed calls in flight: same
        semantics as the slow path's mid-call failure — fail with
        ActorDiedError unless the user opted into max_task_retries.
        Streamed LEASE pushes route through the plain-task worker-failure
        path (retries_left driven) instead."""
        reg = self._inflight_by_conn.pop(conn, None)
        if reg is None:
            return
        for aid, c in list(self._actor_stream_conns.items()):
            if c is conn:
                self._actor_stream_conns.pop(aid, None)
        # pop each spec — the pop is the commit point SHARED with the
        # reaper-thread fast path (GIL-atomic): whichever side pops the
        # entry owns its completion, so a task_done mid-dispatch on the
        # reaper when the conn dies can't ALSO be resubmitted/failed
        # here (double execution + double window release)
        for tid in list(reg["specs"].keys()):
            spec = reg["specs"].pop(tid, None)
            if spec is None:
                continue  # reaper fast path completed it concurrently
            if spec.actor_id is None:
                self._handle_worker_failure(
                    spec, ConnectionError("worker connection closed")
                )
                cb = self._stream_done_cb.pop(spec.task_id, None)
                if cb is not None:
                    cb(False)
                continue
            self._release_window(spec.actor_id)
            self._actor_addr_cache.pop(spec.actor_id, None)
            if spec.max_retries != 0:
                if spec.max_retries > 0:
                    spec.max_retries -= 1
                rpc.spawn(self._submit_actor_async(spec, deps_resolved=True))
            else:
                self._fail_task(
                    spec,
                    exc.ActorDiedError(
                        actor_id=spec.actor_id.hex(),
                        reason="actor died while executing this method",
                    ),
                )

    def cancel_task(self, ref: ObjectRef) -> bool:
        """Cancel the (not-yet-running) task that produces ``ref``."""
        task_id = ref.id.task_id().binary()
        info = self._pending_tasks.get(task_id)
        if info is None:
            return False  # already finished (or unknown)
        if info.get("state") == "running":
            return False  # already dispatched; we don't interrupt execution
        self._cancelled.add(task_id)

        # If it's still sitting in a lease queue, fail it now; if a push loop
        # already holds it, the pre-push check (above) fails it instead.
        def _sweep():
            for st in self._lease_states.values():
                for spec in list(st.queue):
                    if spec.task_id == task_id:
                        st.queue.remove(spec)
                        self._cancelled.discard(task_id)
                        self._fail_task(spec, exc.TaskCancelledError(
                            f"task {spec.name} was cancelled"
                        ))
                        return
            for q in self._actor_queues.values():
                for spec in list(q):
                    if spec.task_id == task_id:
                        q.remove(spec)
                        self._cancelled.discard(task_id)
                        self._fail_task(spec, exc.TaskCancelledError(
                            f"actor task {spec.name} was cancelled"
                        ))
                        return

        self.io.call_soon(_sweep)
        return True

    def kill_actor(self, actor_id: bytes, no_restart=True):
        self.gcs.call("kill_actor", [actor_id, no_restart])
        self._actor_addr_cache.pop(actor_id, None)

    def get_named_actor(self, name: str):
        rec = self.gcs.call("get_named_actor", name)
        if rec is None or rec["state"] == "DEAD":
            raise ValueError(f"Failed to look up actor with name {name!r}")
        self._actor_conc_cache[bytes(rec["actor_id"])] = max(
            1, rec.get("max_concurrency", 1) or 1
        )
        return rec

    # ================= execution (worker side) =================
    @staticmethod
    def _loop_reply(fut, loop):
        """Thread-safe completion callback resolving a loop future (the
        asyncio-transport reply path; conduit conns reply natively)."""

        def fn(r):
            loop.call_soon_threadsafe(
                lambda: (not fut.done()) and fut.set_result(r)
            )

        return fn

    def _push_needs_staging(self, spec: TaskSpec) -> bool:
        """True if any plasma arg is not yet in the local store (callable
        from any thread: memory_store and the native store are locked)."""
        for a in spec.args:
            if a[0] != "r":
                continue
            oid = ObjectID(bytes(a[1]))
            e = self.memory_store.get(oid)
            if e is not None and e.ready and e.kind != "plasma":
                continue
            if not self.store.contains(oid):
                return True
        return False

    def _conduit_fast_push(self, conn, kind, seqno, method, data) -> bool:
        """Reaper-thread push_task dispatch (native-wire hot path): parse
        the spec, check staging, and enqueue for execution WITHOUT
        touching the asyncio loop. Ordered-actor pushes pass the
        per-connection OrderGate so submission-order execution survives
        out-of-order staging. Returns False to route to the loop."""
        if method == "push_task" and kind == 0:  # rpc._REQUEST
            streamed = False
        elif method in ("push_task_c", "push_task_p") and kind == 3:
            streamed = True  # rpc._NOTIFY
        else:
            return False
        try:
            if method == "push_task_c":
                spec = _spec_from_slim(data)
            elif method == "push_task_p":
                spec = _spec_from_slim_plain(data)
            else:
                spec = TaskSpec.from_wire(data)
        except Exception:
            return False
        if streamed:
            reply_fn = conn.task_done_fn(
                spec.task_id, flush_hint=self._exec_queue.empty
            )
            self._done_conns.add(conn)  # backstop flush (exec idle tick)
        else:
            reply_fn = conn.reply_fn(seqno, method)
        need = self._push_needs_staging(spec)
        run = lambda: self._exec_queue.put((spec, reply_fn))  # noqa: E731
        ordered = (
            spec.actor_id is not None
            and not spec.actor_creation
            and self._actor_concurrency <= 1
        )
        if ordered:
            gate = conn.order_gate
            if gate is None:
                from ray_tpu_torch._private.conduit_rpc import OrderGate

                gate = conn.order_gate = OrderGate()
            ent = gate.submit(run, ready=not need)
            if need:
                self.io.submit(self._stage_then_release(spec, gate, ent))
        elif need:
            self.io.submit(self._stage_then_run(spec, run))
        else:
            run()
        return True

    async def _stage_then_release(self, spec, gate, ent):
        try:
            await self._stage_plasma_args(spec)
        finally:
            # release even on staging failure: the executor's arg decode
            # surfaces ObjectLostError / drives recovery properly
            gate.mark_ready(ent)

    async def _stage_then_run(self, spec, run):
        try:
            await self._stage_plasma_args(spec)
        finally:
            run()

    async def rpc_push_task(self, conn, spec_wire: Dict):
        """Queue a task for the main-thread executor; reply when done.

        Plasma args are STAGED here first (async pulls on the IO loop, no
        deadline — parity: reference raylet DependencyManager staging args
        before dispatch, dependency_manager.h:51). The execution thread
        never blocks on a transfer.

        Ordered-actor pushes (concurrency 1) additionally pass a
        PER-CALLER ticket queue: with the round-4 pipelined client, many
        pushes from one caller are in flight at once, and a push whose
        args stage slowly must not be overtaken in the exec queue by a
        later one (submission-order execution is the sequential-actor
        contract).  Tickets are taken synchronously at handler start —
        i.e. in frame-arrival order, which equals the caller's submission
        order — and released at exec-queue insertion (the single exec
        thread serializes from there).  Plain tasks and concurrency>1
        actors skip the gate."""
        return await self._pushed_task_reply(conn, TaskSpec.from_wire(spec_wire))

    async def rpc_push_task_c(self, conn, wire: List):
        """Streamed (notify) slim-wire push: same execution path as
        rpc_push_task, completion sent back as a ``task_done`` notify
        keyed by task id (no request/reply future on either side). This
        is the asyncio-transport fallback; conduit workers intercept the
        frame on the reaper thread (_conduit_fast_push) and never reach
        here. (The full-wire notify variant ``push_task_n`` was dead wire
        surface — every streamed sender encodes slim — and was removed
        by the R10 contract pass.)"""
        spec = _spec_from_slim(wire)
        reply = await self._pushed_task_reply(conn, spec)
        await conn.notify_async("task_done", [spec.task_id, reply])

    async def rpc_push_task_p(self, conn, wire: List):
        """Slim-wire streamed PLAIN-task push (asyncio fallback; conduit
        workers intercept on the reaper thread in _conduit_fast_push)."""
        spec = _spec_from_slim_plain(wire)
        reply = await self._pushed_task_reply(conn, spec)
        await conn.notify_async("task_done", [spec.task_id, reply])

    async def _pushed_task_reply(self, conn, spec: TaskSpec):
        ordered = (
            spec.actor_id is not None
            and not spec.actor_creation
            and self._actor_concurrency <= 1
        )
        loop = asyncio.get_running_loop()
        if ordered:
            order_q = getattr(conn, "_push_order", None)
            if order_q is None:
                order_q = conn._push_order = collections.deque()
            ticket = loop.create_future()
            order_q.append(ticket)
            if len(order_q) == 1:
                ticket.set_result(None)
            try:
                await self._stage_plasma_args(spec)
                await ticket
                fut = loop.create_future()
                self._exec_queue.put((spec, self._loop_reply(fut, loop)))
            finally:
                # remove OUR ticket (it is the head on the success path,
                # but an exception can fire while we are mid-queue)
                if order_q and order_q[0] is ticket:
                    order_q.popleft()
                else:
                    try:
                        order_q.remove(ticket)
                    except ValueError:
                        pass
                if order_q:
                    nxt = order_q[0]
                    if not nxt.done():
                        nxt.set_result(None)
            return await fut
        await self._stage_plasma_args(spec)
        fut = loop.create_future()
        self._exec_queue.put((spec, self._loop_reply(fut, loop)))
        return await fut

    async def rpc_stage_args_hint(self, conn, refs_wire: List):
        """Prefetch hint from an owner: pull these objects into the local
        node store (best-effort, concurrent — one wedged pull must not
        delay the others)."""

        async def one(oid_bytes):
            if self.store.contains(ObjectID(bytes(oid_bytes))):
                return
            try:
                await self.raylet.conn.call_async(
                    "pull_object", bytes(oid_bytes), timeout=None
                )
            except Exception:
                pass  # best-effort; staging at dispatch still covers it

        await asyncio.gather(*(one(ob) for ob, _owner in refs_wire))
        return True

    async def _stage_plasma_args(self, spec: TaskSpec):
        """Pull every plasma arg into the local store before execution.
        Waits as long as the transfer takes; persistent pull failures are
        LEFT to _decode_args' get(), whose lost-object machinery surfaces
        a proper ObjectLostError / reconstruction instead of a timeout."""
        need = [
            ObjectRef(ObjectID(bytes(oid_bytes)), owner)
            for oid_bytes, owner in self._plasma_arg_wire(spec)
            if not self.store.contains(ObjectID(bytes(oid_bytes)))
        ]
        if not need:
            return

        async def stage_one(ref):
            # _pull_async = raylet pull + owner fallback (small
            # memory-store values have no plasma copy anywhere) + failure
            # counting that feeds get()'s lost-object detection
            for _ in range(3):
                await self._pull_async(ref)
                if self.store.contains(ref.id):
                    return
                e = self.memory_store.get(ref.id)
                if e is not None and e.ready:
                    return  # resolved via the owner (value or error)
                await asyncio.sleep(0.2)
            # still missing: _decode_args will drive recovery/errors

        await asyncio.gather(*(stage_one(r) for r in need))

    async def rpc_create_actor_instance(self, conn, spec_wire: Dict):
        spec = TaskSpec.from_wire(spec_wire)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._exec_queue.put((spec, self._loop_reply(fut, loop)))
        reply = await fut
        if reply.get("error") or reply.get("system_error"):
            return {"ok": False,
                    "error": reply.get("error") or reply.get("system_error")}
        return {"ok": True}

    def execution_loop(self):
        """Run on the worker's MAIN thread (owns JAX/device runtime).

        Plain tasks and concurrency-1 sync actor methods execute inline.
        Actors created with max_concurrency > 1 dispatch methods to a
        thread pool; async-def methods run on a dedicated asyncio loop
        (parity: reference BoundedExecutor thread_pool.h:36 and the
        boost::fibers async-actor path fiber.h — asyncio instead)."""
        import inspect

        while not self._shutdown.is_set():
            self._prune_handoff_pins()
            try:
                item = self._exec_queue.get(timeout=0.1)
            except queue_mod.Empty:
                # idle tick: flush any batched task_done completions left
                # buffered behind another caller's queued work
                for conn in list(self._done_conns):
                    if conn.closed:
                        self._done_conns.discard(conn)
                    else:
                        conn.flush_task_done()
                continue
            spec, reply_to = item  # reply_to is thread-safe

            is_plain_method = (
                spec.actor_id is not None
                and not spec.actor_creation
                and self._actor_instance is not None
            )
            if is_plain_method:
                if self._actor_is_async:
                    # ALL methods of an async actor route through its aio
                    # loop (sync ones via to_thread inside) so the
                    # max_concurrency semaphore governs every method —
                    # otherwise a sync method would run on this thread
                    # concurrently with a suspended coroutine.
                    self._run_async_method(spec, reply_to)
                    continue
                if self._actor_threads is not None:
                    self._actor_threads.submit(
                        lambda s=spec, cb=reply_to: cb(self._execute(s))
                    )
                    continue
            reply_to(self._execute(spec))

    def _ensure_actor_aio(self):
        if self._actor_aio_loop is None:
            loop = asyncio.new_event_loop()

            def run():
                asyncio.set_event_loop(loop)
                loop.run_forever()

            threading.Thread(target=run, daemon=True,
                             name="actor-asyncio").start()
            self._actor_aio_loop = loop
            self._actor_aio_sem = None  # built lazily on the loop

    def _run_async_method(self, spec: TaskSpec, reply_to):
        """Schedule an async-def actor method on the actor's asyncio loop;
        up to max_concurrency coroutines run interleaved."""
        self._ensure_actor_aio()

        import inspect

        async def run():
            if self._actor_aio_sem is None:
                self._actor_aio_sem = asyncio.Semaphore(
                    max(1, self._actor_concurrency)
                )
            async with self._actor_aio_sem:
                self._emit_task_event(spec, "RUNNING")
                if spec.trace_ctx:
                    # per-asyncio-task context: nested submits inherit
                    _tracing.set_current(
                        (spec.trace_ctx[0], spec.trace_ctx[2])
                    )
                try:
                    method = getattr(self._actor_instance, spec.method_name)
                    args, kwargs = self._unpack_args(self._decode_args(spec))
                    if inspect.isasyncgenfunction(method):
                        result = method(*args, **kwargs)  # async generator
                    elif inspect.iscoroutinefunction(method):
                        result = await method(*args, **kwargs)
                    else:
                        # sync method of an async actor: off the loop so
                        # coroutines keep interleaving, still semaphore-capped
                        result = await asyncio.to_thread(
                            method, *args, **kwargs
                        )
                    if spec.num_returns == -2:
                        # streaming: never block this loop on report acks
                        if inspect.isasyncgen(result):
                            out = await self._stream_async_generator_returns(
                                spec, result
                            )
                        else:
                            out = await asyncio.to_thread(
                                self._stream_generator_returns, spec, result
                            )
                    else:
                        # pack + copy off the actor's asyncio loop: a large
                        # return would stall other in-flight methods (R7)
                        out = await asyncio.to_thread(
                            self._encode_returns, spec, result
                        )
                    self._emit_task_event(spec, "FINISHED")
                    return out
                except Exception as e:  # noqa: BLE001 — shipped to caller
                    return self._error_reply(spec, e)

        cf = asyncio.run_coroutine_threadsafe(run(), self._actor_aio_loop)

        def done(c):
            try:
                r = c.result()
            except BaseException as e:  # cancelled loop, pack failure, ...
                r = self._error_reply(spec, e)
            reply_to(r)

        cf.add_done_callback(done)

    # ================= runtime envs =================
    # Parity: reference runtime_env (env_vars + working_dir zipped through
    # the GCS KV and cached per node — python/ray/_private/runtime_env/
    # working_dir.py). pip, conda and containers are out of scope (see
    # DESIGN.md, "Left out"); unknown keys raise.

    _RUNTIME_ENV_KEYS = {"env_vars", "working_dir"}

    def _process_runtime_env(self, runtime_env: Optional[Dict]) -> Optional[Dict]:
        """Driver side: validate + upload working_dir; returns wire form."""
        if not runtime_env:
            return None
        unknown = set(runtime_env) - self._RUNTIME_ENV_KEYS
        if unknown:
            raise ValueError(
                f"unsupported runtime_env keys {sorted(unknown)} "
                f"(supported: {sorted(self._RUNTIME_ENV_KEYS)})"
            )
        wire: Dict = {}
        env_vars = runtime_env.get("env_vars")
        if env_vars:
            wire["env_vars"] = {str(k): str(v) for k, v in env_vars.items()}
        wdir = runtime_env.get("working_dir")
        if wdir:
            if not os.path.isdir(wdir):
                raise ValueError(
                    f"runtime_env working_dir {wdir!r} is not a directory"
                )
            import io
            import zipfile

            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                for root, dirs, files in os.walk(wdir):
                    dirs[:] = [d for d in dirs if d != "__pycache__"]
                    for f in files:
                        full = os.path.join(root, f)
                        zf.write(full, os.path.relpath(full, wdir))
            blob = buf.getvalue()
            key = "wdir:" + hashlib.sha256(blob).hexdigest()[:24]
            if not self.gcs.call("kv_exists", key):
                self.gcs.call("kv_put", [key, blob, False])
            wire["working_dir_key"] = key
        return wire or None

    def _materialize_working_dir(self, key: str) -> str:
        """Worker side: download + extract once per node (content-addressed)."""
        cache = os.path.join(self.session_dir, "runtime_env",
                             key.split(":", 1)[1])
        if os.path.isdir(cache):
            return cache
        blob = self.gcs.call("kv_get", key)
        if blob is None:
            raise RuntimeError(f"runtime_env working_dir {key} missing")
        import io
        import zipfile

        tmp = cache + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, cache)
        except OSError:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)  # racer won
        return cache

    def _apply_runtime_env(self, spec: TaskSpec, permanent: bool = False):
        """Apply env_vars/working_dir; returns a restore callable
        (no-op when permanent — actor creation keeps its env for life)."""
        renv = spec.runtime_env
        if not renv:
            return lambda: None
        saved_env: Dict[str, Optional[str]] = {}
        for k, v in (renv.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        saved_cwd = None
        added_paths: List[str] = []
        key = renv.get("working_dir_key")
        if key:
            path = self._materialize_working_dir(key)
            saved_cwd = os.getcwd()
            os.chdir(path)
            import sys as _sys

            _sys.path.insert(0, path)
            added_paths.append(path)
        if permanent:
            return lambda: None

        def restore():
            for k, old in saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            if saved_cwd is not None:
                os.chdir(saved_cwd)
            if added_paths:
                import sys as _sys

                for p in added_paths:
                    try:
                        _sys.path.remove(p)
                    except ValueError:
                        pass
                    # evict modules imported FROM the env dir: a later
                    # task with a different env must not see stale code
                    for mod_name in [
                        m for m, mod in list(_sys.modules.items())
                        if getattr(mod, "__file__", None)
                        and str(getattr(mod, "__file__")).startswith(
                            p + os.sep
                        )
                    ]:
                        _sys.modules.pop(mod_name, None)

        return restore

    def _decode_args(self, spec: TaskSpec):
        args = []
        for a in spec.args:
            if a[0] == "v":
                args.append(serialization.unpack(a[1]))
            else:
                oid = ObjectID(bytes(a[1]))
                ref = ObjectRef(oid, a[2])
                # No deadline: args were staged before dispatch
                # (rpc_push_task), so this is normally a local read. A
                # genuinely lost object surfaces via get()'s pull-failure
                # counting + lineage reconstruction — a slow transfer is a
                # wait, never a task failure (VERDICT r2 weak #2).
                vals = self.get([ref], timeout=None)
                args.append(vals[0])
        return args

    def _execute(self, spec: TaskSpec) -> Dict:
        self._current_task_name = spec.name
        self._emit_task_event(spec, "RUNNING")
        trace_token = None
        if spec.trace_ctx:
            # nested submits from the user function inherit this trace
            trace_token = _tracing.set_current(
                (spec.trace_ctx[0], spec.trace_ctx[2])
            )
        try:
            if spec.actor_creation:
                # actor runtime env persists for the actor's lifetime
                self._apply_runtime_env(spec, permanent=True)
                cls_info = self._fetch("cls", spec.function_id, spec.job_id)
                args, kwargs = self._unpack_args(self._decode_args(spec))
                cls = cls_info
                self._actor_instance = cls(*args, **kwargs)
                self._actor_id = spec.actor_id
                self._actor_concurrency = max(1, spec.max_concurrency or 1)
                import inspect as _inspect

                self._actor_is_async = any(
                    _inspect.iscoroutinefunction(m)
                    or _inspect.isasyncgenfunction(m)
                    for _, m in _inspect.getmembers(type(self._actor_instance))
                )
                if self._actor_concurrency > 1 and not self._actor_is_async:
                    from concurrent.futures import ThreadPoolExecutor

                    self._actor_threads = ThreadPoolExecutor(
                        max_workers=self._actor_concurrency,
                        thread_name_prefix="actor-exec",
                    )
                return {"returns": []}
            if spec.actor_id:
                if self._actor_instance is None:
                    return {"system_error": "actor instance not initialized"}
                method = getattr(self._actor_instance, spec.method_name)
                args, kwargs = self._unpack_args(self._decode_args(spec))
                result = method(*args, **kwargs)
            else:
                fn = self._fetch("fn", spec.function_id, spec.job_id)
                args, kwargs = self._unpack_args(self._decode_args(spec))
                restore_env = self._apply_runtime_env(spec)
                try:
                    result = fn(*args, **kwargs)
                finally:
                    restore_env()
            out = self._encode_returns(spec, result)
            self._emit_task_event(spec, "FINISHED")
            return out
        except Exception as e:
            return self._error_reply(spec, e)
        finally:
            self._current_task_name = ""
            if trace_token is not None:
                _tracing.reset(trace_token)

    def _error_reply(self, spec: TaskSpec, e: BaseException) -> Dict:
        tb = traceback.format_exc()
        self._emit_task_event(spec, "FAILED", error=str(e))
        err = exc.TaskError(
            function_name=spec.name, traceback_str=tb,
            # typed framework errors (BackpressureError & co.) must reach
            # the caller as objects; arbitrary user exceptions ride along
            # when picklable (the except below degrades to text if not)
            cause=e if isinstance(e, exc.RayTpuError) else None,
        )
        try:
            packed = serialization.pack(exc.ErrorObject(err))
        except Exception:  # exotic unpicklable failure: degrade to text
            packed = serialization.pack(
                exc.ErrorObject(
                    exc.TaskError(
                        function_name=spec.name,
                        traceback_str=f"{type(e).__name__}: {e}",
                        cause=None,
                    )
                )
            )
        n = 1 if spec.num_returns in (-1, -2) else spec.num_returns
        returns = [["v", packed] for _ in range(n)]
        return {"returns": returns, "error": str(e)}

    @staticmethod
    def _unpack_args(decoded):
        """Args wire = [*positional, kwargs_dict_marker]."""
        if decoded and isinstance(decoded[-1], _KwArgs):
            return decoded[:-1], decoded[-1].kwargs
        return decoded, {}

    # ---- streaming generator execution (parity: reference streaming
    # generator returns, core_worker.proto ReportGeneratorItemReturns;
    # the CALLER owns every yield — see rpc_report_generator_item) ----

    def _encode_yield(self, spec: TaskSpec, index: int, item) -> Dict:
        """Pack one yield: big values go into the local store under the
        deterministic yield id; small ones ride in the report RPC."""
        from ray_tpu_torch._private.object_store import ObjectExistsError
        from ray_tpu_torch._private.protocol import yield_object_id

        oid = yield_object_id(spec.tid, index)
        meta, views, total = serialization.packed_size(item)
        if serialization.take_contained_refs():
            # No containment-edge shipping on the report path yet: failing
            # loudly beats a silent borrow leak (the inner object could be
            # freed under the consumer).
            raise TypeError(
                "streaming generators cannot yield values containing "
                "ObjectRefs (yield the value itself, or use "
                "num_returns='dynamic')"
            )
        if total > GLOBAL_CONFIG.inline_object_max_bytes:
            try:
                buf = self._create_with_spill(oid, total)
            except ObjectExistsError:
                # re-execution on the same node: bytes already sealed
                self.gcs.call("add_object_location",
                              [oid.binary(), self.node_id])
                return {"task_id": spec.task_id, "index": index,
                        "kind": "p", "node": self.node_id}
            try:
                serialization.pack_into(meta, views, buf)
            except BaseException:
                self.store.abort(oid)
                raise
            finally:
                del buf
            self.store.seal(oid)
            self.store.release(oid)
            self.gcs.call("add_object_location", [oid.binary(), self.node_id])
            return {"task_id": spec.task_id, "index": index,
                    "kind": "p", "node": self.node_id}
        out = bytearray(total)
        serialization.pack_into(meta, views, memoryview(out))
        return {"task_id": spec.task_id, "index": index,
                "kind": "v", "payload": bytes(out)}

    async def _send_gen_report(self, owner_wire, msg: Dict) -> Dict:
        conn = await self._conn_to(owner_wire[1])
        # no timeout: the caller delays the reply as backpressure
        return await conn.call_async("report_generator_item", msg,
                                     timeout=None)

    def _stream_generator_returns(self, spec: TaskSpec, result) -> Dict:
        """Drive a (sync) generator, reporting each yield to the caller and
        blocking this executing thread on the caller's ack — the ack delay
        is the backpressure. Runs on the execution thread, never the IO
        loop."""
        import inspect

        if not inspect.isgenerator(result) and not hasattr(
            result, "__iter__"
        ):
            raise TypeError(
                f"num_returns='streaming' task {spec.name} must return a "
                f"generator/iterable, got {type(result).__name__}"
            )
        n = 0
        for item in result:
            msg = self._encode_yield(spec, n, item)
            fut = asyncio.run_coroutine_threadsafe(
                self._send_gen_report(spec.owner, msg), self.io.loop
            )
            reply = fut.result()
            if not reply.get("ok"):
                break  # caller gone: stop generating
            n += 1
        count_packed = serialization.pack(n)
        serialization.take_contained_refs()
        return {"returns": [["v", count_packed]], "num_yields": n}

    async def _stream_async_generator_returns(self, spec: TaskSpec,
                                              agen) -> Dict:
        """Async-generator variant (async actor methods): awaits the report
        ack without blocking the actor's asyncio loop."""
        n = 0
        async for item in agen:
            # serialize off the actor loop; contained-ref tracking is
            # thread-local and consumed inside _encode_yield itself (R7)
            msg = await asyncio.to_thread(self._encode_yield, spec, n, item)
            fut = asyncio.run_coroutine_threadsafe(
                self._send_gen_report(spec.owner, msg), self.io.loop
            )
            reply = await asyncio.wrap_future(fut)
            if not reply.get("ok"):
                break
            n += 1
        count_packed = serialization.pack(n)
        serialization.take_contained_refs()
        return {"returns": [["v", count_packed]], "num_yields": n}

    def _encode_returns(self, spec: TaskSpec, result) -> Dict:
        if spec.num_returns == -2:
            return self._stream_generator_returns(spec, result)
        if spec.num_returns == 0:
            return {"returns": []}
        if spec.num_returns == -1:
            # dynamic generator task: each yield becomes its own object
            # (put by this executor), the single return is the ref list.
            # KNOWN DEVIATION from the reference: the executor worker owns
            # the yielded objects (reference assigns the caller). The bytes
            # live in the node's raylet-owned store, so gets keep working
            # if this worker exits — but lineage reconstruction and
            # owner-driven freeing stop at the worker's lifetime. Streaming
            # generators with caller ownership are the successor design.
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            refs = [self.put(item) for item in result]
            values = [ObjectRefGenerator(refs)]
        elif spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} returned {len(values)} values, "
                    f"expected {spec.num_returns}"
                )
        returns = []
        contained_map: Dict[int, List] = {}
        inline_cap = GLOBAL_CONFIG.task_inline_return_bytes
        for idx, (oid, value) in enumerate(zip(spec.return_ids(), values)):
            meta, views, total = serialization.packed_size(value)
            contained = serialization.take_contained_refs()
            if contained:
                # Ship containment edges to the return's owner (the caller)
                # and pin locally until the caller registers its borrows.
                contained_map[str(idx)] = [
                    [r.binary(), r.owner_address] for r in contained
                ]
                self._pin_handoff(contained)
            if inline_cap <= 0 or total > inline_cap:
                # store-backed return ("p"): the owner pulls the bytes —
                # also the interop fallback shape when inlining is off
                buf = self._create_with_spill(oid, total)
                try:
                    serialization.pack_into(meta, views, buf)
                except BaseException:
                    self.store.abort(oid)
                    raise
                finally:
                    del buf
                self.store.seal(oid)
                self.store.release(oid)
                self.gcs.call("add_object_location", [oid.binary(), self.node_id])
                returns.append(["p", b""])
            else:
                # inlined return ("v"): rides INSIDE the completion frame
                # (task_done / task_done_batch) — no put+pin+get round
                # trip anywhere on the path
                out = bytearray(total)
                serialization.pack_into(meta, views, memoryview(out))
                self.task_inline_hits += 1
                self.task_inline_bytes += total
                returns.append(["v", bytes(out)])
        reply = {"returns": returns}
        if contained_map:
            reply["contained"] = contained_map
        return reply

    # ================= shutdown =================
    def shutdown(self):
        self._shutdown.set()
        install_ref_hooks(None, None)
        # bounded: the server's stop waits until every inbound connection
        # is gone, and a connection whose peer stopped reading an
        # in-flight reply never goes (its transport waits to flush)
        stop = self.io.submit(self.server.stop_async())
        try:
            stop.result(timeout=GLOBAL_CONFIG.core_worker_shutdown_timeout_s)
        except Exception:
            stop.cancel()
            self.io.call_soon(self._abort_server_connections)
        for c in (self.gcs, self.raylet):
            try:
                c.close()
            except Exception:
                pass
        try:
            self.store.close()
        except Exception:
            pass

    def _abort_server_connections(self):
        """IO-loop side of a shutdown past its bound: drop every inbound
        connection without flushing what it still has to send (only the
        asyncio server's stop can wait; the conduit's returns at once)."""
        for c in list(self.server.connections):
            writer = getattr(c, "writer", None)
            if writer is not None:
                writer.transport.abort()

    def leak_stats(self) -> Dict[str, int]:
        """Per-process resource-lifecycle ledger (r20): counters that
        must be zero when no calls are in flight. Fed into the raylet's
        node_stats["leaks"] via the task-stats fan-out."""
        return {
            "unsealed_creates": self.store.unsealed_creates,
            "actor_window_outstanding": sum(
                w.outstanding() for w in self._actor_windows.values()
            ),
        }

    async def rpc_ping(self, conn, _):
        return "pong"

    async def rpc_task_stats(self, conn, _):
        """Task-plane counters (the raylet aggregates these per node
        into node_stats["task_plane"]; the perf bench reads the driver's
        own instance for its micro detail)."""
        return {
            "task_inline_hits": self.task_inline_hits,
            "task_inline_bytes": self.task_inline_bytes,
            "leaks": self.leak_stats(),
        }

    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        f: "concurrent.futures.Future" = concurrent.futures.Future()

        def waiter():
            try:
                f.set_result(self.get([ref])[0])
            except BaseException as e:
                f.set_exception(e)

        threading.Thread(target=waiter, daemon=True).start()
        return f


class _KwArgs:
    """Marker wrapping kwargs as the last positional arg on the wire."""

    __slots__ = ("kwargs",)

    def __init__(self, kwargs):
        self.kwargs = kwargs


class _NotReady:
    pass


_NOT_READY = _NotReady()


class _Err:
    """Marks a task/system error fetched by get(); distinguishes it from a
    user value that happens to BE an exception object."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error
