"""Raylet: the per-node daemon — worker pool + lease-based local scheduler.

Parity: reference ``src/ray/raylet/`` — NodeManager lease protocol
(HandleRequestWorkerLease node_manager.cc:1887), WorkerPool
(worker_pool.cc:426 StartWorkerProcess, :1141 PopWorker), local/cluster task
managers (scheduling/cluster_task_manager.h:42, local_task_manager.h:58) and
the hybrid scheduling policy (policy/hybrid_scheduling_policy.h:50).

Redesigns (TPU build): the object store is an in-process mmap'd arena (no
store daemon — src/store/store.cpp) created by the raylet and attached by
every local worker; workers register over the symmetric RPC connection so the
raylet pushes actor-creation tasks down the same pipe; spillback decisions use
the GCS-gossiped resource view.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import math
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import chaos as _chaos
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.object_store import SharedMemoryStore
from ray_tpu_torch._private.protocol import (
    LABEL_DCN,
    LABEL_GANG,
    LABEL_HOST,
    LABEL_SLICE,
    NodeInfo,
)

logger = logging.getLogger(__name__)

_SHARE_EPS = 1e-9


def _card_ids(n_cards: int) -> List[str]:
    """The id by which a worker's CUDA_VISIBLE_DEVICES names each card
    index of this node: the raylet's own visible list when it names that
    many cards, else the indices (a node given more GPUs than it sees,
    as simulated nodes are)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [v.strip() for v in visible.split(",")] if visible else []
    if len(ids) >= n_cards:
        return ids[:n_cards]
    return [str(i) for i in range(n_cards)]


def _split(gpus: float) -> Tuple[int, float]:
    """A GPU request as (whole cards, the fraction of one more)."""
    whole = int(gpus + _SHARE_EPS)
    frac = gpus - whole
    return whole, frac if frac > _SHARE_EPS else 0.0


def _shares_on(cards: Tuple[int, ...], gpus: float,
               free: List[float]) -> Optional[Dict[int, float]]:
    """A lease of ``gpus`` laid on exactly these cards, or None: the whole
    part takes wholly free cards, the fractional part one more card with
    that share free. The share of a card never goes below 0."""
    whole, frac = _split(gpus)
    if len(cards) != whole + (1 if frac else 0):
        return None
    shares: Dict[int, float] = {}
    rest = list(cards)
    for _ in range(whole):
        full = [c for c in rest if free[c] >= 1.0 - _SHARE_EPS]
        if not full:
            return None
        rest.remove(full[0])
        shares[full[0]] = 1.0
    if frac:
        if free[rest[0]] < frac - _SHARE_EPS:
            return None
        shares[rest[0]] = frac
    return shares


def _fresh_cards(gpus: float, free: List[float]) -> Optional[Tuple[int, ...]]:
    """Cards for a lease of ``gpus`` with no worker to reuse: the lowest
    wholly free cards, and a fractional part on the fullest card that
    still holds it (packing leaves whole cards for whole leases)."""
    whole, frac = _split(gpus)
    full = [c for c, f in enumerate(free) if f >= 1.0 - _SHARE_EPS]
    if len(full) < whole:
        return None
    cards = full[:whole]
    if frac:
        fits = [c for c, f in enumerate(free)
                if c not in cards and f >= frac - _SHARE_EPS]
        if not fits:
            return None
        cards.append(min(fits, key=lambda c: (free[c], c)))
    return tuple(sorted(cards))


def locality_class(my_labels: Optional[Dict[str, str]],
                   peer_labels: Optional[Dict[str, str]]) -> int:
    """Locality rank of a pull peer from node labels: 0 = same host
    (``raytpu.io/host`` matches), 1 = same slice (``raytpu.io/slice``,
    provider-stamped — ICI-connected peers one hop away), 2 = same gang
    (``raytpu.io/gang``, MeshGroup-stamped — a gang may span slices),
    3 = same DCN neighborhood (``raytpu.io/dcn``, provider-stamped pod/
    cell), 4 = everything else. Pure label comparison, no I/O: a label
    a side lacks never matches, so unlabeled clusters keep today's
    ordering exactly."""
    mine = my_labels or {}
    theirs = peer_labels or {}
    for rank, key in enumerate(
        (LABEL_HOST, LABEL_SLICE, LABEL_GANG, LABEL_DCN)
    ):
        val = mine.get(key)
        if val is not None and theirs.get(key) == val:
            return rank
    return 4


class _LocationMiss(Exception):
    """A pull peer answered 'I no longer hold a copy' — a LOCATION
    miss, not a transport fault: the conn is healthy (keep it pooled),
    same-peer chunk retries cannot help, and the cure is refreshing
    object locations at the next full pull attempt."""


class _PullSink:
    """Write-into-place target + arrival ledger for one striped pull.

    Chunk frames land from transport threads (conduit reaper / IO loop):
    inline payloads copy straight into the store buffer here, native
    deposits just record. The lock serializes writes against the abort
    path, so a straggler chunk can never land in a freed store slot.

    The ledger doubles as the broadcast tree's PARTIAL-SERVE source:
    ``covered``/``read`` let this raylet serve already-landed ranges of
    an in-progress pull onward to child pullers."""

    __slots__ = ("_buf", "_lock", "closed", "landed", "size", "chunk")

    def __init__(self, buf, size: int = 0, chunk: int = 0):
        self._buf = buf
        self._lock = threading.Lock()
        self.closed = False
        self.landed: Dict[int, int] = {}  # chunk off -> bytes landed
        self.size = size
        self.chunk = chunk

    def write(self, off: int, mv) -> bool:
        """Copy one chunk payload straight into the store buffer (the
        only Python-side copy the receive path makes). False once
        closed."""
        with self._lock:
            if self.closed:
                return False
            self._buf[off : off + len(mv)] = mv
            return True

    def record(self, off: int, n: int):
        with self._lock:
            if not self.closed:
                self.landed[off] = n

    def covered(self, off: int, n: int) -> bool:
        """True when every pull-grid chunk overlapping [off, off+n) has
        fully landed (a stale False just makes the caller poll again)."""
        c = self.chunk
        if c <= 0 or n <= 0:
            return False
        pos = (off // c) * c
        end = off + n
        while pos < end:
            if self.landed.get(pos) != min(c, self.size - pos):
                return False
            pos += c
        return True

    def read(self, off: int, n: int) -> Optional[bytes]:
        """Copy landed bytes out for partial serving (None once closed —
        the buffer is being sealed or aborted)."""
        with self._lock:
            if self.closed or self._buf is None:
                return None
            return bytes(self._buf[off : off + n])

    def close(self):
        """Stop accepting writes and drop the buffer reference (called
        before seal/abort; blocks on any in-flight chunk write)."""
        with self._lock:
            self.closed = True
            self._buf = None


class _PeerEntry:
    __slots__ = ("conn", "users")

    def __init__(self, conn):
        self.conn = conn
        self.users = 0


class PeerConnectionPool:
    """Pooled persistent connections to peer raylets for the object
    plane (parity: the reference ObjectManager's connection pool,
    object_manager.h:117) — replaces per-fetch open/close. One
    multiplexed connection per peer address; transport errors discard
    the entry so the next acquire re-dials."""

    def __init__(self, name: str = "raylet-pull"):
        self.name = name
        self._conns: Dict[str, _PeerEntry] = {}
        self._dials: Dict[str, asyncio.Future] = {}

    async def acquire(self, addr: str):
        while True:
            ent = self._conns.get(addr)
            if ent is not None and not ent.conn.closed:
                ent.users += 1
                return ent.conn
            fut = self._dials.get(addr)
            if fut is None:
                # Single-flight dial, published as a future rather than
                # guarded by a per-addr lock: under injected partitions
                # the connect can stall for its full timeout, and a lock
                # held across that await would serialize every other
                # awaiter behind one faulted link (raylint R8).
                fut = asyncio.get_running_loop().create_future()
                self._dials[addr] = fut
                try:
                    conn = await self._dial(addr)
                    ent = _PeerEntry(conn)
                    ent.users = 1
                    self._conns[addr] = ent
                    conn.add_close_callback(
                        lambda c, a=addr: self._on_conn_close(a, c)
                    )
                except BaseException as e:
                    fut.set_exception(
                        e if isinstance(e, Exception)
                        else ConnectionError(f"dial to {addr} cancelled")
                    )
                    fut.exception()  # retrieved: no warning when unawaited
                    raise
                else:
                    fut.set_result(conn)
                    return conn
                finally:
                    self._dials.pop(addr, None)
            else:
                try:
                    # shield: cancelling one follower must not cancel the
                    # shared dial the leader still owns
                    await asyncio.shield(fut)
                except Exception:
                    continue  # leader's dial failed; retry / become leader
                # leader installed the entry; retake the fast path

    def release(self, addr: str, conn, discard: bool = False):
        ent = self._conns.get(addr)
        if ent is not None and ent.conn is conn:
            ent.users = max(0, ent.users - 1)
            if discard:
                self._conns.pop(addr, None)
        if discard:
            try:
                conn._do_close()
            except Exception:
                pass

    def _on_conn_close(self, addr: str, conn):
        ent = self._conns.get(addr)
        if ent is not None and ent.conn is conn:
            self._conns.pop(addr, None)

    async def _dial(self, addr: str):
        from ray_tpu_torch._private import conduit

        # Per-dial nonce in the link name: each (re)connection is a NEW
        # chaos link with its own deterministic fault schedule — without
        # it, a seed whose schedule drops frame 0 of "raylet-pull|addr"
        # would drop the first frame of EVERY re-dialed conn, turning a
        # probabilistic fault into a permanent one.
        name = f"{self.name}#{os.urandom(2).hex()}"
        # conduit.available() may compile the C++ shim on first call —
        # off-loop (raylint R7); cached thereafter
        if GLOBAL_CONFIG.native_wire and await asyncio.to_thread(
            conduit.available
        ):
            from ray_tpu_torch._private.conduit_rpc import connect_conduit

            conn = await connect_conduit(addr, name=name)
        else:
            conn = await rpc.connect_async(addr, timeout=10, name=name)
        # chaos-plane link identity: lets fault rules target the pull
        # link of ONE peer ("raylet-pull|<addr>") or all of them
        conn.chaos_peer = addr
        return conn

    def stats(self) -> Dict[str, int]:
        live = [e for e in self._conns.values() if not e.conn.closed]
        return {"open": len(live), "in_use": sum(e.users for e in live)}

    def close_all(self):
        for ent in list(self._conns.values()):
            try:
                ent.conn._do_close()
            except Exception:
                pass
        self._conns.clear()


class WorkerHandle:
    def __init__(self, worker_id: bytes, proc: Optional[subprocess.Popen]):
        self.worker_id = worker_id
        self.proc = proc
        self.conn: Optional[rpc.Connection] = None  # registration connection
        self.addr: str = ""  # worker's own RPC server address
        self.lease_id: Optional[bytes] = None
        self.actor_id: Optional[bytes] = None
        # the card indices this worker was started with (its
        # CUDA_VISIBLE_DEVICES); () = a worker for leases without GPU
        self.cards: Tuple[int, ...] = ()
        self.registered = asyncio.Event()

    @property
    def alive(self) -> bool:
        if self.proc is not None and self.proc.poll() is not None:
            return False
        return self.conn is not None and not self.conn.closed


class Lease:
    def __init__(self, lease_id: bytes, worker: WorkerHandle, resources: Dict,
                 owner_conn=None, alloc=None):
        self.lease_id = lease_id
        self.worker = worker
        self.resources = resources
        self.owner_conn = owner_conn  # requesting conn; reclaim on its death
        # Where the resources were charged: ("node",) or ("bundle", pg_id, idx)
        self.alloc = alloc or ("node",)
        self.granted_at = time.monotonic()
        self.card_shares: Dict[int, float] = {}  # card index -> GPU share


class Raylet:
    def __init__(
        self,
        node_id: bytes,
        sock_path: str,  # scheme address (unix:<path> or tcp:<host>:<port>)
        store_path: str,
        gcs_addr: str,
        resources: Dict[str, float],
        session_dir: str,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.node_id = node_id
        self.sock_path = sock_path
        self.store_path = store_path
        # gcs_addr may be a comma-separated endpoint list (primary +
        # warm standby): the raylet cycles it on reconnect, so after a
        # failover the same loop that handles a GCS restart lands on
        # the promoted standby. Kept as the raw multi-string too —
        # spawned workers inherit the full list.
        self.gcs_addr = gcs_addr
        self.gcs_addrs = [a.strip() for a in gcs_addr.split(",")
                          if a.strip()]
        self._gcs_addr_i = 0
        self._gcs_epoch: Optional[int] = None
        self.session_dir = session_dir
        self.labels = labels or {}
        self.total_resources = dict(resources)
        self.available = dict(resources)
        # One entry per card of the node's GPU total: what the card holds
        # (1; a fractional total's last card less) and the share of it no
        # lease holds.
        gpus = float(resources.get("GPU", 0.0))
        n_cards = int(math.ceil(gpus - _SHARE_EPS)) if gpus > 0 else 0
        self.card_total = [min(1.0, gpus - i) for i in range(n_cards)]
        self.card_free: List[float] = list(self.card_total)
        self.card_ids = _card_ids(n_cards)
        # Seeded under an installed chaos plane so replays reproduce
        # peer shuffles / jitter / spillback picks (raylint R4); the
        # node-id tag keeps raylets decorrelated.
        self._rng = _chaos.replay_rng("raylet|" + node_id.hex())
        from ray_tpu_torch._private.conduit_rpc import make_server

        self.server = make_server(
            sock_path, rpc.handler_table(self), name="raylet"
        )
        self.store: Optional[SharedMemoryStore] = None
        self.gcs: Optional[rpc.Connection] = None
        # workers
        self.workers: Dict[bytes, WorkerHandle] = {}
        self.idle: List[WorkerHandle] = []
        self.leases: Dict[bytes, Lease] = {}
        self.drivers: Dict[bytes, rpc.Connection] = {}
        # lease queue: (spec_summary, future, owner_conn)
        self.lease_queue: List[Tuple[Dict, asyncio.Future, Any]] = []
        # requests infeasible cluster-wide, parked until resources appear
        # (parity: reference keeps infeasible tasks queued; here bounded by a
        # grace deadline so callers get an explicit error eventually)
        self.infeasible_queue: List[Tuple[Dict, asyncio.Future, float, Any]] = []
        # conn -> lease_ids granted to it; reclaimed when the conn dies so an
        # abandoned/dead owner can't strand workers+resources (ADVICE r1)
        self._owner_leases: Dict[Any, Set[bytes]] = {}
        self.cluster_resources: Dict[str, Dict] = {}  # node hex -> view
        self.cluster_nodes: Dict[str, Dict] = {}  # node hex -> NodeInfo wire
        # Placement-group bundle reservation (2PC; parity: reference raylet
        # PG resource manager, placement_group_resource_manager.h:46):
        # prepared = reserved but revocable; committed = live bundle pools.
        self.pg_prepared: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self.pg_prepare_ttl: Dict[bytes, Any] = {}  # pg_id -> TimerHandle
        self.pg_bundle_total: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self.pg_bundle_avail: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        # Object spilling (parity: local_object_manager.h:41 +
        # external_storage.py): sealed LRU objects move to the configured
        # external storage under memory pressure and restore on demand.
        # Default target is session-local disk; on a real pod set
        # spill_storage_uri to a bucket (host disk is small/ephemeral).
        self.spill_dir = os.path.join(session_dir, "spill",
                                      node_id.hex()[:12])
        from ray_tpu_torch._private.external_storage import (
            FilesystemStorage,
            storage_from_uri,
        )

        self.spill_storage = (
            storage_from_uri(GLOBAL_CONFIG.spill_storage_uri)
            or FilesystemStorage(self.spill_dir)
        )
        self.spilled: Dict[bytes, tuple] = {}  # oid -> (storage URI, nbytes)
        self.spilled_bytes = 0
        self._spilling: Set[bytes] = set()  # oids with an in-flight spill
        self._ever_workers: Set[bytes] = set()  # for log tailing after death
        # object-plane transfer management (dependency-manager round):
        # in-flight inbound pulls (dedup) + outbound chunk pacing + pooled
        # persistent peer connections + throughput counters
        self._pulls_inflight: Dict[bytes, asyncio.Future] = {}
        self._outbound_sem = asyncio.Semaphore(
            int(GLOBAL_CONFIG.object_transfer_max_concurrent_chunks)
        )
        self._outbound_chunks = 0
        self._objects_served = 0
        self._peer_pool = PeerConnectionPool()
        # same-host fast path: attached peer store arenas by path
        self._peer_stores: Dict[str, SharedMemoryStore] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._transfer_bytes_in = 0
        self._transfer_bytes_out = 0
        self._last_pull_gbps = 0.0
        self._pull_chunks_inflight = 0
        self._pull_aborts = 0
        self._transfer_chunk_retries = 0
        # node_stats task-plane aggregation cache (monotonic ts, dict):
        # bounds the per-stats-call fan-out to the worker pool
        self._task_plane_cache: Tuple[float, Dict] = (0.0, {
            "task_inline_hits": 0, "task_inline_bytes": 0,
        })
        # node_stats mesh-group view cache (monotonic ts, dict)
        self._mesh_group_cache: Tuple[float, Dict] = (0.0, {})
        # live inbound transfers: deposit token -> _PullSink (chunk
        # frames route to their transfer by the token they carry)
        self._transfers: Dict[int, _PullSink] = {}
        # broadcast tree: oid bytes -> the in-progress pull's sink, so
        # this raylet can serve landed ranges ONWARD to child pullers
        # (partial serve); plus fan-out observability counters
        self._partial_serves: Dict[bytes, _PullSink] = {}
        self._partial_chunks_out = 0
        self._tree_pulls = 0
        self._tree_position: Optional[int] = None
        # locality-aware stripe-peer picks: pulls whose first-choice
        # source shared this node's host (or gang) label
        self._locality_pref_hits = 0
        # cumulative remote fetches that materialized a local copy
        # (contains/restore hits excluded): the data plane's re-read
        # accounting rides this — after a node death, the delta must
        # match only the LOST shards, never the whole epoch
        self._pulls_completed = 0
        # GCS read cache (r11): object-location entries enter on a
        # directory read (populate-on-miss — a first-time puller still
        # registers with the broadcast-tree registry) and are
        # updated/invalidated by the "locs" pubsub channel; cleared
        # whole on GCS reconnect (a subscription gap means missed
        # invalidations). Entry: oid -> {"locs": [node_id], "size":
        # Optional[int]} — a known-small object (< broadcast threshold)
        # can skip the pull_begin round trip entirely. The node
        # labels/table cache is ``cluster_nodes`` (pubsub-fed since r1,
        # label patches adopted since r10); its churn counts below.
        self._loc_cache: "collections.OrderedDict[bytes, Dict]" = (
            collections.OrderedDict()
        )
        self._gcs_cache_stats = {
            "loc_hits": 0, "loc_misses": 0, "loc_invalidations": 0,
            "loc_updates": 0, "node_updates": 0, "cache_resets": 0,
        }
        # live actors hosted here: actor_id -> {"spec", "address"} — replayed
        # to a restarted GCS so its actor table survives (GCS FT)
        self.hosted_actors: Dict[bytes, Dict] = {}
        self._tasks: List[asyncio.Task] = []
        self._stopping = False

    # ------------- lifecycle -------------
    async def start(self):
        self._loop = asyncio.get_running_loop()
        size = int(GLOBAL_CONFIG.object_store_memory_bytes)
        # create() may compile the native store lib on first use — off-loop
        # (raylint R7)
        self.store = await asyncio.to_thread(
            SharedMemoryStore.create, self.store_path, size
        )
        if GLOBAL_CONFIG.object_spilling_enabled:
            # full creates escalate to spill_now instead of dropping LRU data
            self.store.set_no_evict(True)
        await self.server.start_async()
        await self._register_with_gcs()
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._heartbeat_loop()))
        self._tasks.append(loop.create_task(self._memory_monitor_loop()))
        if GLOBAL_CONFIG.log_to_driver:
            self._tasks.append(loop.create_task(self._log_monitor_loop()))
        if GLOBAL_CONFIG.prestart_workers:
            n = int(self.total_resources.get("CPU", 1))
            n = min(n, max(1, (os.cpu_count() or 4)))
            for _ in range(min(n, 4)):  # cap prestart burst
                self._start_worker_process()

    async def stop(self):
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for w in self.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        self._peer_pool.close_all()
        for st in self._peer_stores.values():
            try:
                st.close()
            except Exception:
                pass
        await self.server.stop_async()
        if self.store is not None:
            self.store.close()

    async def _connect_gcs(self) -> rpc.Connection:
        """Connect to the first reachable GCS endpoint, cycling the list
        across calls. First boot is patient (the GCS may still be
        binding); reconnects use a short per-endpoint timeout so a dead
        primary costs one hop, not the whole failover budget — the
        reconnect loop's backoff provides the patience."""
        first_boot = self.gcs is None
        per_addr = 30.0 if first_boot and len(self.gcs_addrs) == 1 \
            else (10.0 if first_boot else 2.0)
        last: Optional[Exception] = None
        for _ in range(len(self.gcs_addrs)):
            addr = self.gcs_addrs[self._gcs_addr_i % len(self.gcs_addrs)]
            try:
                return await rpc.connect_async(
                    addr, rpc.handler_table(self), timeout=per_addr,
                    name="raylet->gcs",
                )
            except Exception as e:
                last = e
                self._gcs_addr_i = (self._gcs_addr_i + 1) % len(
                    self.gcs_addrs)
        raise last if last is not None else ConnectionError(
            "no GCS endpoints")

    async def _gcs_call_replayed(self, method, data, timeout=10.0,
                                 attempts=6):
        """At-least-once call on the raylet's GCS conn: one request id
        across attempts (server-side dedup applies the mutation once),
        exponential backoff + jitter between them — a chaos-dropped frame
        costs one timeout, not the registration."""
        rid = os.urandom(16)
        backoff = 0.2
        for i in range(attempts):
            try:
                # attempt timeouts grow (a dropped frame costs ~2s, not
                # the full budget); a slow handler joins via dedup
                return await self.gcs.call_async(
                    method, data, timeout=min(timeout, 2.0 * (1 << i)),
                    rid=rid,
                )
            except (asyncio.TimeoutError, ConnectionError, OSError):
                if i == attempts - 1 or self._stopping:
                    raise
                await asyncio.sleep(
                    backoff * (0.5 + self._rng.random() * 0.5)
                )
                backoff = min(backoff * 2.0, 2.0)

    async def _register_with_gcs(self):
        """Connect + register + subscribe + replay live actors; re-armed on
        connection loss so a restarted GCS (file-backed FT) gets this node
        back (parity: reference NotifyGCSRestart + raylet re-registration,
        node_manager.proto:358)."""
        self.gcs = await self._connect_gcs()
        reply = await self._gcs_call_replayed(
            "register_node",
            NodeInfo(
                node_id=self.node_id,
                raylet_addr=self.server.addr,
                store_path=self.store_path,
                resources=self.total_resources,
                labels=self.labels,
            ).to_wire(),
        )
        ep = reply.get("epoch") if isinstance(reply, dict) else None
        if ep is not None:
            if self._gcs_epoch is not None and int(ep) < self._gcs_epoch:
                # epoch fencing: this endpoint is a resurrected old
                # primary (it will fence itself shortly) — refuse it and
                # let the reconnect loop cycle to the promoted standby
                self._gcs_addr_i = (self._gcs_addr_i + 1) % len(
                    self.gcs_addrs)
                raise ConnectionError(
                    f"GCS at stale epoch {ep} < {self._gcs_epoch}; "
                    "cycling to the promoted endpoint")
            self._gcs_epoch = int(ep)
        GLOBAL_CONFIG.load(reply["config"])
        # the read caches are only coherent while subscribed: a
        # (re-)registration starts a fresh subscription epoch, so drop
        # every location entry cached under the previous one (missed
        # invalidations during the gap)
        if self._loc_cache:
            self._loc_cache.clear()
            self._gcs_cache_stats["cache_resets"] += 1
        snap = await self._gcs_call_replayed(
            "subscribe", ["nodes", "resources", "locs"]
        )
        for n in snap.get("nodes", []):
            self._on_nodes_update([n])
        self.cluster_resources = snap.get("resources") or {}
        if self.hosted_actors:
            # replay live actors into the (possibly restarted) GCS table;
            # the GCS answers with instances its table has since moved
            # past (restarted elsewhere / killed) — reap those workers
            try:
                r = await self._gcs_call_replayed(
                    "restore_actors", list(self.hosted_actors.values()),
                    timeout=30,
                )
                for aid in (r.get("stale") or []) if isinstance(r, dict) else []:
                    self._reap_stale_actor(bytes(aid))
            except Exception:
                logger.warning("actor-table replay to GCS failed")
        self.gcs.add_close_callback(self._on_gcs_conn_lost)

    async def _announce_hosted(self, hosted: List[Dict]):
        """Replay freshly created actors into the GCS serving now, as a
        re-registration does: it adopts those its journal still expects and
        answers with instances it has moved past, whose workers are reaped
        (their cards go back to the placement it started instead)."""
        try:
            r = await self._gcs_call_replayed("restore_actors", hosted,
                                              timeout=30)
            for aid in (r.get("stale") or []) if isinstance(r, dict) else []:
                self._reap_stale_actor(bytes(aid))
        except Exception:
            logger.warning("actor replay to the GCS after a failover failed")

    def _reap_stale_actor(self, actor_id: bytes):
        """The GCS re-placed (or killed) this actor while we were gone:
        our local instance is an orphan — kill its worker."""
        self.hosted_actors.pop(actor_id, None)
        for w in self.workers.values():
            if w.actor_id == actor_id:
                logger.warning("reaping stale actor instance %s",
                               actor_id.hex()[:12])
                w.actor_id = None  # suppress the death report: not news
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                break

    def _on_gcs_conn_lost(self, conn):
        if self._stopping or conn is not self.gcs:
            return  # superseded conn (a re-registration already replaced it)
        logger.warning("GCS connection lost; reconnecting...")
        rpc.spawn(self._gcs_reconnect_loop())

    async def _gcs_reconnect_loop(self):
        if getattr(self, "_gcs_reconnecting", False):
            return
        self._gcs_reconnecting = True
        backoff = 0.2
        try:
            while not self._stopping:
                try:
                    await self._register_with_gcs()
                    logger.info("re-registered with restarted GCS")
                    self._pump_infeasible()
                    return
                except Exception:
                    # exponential backoff + jitter: N raylets must not
                    # hammer a just-restarting GCS in lockstep
                    await asyncio.sleep(
                        backoff * (0.5 + self._rng.random())
                    )
                    backoff = min(backoff * 2.0, 5.0)
        finally:
            self._gcs_reconnecting = False

    # ------------- pubsub from GCS -------------
    async def rpc_publish(self, conn, data):
        channel, payload = data
        if channel == "resources":
            self.cluster_resources = payload
        elif channel == "nodes":
            self._on_nodes_update(payload)
        elif channel == "locs":
            self._on_locs_update(payload)
        return True

    def _on_locs_update(self, updates: List):
        """Explicit invalidation feed for the object-location cache: the
        GCS publishes [oid, locations|None] on exactly the directory
        mutations that stale a cached entry. Entries NOT in the cache
        are ignored (the cache populates on read, never on pubsub — a
        first-time puller must still register with the broadcast-tree
        registry instead of short-circuiting to a direct fetch)."""
        for oid, locs in updates:
            oid = bytes(oid)
            ent = self._loc_cache.get(oid)
            if ent is None:
                continue
            if locs is None:
                self._loc_cache.pop(oid, None)
                self._gcs_cache_stats["loc_invalidations"] += 1
            else:
                ent["locs"] = [bytes(l) for l in locs]
                self._gcs_cache_stats["loc_updates"] += 1

    def _loc_cache_put(self, oid: bytes, locs, size=None):
        cap = int(GLOBAL_CONFIG.raylet_loc_cache_entries)
        if cap <= 0:
            return
        ent = self._loc_cache.get(oid)
        if ent is not None:
            ent["locs"] = [bytes(l) for l in locs]
            if size is not None:
                ent["size"] = int(size)
            self._loc_cache.move_to_end(oid)
            return
        while len(self._loc_cache) >= cap:
            self._loc_cache.popitem(last=False)
        self._loc_cache[oid] = {
            "locs": [bytes(l) for l in locs],
            "size": int(size) if size is not None else None,
        }

    def _on_nodes_update(self, nodes: List[Dict]):
        self._gcs_cache_stats["node_updates"] += len(nodes)
        for n in nodes:
            nhex = bytes(n["node_id"]).hex()
            self.cluster_nodes[nhex] = n
            if nhex == self.node_id.hex():
                # adopt GCS-side label patches (update_node_labels — a
                # MeshGroup stamping gang membership) into OUR labels
                # too, or the locality picker's same-gang prong never
                # matches on the puller side
                self.labels = dict(n.get("labels") or {})
        self._pump_infeasible()

    def _pump_infeasible(self, expire: bool = False):
        """Re-evaluate parked lease requests after cluster topology changes."""
        now = time.monotonic()
        me = self.node_id.hex()
        remaining = []
        for summary, fut, deadline, conn in self.infeasible_queue:
            if fut.done():
                continue
            resources = summary.get("resources") or {}
            strategy = summary.get("strategy")
            if isinstance(strategy, (list, tuple)) and strategy and (
                strategy[0] == "affinity" and not bool(strategy[2])
            ):
                # Hard affinity: ONLY its target node can satisfy this —
                # default re-dispatch below would grant on the wrong node.
                target_hex = str(strategy[1])
                node = self.cluster_nodes.get(target_hex)
                alive = node is not None and node.get("alive", True)
                if alive and target_hex == me and self._feasible(resources):
                    self.lease_queue.append((summary, fut, conn))
                elif alive and target_hex != me:
                    fut.set_result({"spillback": node["raylet_addr"]})
                elif expire and now > deadline:
                    fut.set_result({"infeasible": True})
                else:
                    remaining.append((summary, fut, deadline, conn))
                continue
            if isinstance(strategy, (list, tuple)) and strategy and (
                strategy[0] == "labels"
            ):
                # Hard label constraints: only matching nodes qualify —
                # the generic re-dispatch below would grant anywhere.
                from ray_tpu_torch.util.scheduling_strategies import labels_match

                hard = strategy[1] or {}
                if labels_match(self.labels, hard) and self._feasible(
                    resources
                ):
                    self.lease_queue.append((summary, fut, conn))
                    continue
                match = next(
                    (n for _s, nhex, n in self._label_candidates(
                        resources, hard, strategy[2] or {}
                    ) if nhex != me),
                    None,
                )
                if match is not None:
                    fut.set_result({"spillback": match["raylet_addr"]})
                elif expire and now > deadline:
                    fut.set_result({"infeasible": True})
                else:
                    remaining.append((summary, fut, deadline, conn))
                continue
            # Local feasibility can change at runtime once placement-group
            # bundle reservation mutates total_resources.
            if self._feasible(resources):
                self.lease_queue.append((summary, fut, conn))
                continue
            target = self._pick_spillback(resources, strict=True)
            if target:
                fut.set_result({"spillback": target})
            elif expire and now > deadline:
                fut.set_result({"infeasible": True})
            else:
                remaining.append((summary, fut, deadline, conn))
        self.infeasible_queue = remaining
        self._pump_lease_queue()

    def _queued_demand(self) -> Dict[str, float]:
        """Resource totals of queued + parked lease requests — the signal
        the autoscaler scales on (parity: reference resource_load/demand in
        raylet heartbeats feeding autoscaler.py:166)."""
        demand: Dict[str, float] = {}
        for summary, fut, _conn in self.lease_queue:
            if fut.done():
                continue
            for r, q in (summary.get("resources") or {}).items():
                demand[r] = demand.get(r, 0.0) + q
        for summary, fut, _dl, _conn in self.infeasible_queue:
            if fut.done():
                continue
            for r, q in (summary.get("resources") or {}).items():
                demand[r] = demand.get(r, 0.0) + q
        return demand

    async def _heartbeat_loop(self):
        period = GLOBAL_CONFIG.health_check_period_ms / 1e3
        misses = 0
        while not self._stopping:
            try:
                reply = await self.gcs.call_async(
                    "heartbeat",
                    [
                        self.node_id,
                        {"available": self.available,
                         "total": self.total_resources,
                         "demand": self._queued_demand()},
                    ],
                    timeout=10,
                )
                misses = 0
                if isinstance(reply, dict) and reply.get("reregister"):
                    # The GCS doesn't know us (restarted, or it declared us
                    # dead during a partition/blackout): cycle the conn —
                    # its close handler runs the full re-registration
                    # (register + resubscribe + actor replay).
                    logger.warning(
                        "GCS no longer recognizes this node; re-registering"
                    )
                    self.gcs._do_close()
            except Exception:
                if self._stopping:
                    return
                # A partitioned (not dead) GCS keeps the TCP conn open
                # while answering nothing: conn-close never fires, so
                # consecutive heartbeat timeouts are the only failover
                # signal. Cycle the conn — the reconnect loop walks the
                # endpoint list and lands on the promoted standby.
                misses += 1
                if misses >= 2 and self.gcs is not None \
                        and not self.gcs.closed:
                    logger.warning(
                        "GCS unresponsive for %d heartbeats; cycling "
                        "the connection", misses)
                    misses = 0
                    self.gcs._do_close()
            self._pump_infeasible(expire=True)
            await asyncio.sleep(period)

    # ------------- worker pool -------------
    def _start_worker_process(self, cards: Tuple[int, ...] = ()
                              ) -> WorkerHandle:
        """Spawn a worker. A worker for GPU leases is started with
        CUDA_VISIBLE_DEVICES naming its cards (and RAYTPU_GPU_IDS, which
        ``get_accelerator_ids`` reads): a process cannot change cards once
        it has a CUDA context, so it serves leases on these cards only."""
        from ray_tpu_torch._private.node import clean_env

        worker_id = WorkerID.from_random().binary()
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{worker_id.hex()[:12]}.log"), "wb")
        cmd = [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.worker_main",
            "--raylet", self.server.addr,
            "--gcs", self.gcs_addr,
            "--store", self.store_path,
            "--node-id", self.node_id.hex(),
            "--worker-id", worker_id.hex(),
            "--session-dir", self.session_dir,
        ]
        env = clean_env()
        env["RAYTPU_WORKER"] = "1"
        env.pop("RAYTPU_GPU_IDS", None)
        if cards:
            ids = ",".join(self.card_ids[c] for c in cards)
            env["CUDA_VISIBLE_DEVICES"] = env["RAYTPU_GPU_IDS"] = ids
        proc = subprocess.Popen(
            cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
            start_new_session=True,
        )
        out.close()
        w = WorkerHandle(worker_id, proc)
        w.cards = tuple(cards)
        self.workers[worker_id] = w
        self._ever_workers.add(worker_id)
        return w

    async def rpc_register_worker(self, conn, data):
        """A spawned worker (or driver) announces itself."""
        worker_id, addr, is_driver = data
        if is_driver:
            self.drivers[worker_id] = conn
            conn.on_close = lambda c: self._on_driver_exit(worker_id)
            return {"store_path": self.store_path, "node_id": self.node_id,
                    "config": GLOBAL_CONFIG.dump()}
        w = self.workers.get(worker_id)
        if w is None:  # adopted worker (e.g. restarted raylet)
            w = WorkerHandle(worker_id, None)
            self.workers[worker_id] = w
        w.conn = conn
        w.addr = addr
        conn.on_close = lambda c: asyncio.get_running_loop().create_task(
            self._on_worker_exit(w)
        )
        w.registered.set()
        self.idle.append(w)
        self._pump_lease_queue()
        return {"store_path": self.store_path, "node_id": self.node_id,
                "config": GLOBAL_CONFIG.dump()}

    def _on_driver_exit(self, worker_id: bytes):
        self.drivers.pop(worker_id, None)

    async def _on_worker_exit(self, w: WorkerHandle):
        self.workers.pop(w.worker_id, None)
        if w in self.idle:
            self.idle.remove(w)
        if w.lease_id is not None and w.lease_id in self.leases:
            lease = self.leases.pop(w.lease_id)
            if lease.owner_conn is not None:
                s = self._owner_leases.get(lease.owner_conn)
                if s is not None:
                    s.discard(lease.lease_id)
            self._release_lease(lease)
        if w.actor_id is not None:
            self.hosted_actors.pop(w.actor_id, None)
        if w.actor_id is not None and not self._stopping:
            try:
                # replayed: a death report lost to a partition/blackout
                # would strand the actor as ALIVE in the GCS forever
                await self._gcs_call_replayed(
                    "report_actor_death",
                    [w.actor_id, "actor worker process died", False],
                )
            except Exception:
                pass
        if w.proc is not None and w.proc.poll() is None:
            w.proc.terminate()
        self._pump_lease_queue()

    # ------------- resources -------------
    def _can_fit(self, resources: Dict[str, float]) -> bool:
        return all(self.available.get(r, 0.0) >= q for r, q in resources.items())

    def _can_fit_with_queue(self, resources: Dict[str, float]) -> bool:
        """Would this request fit after already-queued demand is served?"""
        queued: Dict[str, float] = {}
        for summary, fut, _conn in self.lease_queue:
            if fut.done():
                continue
            for r, q in (summary.get("resources") or {}).items():
                queued[r] = queued.get(r, 0.0) + q
        return all(
            self.available.get(r, 0.0) - queued.get(r, 0.0) >= q
            for r, q in resources.items()
        )

    def _feasible(self, resources: Dict[str, float]) -> bool:
        return all(
            self.total_resources.get(r, 0.0) >= q for r, q in resources.items()
        )

    def _acquire_resources(self, resources: Dict[str, float]):
        for r, q in resources.items():
            self.available[r] = self.available.get(r, 0.0) - q

    def _release_resources(self, resources: Dict[str, float]):
        for r, q in resources.items():
            self.available[r] = min(
                self.available.get(r, 0.0) + q,
                self.total_resources.get(r, 0.0),
            )

    # ------------- placement-group bundles (2PC participant) -------------
    # Parity: reference node_manager.proto:380-388 (PrepareBundleResources /
    # CommitBundleResources / CancelResourceReserve) + the GCS-side 2PC in
    # gcs_placement_group_scheduler.h:275.

    async def rpc_prepare_bundles(self, conn, data):
        """Atomically reserve this node's share of a PG: ALL bundles in
        ``data["bundles"]`` or none. Reservation is revocable until commit
        (TTL guards against a GCS that dies between prepare and commit).
        Idempotent under coordinator retries: indices already prepared or
        committed here are not charged twice."""
        pg_id = data["pg_id"]
        bundles = {int(i): dict(res) for i, res in data["bundles"]}
        already = set(self.pg_prepared.get(pg_id, {})) | set(
            self.pg_bundle_total.get(pg_id, {})
        )
        bundles = {i: r for i, r in bundles.items() if i not in already}
        need: Dict[str, float] = {}
        for res in bundles.values():
            for r, q in res.items():
                need[r] = need.get(r, 0.0) + q
        if not self._can_fit(need):
            return {"ok": False, "error": "insufficient resources"}
        self._acquire_resources(need)
        self.pg_prepared.setdefault(pg_id, {}).update(bundles)
        old = self.pg_prepare_ttl.pop(pg_id, None)
        if old is not None:
            old.cancel()
        self.pg_prepare_ttl[pg_id] = asyncio.get_running_loop().call_later(
            30.0, self._expire_prepared, pg_id
        )
        return {"ok": True}

    def _expire_prepared(self, pg_id: bytes):
        self.pg_prepare_ttl.pop(pg_id, None)
        bundles = self.pg_prepared.pop(pg_id, None)
        if bundles:
            for res in bundles.values():
                self._release_resources(res)
            self._pump_lease_queue()

    async def rpc_commit_bundles(self, conn, pg_id: bytes):
        ttl = self.pg_prepare_ttl.pop(pg_id, None)
        if ttl is not None:
            ttl.cancel()
        bundles = self.pg_prepared.pop(pg_id, None)
        if bundles is None:
            return {"ok": False, "error": "nothing prepared"}
        self.pg_bundle_total.setdefault(pg_id, {}).update(
            {i: dict(r) for i, r in bundles.items()}
        )
        self.pg_bundle_avail.setdefault(pg_id, {}).update(
            {i: dict(r) for i, r in bundles.items()}
        )
        self._pump_lease_queue()
        return {"ok": True}

    async def rpc_cancel_bundles(self, conn, pg_id: bytes):
        self._expire_prepared(pg_id)
        return {"ok": True}

    async def rpc_release_bundles(self, conn, pg_id: bytes):
        """PG removed: kill leases running in its bundles, return capacity."""
        self._expire_prepared(pg_id)
        totals = self.pg_bundle_total.pop(pg_id, None)
        self.pg_bundle_avail.pop(pg_id, None)
        if totals is None:
            return {"ok": True}
        # Reference semantics: removing a PG kills tasks/actors inside it.
        for lease in list(self.leases.values()):
            if lease.alloc[0] == "bundle" and lease.alloc[1] == pg_id:
                w = lease.worker
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.terminate()
        # Queued lease requests against this PG would wait forever on the
        # vanished pools — fail them now with an explicit error.
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        still_queued = []
        for summary, fut, qconn in self.lease_queue:
            parsed = parse_pg_strategy(summary.get("strategy"))
            if parsed is not None and parsed[0] == pg_id and not fut.done():
                fut.set_result(
                    {"infeasible": True, "error": "placement group removed"}
                )
            else:
                still_queued.append((summary, fut, qconn))
        self.lease_queue = still_queued
        for res in totals.values():
            self._release_resources(res)
        self._pump_lease_queue()
        return {"ok": True}

    # ------------- allocation (node pool vs bundle pools) -------------

    def _bundle_can_fit(self, pg_id: bytes, idx: int,
                        resources: Dict[str, float]) -> bool:
        pool = self.pg_bundle_avail.get(pg_id, {}).get(idx)
        return pool is not None and all(
            pool.get(r, 0.0) >= q for r, q in resources.items()
        )

    def _can_acquire(self, summary: Dict) -> bool:
        """Non-mutating twin of ``_try_acquire``."""
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        resources = summary.get("resources") or {}
        parsed = parse_pg_strategy(summary.get("strategy"))
        if parsed is not None:
            pg_id, want_idx = parsed
            pools = self.pg_bundle_avail.get(pg_id, {})
            indices = [want_idx] if want_idx >= 0 else sorted(pools)
            return any(
                self._bundle_can_fit(pg_id, i, resources) for i in indices
            )
        return self._can_fit(resources)

    def _try_acquire(self, summary: Dict) -> Optional[Tuple]:
        """Charge the request against the node pool, or — for PG-strategy
        requests — against one of this node's committed bundle pools.
        Returns the alloc tag, or None if it cannot be satisfied now."""
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        resources = summary.get("resources") or {}
        parsed = parse_pg_strategy(summary.get("strategy"))
        if parsed is not None:
            pg_id, want_idx = parsed
            pools = self.pg_bundle_avail.get(pg_id, {})
            indices = [want_idx] if want_idx >= 0 else sorted(pools)
            for i in indices:
                if self._bundle_can_fit(pg_id, i, resources):
                    pool = pools[i]
                    for r, q in resources.items():
                        pool[r] = pool.get(r, 0.0) - q
                    return ("bundle", pg_id, i)
            return None
        if not self._can_fit(resources):
            return None
        self._acquire_resources(resources)
        return ("node",)

    def _release_lease(self, lease: "Lease"):
        """Give back what a lease held: its resources and its cards."""
        self._release_alloc(lease.alloc, lease.resources)
        for c, share in lease.card_shares.items():
            self.card_free[c] = min(self.card_free[c] + share,
                                    self.card_total[c])
        lease.card_shares = {}

    def _release_alloc(self, alloc: Tuple, resources: Dict[str, float]):
        if alloc[0] == "bundle":
            _, pg_id, idx = alloc
            total = self.pg_bundle_total.get(pg_id, {}).get(idx)
            pool = self.pg_bundle_avail.get(pg_id, {}).get(idx)
            if pool is None or total is None:
                return  # bundle released while lease ran; capacity returned
            for r, q in resources.items():
                pool[r] = min(pool.get(r, 0.0) + q, total.get(r, 0.0))
        else:
            self._release_resources(resources)

    # ------------- lease protocol -------------
    def _label_candidates(self, resources: Dict, hard: Dict, soft: Dict):
        """Alive, hard-label-matching nodes whose TOTAL resources cover
        the request (an undersized match would ping-pong spillbacks),
        soft matches first."""
        from ray_tpu_torch.util.scheduling_strategies import labels_match

        cands = []
        for nhex, node in self.cluster_nodes.items():
            if not node.get("alive", True):
                continue
            labels = node.get("labels") or {}
            if not labels_match(labels, hard):
                continue
            total = (self.cluster_resources.get(nhex) or {}).get(
                "total", node.get("resources") or {}
            )
            if not all(total.get(r, 0.0) >= q
                       for r, q in resources.items()):
                continue
            cands.append((labels_match(labels, soft), nhex, node))
        cands.sort(key=lambda c: (not c[0],))
        return cands

    async def rpc_request_worker_lease(self, conn, summary: Dict):
        """Grant a worker lease, queue, or spill to another node.

        Reply: {"granted": .., "worker": Address wire, "lease_id": ..}
           or  {"spillback": raylet_addr}
           or  {"infeasible": True}

        ``strategy`` (parity: util/scheduling_strategies.py consulted by the
        reference scheduling policies, hybrid/spread/node-affinity):
          None/"DEFAULT"          hybrid pack-then-spread (below)
          "SPREAD"                least-utilized feasible node
          ["affinity", hex, soft] pin to one node (soft falls back)
        ``hops`` > 0 marks a spilled-back request: grant locally if feasible
        rather than re-spilling (prevents ping-pong between disagreeing
        resource views).
        """
        resources = summary.get("resources") or {}
        strategy = summary.get("strategy")
        hops = int(summary.get("hops") or 0)
        me = self.node_id.hex()

        if isinstance(strategy, (list, tuple)) and strategy and strategy[0] == "pg":
            return await self._lease_for_pg(summary, conn)

        if isinstance(strategy, (list, tuple)) and strategy and strategy[0] == "affinity":
            target_hex, soft = str(strategy[1]), bool(strategy[2])
            target = self.cluster_nodes.get(target_hex)
            alive = target is not None and target.get("alive", True)
            if target_hex != me:
                if alive and (not soft or hops == 0):
                    # soft + hops>0 means the TARGET already declined us
                    # (saturated): serve as default traffic here instead
                    # of ping-ponging back
                    return {"spillback": target["raylet_addr"]}
                if not alive and not soft:
                    # Hard affinity to a missing node: park (it may rejoin),
                    # expire to an explicit infeasible error.
                    fut = asyncio.get_running_loop().create_future()
                    grace = GLOBAL_CONFIG.infeasible_task_grace_s
                    self.infeasible_queue.append(
                        (summary, fut, time.monotonic() + grace, conn)
                    )
                    self._watch_owner(conn)
                    return await fut
                # soft: fall through to default placement
            else:
                if self._feasible(resources):
                    if not soft or self._can_fit_with_queue(resources):
                        fut = asyncio.get_running_loop().create_future()
                        self.lease_queue.append((summary, fut, conn))
                        self._watch_owner(conn)
                        self._pump_lease_queue()
                        return await fut
                    # SOFT affinity to a feasible-but-saturated node
                    # (r12): queue — transient saturation (another data
                    # task finishing in a few ms) must keep locality —
                    # but with a SPILL DEADLINE: if still ungranted
                    # after soft_affinity_spill_after_s, move to an idle
                    # peer. Unbounded queueing here deadlocks outright
                    # when the pinned host's slots are held by
                    # long-lived actors that WAIT on this task's output
                    # (the data plane's consumers do exactly that). The
                    # spilled request carries hops>0, so the peer serves
                    # it as default traffic instead of bouncing it back.
                    loop = asyncio.get_running_loop()
                    fut = loop.create_future()
                    entry = (summary, fut, conn)
                    self.lease_queue.append(entry)
                    self._watch_owner(conn)
                    self._pump_lease_queue()

                    def _spill_if_stuck():
                        if fut.done() or entry not in self.lease_queue:
                            return  # granted / mid-grant: leave it be
                        spill = self._pick_spillback(resources,
                                                     strict=False)
                        if spill:
                            # remove only once a target exists: a
                            # remove/re-append round trip would send the
                            # entry to the FIFO tail each interval and
                            # starve it behind newer leases
                            try:
                                self.lease_queue.remove(entry)
                            except ValueError:
                                return
                            fut.set_result({"spillback": spill})
                            return
                        # nowhere better: keep waiting IN PLACE, re-check
                        self._pump_lease_queue()
                        loop.call_later(
                            GLOBAL_CONFIG.soft_affinity_spill_after_s,
                            _spill_if_stuck,
                        )

                    loop.call_later(
                        GLOBAL_CONFIG.soft_affinity_spill_after_s,
                        _spill_if_stuck,
                    )
                    return await fut
                if not soft:
                    fut = asyncio.get_running_loop().create_future()
                    grace = GLOBAL_CONFIG.infeasible_task_grace_s
                    self.infeasible_queue.append(
                        (summary, fut, time.monotonic() + grace, conn)
                    )
                    self._watch_owner(conn)
                    return await fut
                # soft: fall through

        if isinstance(strategy, (list, tuple)) and strategy and (
            strategy[0] == "labels"
        ):
            hard = strategy[1] or {}
            soft = strategy[2] or {}
            cands = self._label_candidates(resources, hard, soft)
            my_labels = self.labels
            from ray_tpu_torch.util.scheduling_strategies import labels_match

            me_hard = labels_match(my_labels, hard)
            me_soft = me_hard and labels_match(my_labels, soft)
            if me_hard and self._feasible(resources) and (
                hops > 0  # spilled here: grant, don't ping-pong
                or me_soft or not any(s for s, _h, _n in cands)
            ):
                fut = asyncio.get_running_loop().create_future()
                self.lease_queue.append((summary, fut, conn))
                self._watch_owner(conn)
                self._pump_lease_queue()
                return await fut
            for _soft_ok, nhex, node in cands:
                if nhex != me:
                    return {"spillback": node["raylet_addr"]}
            # no FEASIBLE matching node anywhere: park until one appears,
            # expire to an explicit infeasible error
            fut = asyncio.get_running_loop().create_future()
            grace = GLOBAL_CONFIG.infeasible_task_grace_s
            self.infeasible_queue.append(
                (summary, fut, time.monotonic() + grace, conn)
            )
            self._watch_owner(conn)
            return await fut

        if strategy == "SPREAD" and hops == 0:
            target = self._pick_spread_target(resources)
            if target is not None and target != me:
                node = self.cluster_nodes.get(target)
                if node and node.get("alive", True):
                    return {"spillback": node["raylet_addr"]}

        if not self._feasible(resources):
            target = self._pick_spillback(resources, strict=True)
            if target:
                return {"spillback": target}
            # Not feasible anywhere (yet): park until a node (re)appears.
            fut = asyncio.get_running_loop().create_future()
            grace = GLOBAL_CONFIG.infeasible_task_grace_s
            self.infeasible_queue.append(
                (summary, fut, time.monotonic() + grace, conn)
            )
            self._watch_owner(conn)
            return await fut
        if hops == 0 and not self._can_fit_with_queue(resources):
            # Local node is (or will be, counting queued demand) saturated:
            # prefer an idle peer (hybrid pack-then-spread policy, parity:
            # reference hybrid_scheduling_policy.h:50).
            target = self._pick_spillback(resources, strict=False)
            if target:
                return {"spillback": target}
        fut = asyncio.get_running_loop().create_future()
        self.lease_queue.append((summary, fut, conn))
        self._watch_owner(conn)
        self._pump_lease_queue()
        return await fut

    async def _lease_for_pg(self, summary: Dict, conn):
        """Lease inside a placement-group bundle: serve locally when this
        node holds a fitting committed bundle, else route to the node the GCS
        assigned the bundle to. Parity: PlacementGroupSchedulingStrategy
        consulting bundle locations (reference bundle_scheduling_policy.h:31).
        """
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        pg_id, want_idx = parse_pg_strategy(summary["strategy"])
        resources = summary.get("resources") or {}
        deadline = time.monotonic() + GLOBAL_CONFIG.infeasible_task_grace_s

        def fits(spec: Dict[str, float]) -> bool:
            return all(spec.get(r, 0.0) >= q for r, q in resources.items())

        while True:
            # Local fast path: a committed bundle here can (eventually) serve
            # the request — queue locally. (For -1 this prefers the local
            # bundle even if a remote one is currently freer.)
            totals = self.pg_bundle_total.get(pg_id, {})
            local_ok = [
                i for i in ([want_idx] if want_idx >= 0 else sorted(totals))
                if i in totals and fits(totals[i])
            ]
            if local_ok:
                fut = asyncio.get_running_loop().create_future()
                self.lease_queue.append((summary, fut, conn))
                self._watch_owner(conn)
                self._pump_lease_queue()
                return await fut
            try:
                rec = await self.gcs.call_async(
                    "get_placement_group", pg_id, timeout=10
                )
            except Exception:
                rec = None
            if rec is None or rec.get("state") == "REMOVED":
                return {"infeasible": True, "error": "placement group removed"}
            # Capacity is judged against the PG's declared bundle specs
            # cluster-wide, not just bundles committed on this node.
            bundles = rec.get("bundles") or []
            cand_idx = (
                [want_idx] if want_idx >= 0 else list(range(len(bundles)))
            )
            fitting = [
                i for i in cand_idx if i < len(bundles) and fits(bundles[i])
            ]
            if not fitting:
                return {"infeasible": True,
                        "error": "request exceeds bundle capacity"}
            if rec.get("state") == "CREATED":
                assignment = rec.get("assignment") or []
                cands = [
                    bytes(assignment[i])
                    for i in fitting
                    if i < len(assignment) and assignment[i] is not None
                ]
                remote = [c for c in cands if c != self.node_id]
                if remote and self.node_id not in cands:
                    target = self._rng.choice(remote)
                    node = self.cluster_nodes.get(target.hex())
                    if node and node.get("alive", True):
                        return {"spillback": node["raylet_addr"]}
                # a fitting bundle is assigned here but not committed yet:
                # brief wait below
            if time.monotonic() > deadline:
                return {"infeasible": True,
                        "error": "placement group never became ready"}
            await asyncio.sleep(0.2)

    def _watch_owner(self, conn):
        """Ensure an owner conn has a close handler reclaiming its leases and
        cancelling its queued lease requests."""
        if conn is None or conn in self._owner_leases:
            return
        self._owner_leases[conn] = set()
        conn.add_close_callback(self._on_owner_conn_close)

    def _on_owner_conn_close(self, conn):
        lease_ids = self._owner_leases.pop(conn, set())
        for lid in lease_ids:
            lease = self.leases.pop(lid, None)
            if lease is None:
                continue
            self._release_lease(lease)
            w = lease.worker
            w.lease_id = None
            # The owner died mid-lease: the worker may be running a task whose
            # owner no longer exists — kill it (pool replenishes).
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        for _, fut, c in self.lease_queue:
            if c is conn and not fut.done():
                fut.cancel()
        remaining = []
        for it in self.infeasible_queue:
            if it[3] is conn:
                it[1].cancel()
            else:
                remaining.append(it)
        self.infeasible_queue = remaining
        self._pump_lease_queue()

    def _pick_spillback(self, resources: Dict, strict: bool) -> Optional[str]:
        """Pick another node with available (or feasible-total) capacity.

        Strict (feasibility) checks use the *static* per-node totals from the
        node table — present from registration, so a task submitted right
        after a node joins is never declared infeasible while the first
        heartbeat-gossiped resource view is still in flight.
        """
        me = self.node_id.hex()
        for nid_hex, node in self.cluster_nodes.items():
            if nid_hex == me or not node.get("alive", True):
                continue
            if strict:
                pool = node.get("resources") or {}
            else:
                view = self.cluster_resources.get(nid_hex)
                if view is None:
                    continue
                pool = view.get("available", {})
            if all(pool.get(r, 0.0) >= q for r, q in resources.items()):
                return node["raylet_addr"]
        return None

    def _pick_spread_target(self, resources: Dict) -> Optional[str]:
        """Least-utilized node (by fraction of CPU available) that can fit
        the request now — parity: reference spread_scheduling_policy.h:27."""
        best, best_score = None, -1.0
        for nid_hex, node in self.cluster_nodes.items():
            if not node.get("alive", True):
                continue
            if nid_hex == self.node_id.hex():
                avail, total = self.available, self.total_resources
            else:
                view = self.cluster_resources.get(nid_hex)
                if view is None:
                    continue
                avail, total = view.get("available", {}), view.get("total", {})
            if not all(avail.get(r, 0.0) >= q for r, q in resources.items()):
                continue
            cap = total.get("CPU", 0.0)
            score = (avail.get("CPU", 0.0) / cap) if cap else 0.0
            if score > best_score:
                best, best_score = nid_hex, score
        return best

    def _pump_lease_queue(self):
        if self._stopping:
            return
        remaining = []
        # Workers are fungible per kind, a kind being the card set a
        # worker was started on (() for leases without GPU): once one
        # grantable CPU entry fails for lack of an idle worker, every
        # later CPU entry fails too — skip them wholesale so the pump
        # is O(grants), not O(queue), per call (a 100k-deep queue would
        # otherwise make each task completion scan the whole queue).
        # A GPU entry picks its cards first; the shares this pump has
        # granted or promised to a worker on its way are taken from
        # ``planned``, so waiting entries spread over the free cards.
        kind_deficit: Dict[Tuple[int, ...], int] = {}
        planned = list(self.card_free)
        for summary, fut, conn in self.lease_queue:
            if fut.done():
                continue
            resources = summary.get("resources") or {}
            gpus = float(resources.get("GPU", 0.0))
            if gpus <= 0 and () in kind_deficit:
                remaining.append((summary, fut, conn))
                kind_deficit[()] += 1
                continue
            if not self._can_acquire(summary):
                remaining.append((summary, fut, conn))
                continue
            shares: Dict[int, float] = {}
            if gpus > 0:
                shares = self._pick_cards(gpus, planned)
                if shares is None:  # the free shares lie on other cards
                    remaining.append((summary, fut, conn))
                    continue
            kind = tuple(sorted(shares))
            w = self._pop_idle_worker(kind)
            if w is None:
                remaining.append((summary, fut, conn))
                kind_deficit[kind] = kind_deficit.get(kind, 0) + 1
                for c, share in shares.items():
                    planned[c] -= share
                continue
            alloc = self._try_acquire(summary)
            if alloc is None:  # e.g. bundle pool exhausted while queued
                self.idle.append(w)
                remaining.append((summary, fut, conn))
                continue
            for c, share in shares.items():
                planned[c] -= share
                self.card_free[c] -= share
            lease_id = os.urandom(16)
            w.lease_id = lease_id
            lease = Lease(lease_id, w, resources, owner_conn=conn,
                          alloc=alloc)
            lease.card_shares = shares
            self.leases[lease_id] = lease
            if conn is not None:
                self._owner_leases.setdefault(conn, set()).add(lease_id)
            fut.set_result(
                {
                    "granted": True,
                    "worker": [w.worker_id, w.addr, self.node_id],
                    "lease_id": lease_id,
                }
            )
        self.lease_queue = remaining
        # Spawn toward the deficit ONCE per pump, outside the scan (the
        # scan itself stays O(grants)): one spawn call per unsatisfied
        # entry up to a small bound — _maybe_spawn_worker enforces the
        # real CPU-slot cap internally. Without this, a mass worker death
        # (chaos kills) respawned only one worker per pump and the pool
        # never recovered ahead of the killer.
        for kind, n in kind_deficit.items():
            for _ in range(min(n, 32)):
                self._maybe_spawn_worker(kind, deficit=n)

    def _pick_cards(self, gpus: float,
                    free: List[float]) -> Optional[Dict[int, float]]:
        """The cards a GPU lease takes, as {card: share}: the card set of
        an idle worker if one fits (no spawn), else that of a worker on
        its way, else fresh cards; None while no cards hold the share."""
        sets = [w.cards for w in reversed(self.idle)
                if w.cards and w.alive]
        sets += [w.cards for w in self.workers.values()
                 if w.cards and not w.registered.is_set()]
        for cards in dict.fromkeys(sets):
            shares = _shares_on(cards, gpus, free)
            if shares is not None:
                return shares
        cards = _fresh_cards(gpus, free)
        return None if cards is None else _shares_on(cards, gpus, free)

    def _pop_idle_worker(self, cards: Tuple[int, ...] = ()
                         ) -> Optional[WorkerHandle]:
        for i in range(len(self.idle) - 1, -1, -1):
            w = self.idle[i]
            if not w.alive:
                self.idle.pop(i)
            elif w.cards == cards:
                self.idle.pop(i)
                return w
        return None

    def _maybe_spawn_worker(self, cards: Tuple[int, ...] = (),
                            deficit: int = 1 << 30):
        # One pending spawn per queued request, bounded by CPU slots — but
        # the cap governs TASK-serving workers only: actors hold dedicated
        # workers for life (reference semantics) and are admission-limited
        # by resources, so counting them here would deadlock actor creation
        # once `cap` actors exist.
        # Count only the REQUESTED kind (its card set, () for CPU): idle
        # workers of another kind must not starve this request (they
        # can't serve it — _pop_idle_worker is kind-matched).
        # A worker that died before announcing (spawn crash, OOM kill) must
        # not count as "starting" forever — purge it so the pool respawns.
        dead_boot = [
            wid for wid, w in self.workers.items()
            if not w.registered.is_set() and w.proc is not None
            and w.proc.poll() is not None
        ]
        for wid in dead_boot:
            self.workers.pop(wid, None)
        starting = sum(
            1 for w in self.workers.values()
            if not w.registered.is_set() and w.cards == cards
        )
        # Workers already booting will serve the queue when they announce:
        # spawning past the unsatisfied-queue depth just makes N python
        # interpreters contend for the same cores during startup (worst on
        # small hosts, where it doubles time-to-first-task).
        if starting >= deficit:
            return
        busy_tasks = sum(
            1 for lease in self.leases.values()
            if lease.worker.actor_id is None and lease.worker.cards == cards
        )
        idle_kind = sum(1 for w in self.idle if w.cards == cards)
        cap = max(int(self.total_resources.get("CPU", 1)), 1) + 2
        if starting + busy_tasks + idle_kind < cap:
            self._start_worker_process(cards)

    async def rpc_return_worker(self, conn, data):
        lease_id, reusable = data
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return False
        if lease.owner_conn is not None:
            s = self._owner_leases.get(lease.owner_conn)
            if s is not None:
                s.discard(lease_id)
        self._release_lease(lease)
        w = lease.worker
        w.lease_id = None
        if reusable and w.alive and w.actor_id is None:
            self.idle.append(w)
        elif w.proc is not None and w.proc.poll() is None:
            w.proc.terminate()
        self._pump_lease_queue()
        return True

    # ------------- actors -------------
    async def rpc_create_actor(self, conn, spec: Dict):
        """Called by the GCS: dedicate a worker and run the creation task."""
        resources = spec.get("resources") or {}
        strategy = spec.get("scheduling_strategy")
        is_pg = isinstance(strategy, (list, tuple)) and strategy and (
            strategy[0] == "pg"
        )
        if is_pg:
            if not self._can_acquire(
                {"resources": resources, "strategy": strategy}
            ):
                # retryable=True: a structured "busy, try again" signal — the
                # GCS keys its retry-forever path off this flag, never off
                # the error text (which is free to change).
                return {
                    "ok": False,
                    "error": "bundle not on this node / full",
                    "retryable": True,
                }
        elif not self._feasible(resources):
            return {"ok": False, "error": "infeasible on this node"}
        fut = asyncio.get_running_loop().create_future()
        summary = {"resources": resources}
        if is_pg:
            summary["strategy"] = strategy
        self.lease_queue.append((summary, fut, None))
        self._pump_lease_queue()
        try:
            grant = await asyncio.wait_for(fut, timeout=90)
        except asyncio.TimeoutError:
            # wait_for can cancel this coroutine in the same loop tick the
            # grant landed: the done future then holds a live lease (worker +
            # resources acquired) that must be released, not leaked.
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                # raylint: disable=R1 — asyncio future, done()-guarded above
                stale = self.leases.pop(fut.result()["lease_id"], None)
                if stale is not None:
                    self._release_lease(stale)
                    lw = stale.worker
                    lw.lease_id = None
                    if lw.alive:
                        self.idle.append(lw)
                    self._pump_lease_queue()
            return {
                "ok": False,
                "error": "no worker available",
                "retryable": True,
            }
        lease_id = grant["lease_id"]

        def release(kill_worker: bool):
            # Failed creation must not strand the lease (resources + worker).
            lease = self.leases.pop(lease_id, None)
            if lease is None:
                return
            self._release_lease(lease)
            lw = lease.worker
            lw.lease_id = None
            lw.actor_id = None
            if kill_worker and lw.proc is not None and lw.proc.poll() is None:
                lw.proc.terminate()
            elif not kill_worker and lw.alive:
                self.idle.append(lw)
            self._pump_lease_queue()

        w = self.workers.get(grant["worker"][0])
        if w is None or not w.alive:
            release(kill_worker=True)
            return {"ok": False, "error": "worker died during creation"}
        w.actor_id = spec["actor_id"]
        try:
            reply = await w.conn.call_async("create_actor_instance", spec,
                                            timeout=300)
        except Exception as e:
            release(kill_worker=True)
            return {"ok": False, "error": f"creation task failed: {e}"}
        if not reply.get("ok"):
            # user __init__ raised: deterministic failure, don't re-place
            release(kill_worker=False)
            return {"ok": False, "fatal": True,
                    "error": reply.get("error", "creation failed")}
        # the cards the actor's worker holds, by id (its
        # CUDA_VISIBLE_DEVICES): the state API shows them beside the
        # actor's GPU share
        acc = ({"GPU": [self.card_ids[c] for c in w.cards]} if w.cards
               else {})
        # retain the spec so a restarted GCS can rebuild its actor table
        # from this node's live actors (GCS FT)
        hosted = {
            "spec": spec,
            "address": [w.worker_id, w.addr, self.node_id],
            "accelerator_ids": acc,
        }
        self.hosted_actors[spec["actor_id"]] = hosted
        if conn.closed:
            # the GCS that asked died while the actor was created (a
            # failover): this reply is lost with it, and a re-registration
            # that ran meanwhile did not list the actor yet
            rpc.spawn(self._announce_hosted([hosted]))
        return {"ok": True, "address": [w.worker_id, w.addr, self.node_id],
                "accelerator_ids": acc}

    async def rpc_kill_worker(self, conn, data):
        worker_id, _actor_id = data
        w = self.workers.get(worker_id)
        if w is None:
            return False
        if w.proc is not None and w.proc.poll() is None:
            w.proc.kill()
        return True

    # ------------- log monitor (log_to_driver) -------------
    # Parity: reference log monitor tailing worker logs to the driver
    # (services.py:971). Tails THIS raylet's worker log files and forwards
    # new lines through the GCS "logs" pubsub channel.

    def _scan_worker_logs(self, log_dir: str, offsets: Dict[str, int],
                          ever_hex: Set[str]) -> List[Dict]:
        """One directory scan + tail read per monitor tick. Runs in a
        thread (asyncio.to_thread): listdir/getsize/read are real disk
        I/O and a slow/contended disk must not stall the event loop that
        serves heartbeats and pulls (raylint R1). ``ever_hex`` is a
        loop-side snapshot of self._ever_workers — the live set mutates
        on the event loop while this thread iterates."""
        my_workers_prefix = "worker-"
        batch: List[Dict] = []
        if not os.path.isdir(log_dir):
            return batch
        for fname in os.listdir(log_dir):
            if not fname.startswith(my_workers_prefix):
                continue
            wid_hex = fname[len(my_workers_prefix):-4]
            # tail workers that EVER belonged to this raylet (a dead
            # worker's final traceback is the most diagnostic output)
            if not any(h.startswith(wid_hex) for h in ever_hex):
                continue
            path = os.path.join(log_dir, fname)
            size = os.path.getsize(path)
            off = offsets.get(path, 0)
            if size <= off:
                continue
            with open(path, "rb") as f:
                f.seek(off)
                data = f.read(min(size - off, 256 * 1024))
            offsets[path] = off + len(data)
            lines = data.decode(errors="replace").splitlines()
            if lines:
                batch.append(
                    {"worker": wid_hex,
                     "node": self.node_id.hex()[:12],
                     "lines": lines}
                )
        return batch

    async def _log_monitor_loop(self):
        offsets: Dict[str, int] = {}
        log_dir = os.path.join(self.session_dir, "logs")
        while not self._stopping:
            await asyncio.sleep(0.5)
            try:
                ever_hex = {w.hex() for w in self._ever_workers}
                batch = await asyncio.to_thread(
                    self._scan_worker_logs, log_dir, offsets, ever_hex
                )
                if batch and self.gcs and not self.gcs.closed:
                    await self.gcs.call_async("publish_logs", batch,
                                              timeout=10)
            except Exception:
                pass  # log forwarding is best-effort

    # ------------- memory monitor: spilling + OOM -------------
    # Parity: reference MemoryMonitor (memory_monitor.h:52) + LocalObjectManager
    # spilling (local_object_manager.h:41) + worker-killing policy
    # (worker_killing_policy_retriable_fifo.h).

    def _host_memory_fraction(self) -> float:
        fake_file = os.environ.get("RAYTPU_FAKE_MEM_USAGE_FILE")
        if fake_file:  # fault-injection hook (reference chaos-test style):
            try:  # the file's content is the fake usage fraction
                with open(fake_file) as f:
                    return float(f.read().strip() or 0.0)
            except OSError:
                return 0.0
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0])
            avail = info.get("MemAvailable", info.get("MemFree", 0))
            total = info.get("MemTotal", 1)
            return 1.0 - avail / total
        except Exception:
            return 0.0

    async def _memory_monitor_loop(self):
        period = GLOBAL_CONFIG.memory_monitor_refresh_ms / 1e3
        while not self._stopping:
            await asyncio.sleep(period)
            try:
                if GLOBAL_CONFIG.object_spilling_enabled:
                    await self._maybe_spill()
                self._maybe_kill_for_oom()
            except Exception:
                logger.exception("memory monitor iteration failed")

    async def _maybe_spill(self):
        st = self.store.stats()
        if not st["arena_size"]:
            return
        threshold = GLOBAL_CONFIG.object_spilling_threshold
        usage = st["bytes_allocated"] / st["arena_size"]
        if usage <= threshold:
            return
        target = threshold * 0.9 * st["arena_size"]
        for oid in self.store.evictable(max_n=256):
            if st["bytes_allocated"] <= target:
                break
            spilled = await self._spill_object(oid)
            if spilled:
                st = self.store.stats()

    async def _spill_object(self, oid) -> bool:
        # Concurrent spillers (memory monitor + spill_now callers) may pick
        # the same candidate: one wins, the rest skip.
        if oid.binary() in self._spilling or oid.binary() in self.spilled:
            return False
        self._spilling.add(oid.binary())
        try:
            view = self.store.get(oid, timeout=0)
            if view is None:
                return False
            loop = asyncio.get_running_loop()
            nbytes = len(view)
            try:
                # storage I/O off the event loop (heartbeats keep flowing
                # during big spills)
                uri = await loop.run_in_executor(
                    None, self.spill_storage.put, oid.hex(), view
                )
            finally:
                view.release()
                self.store.release(oid)
            self.spilled[oid.binary()] = (uri, nbytes)
            self.spilled_bytes += nbytes
            self.store.delete(oid)  # refcount-safe: deferred if pinned
            logger.info("spilled %s -> %s (%d bytes external)",
                        oid.hex()[:12], uri[:60], self.spilled_bytes)
            return True
        finally:
            self._spilling.discard(oid.binary())

    async def _restore_object(self, oid) -> bool:
        """Bring a spilled object back into the store (get-path demand)."""
        entry = self.spilled.get(oid.binary())
        if entry is None:
            return False
        uri, _ = entry
        loop = asyncio.get_running_loop()
        try:
            data = await loop.run_in_executor(
                None, self.spill_storage.get, uri
            )
        except FileNotFoundError:
            gone = self.spilled.pop(oid.binary(), None)
            if gone is not None:
                self.spilled_bytes = max(0, self.spilled_bytes - gone[1])
            # The spill file is gone (operator wiped the spill dir, or the
            # bucket expired it): this node no longer holds a copy, so
            # retract it from the GCS object directory — otherwise pullers
            # keep targeting a location that can never serve, masking the
            # true ObjectLost until every other copy is also gone.
            try:
                await self.gcs.call_async(
                    "remove_object_location", [oid.binary(), self.node_id]
                )
            except Exception:
                logger.warning("location retraction for %s failed",
                               oid.hex()[:12])
            return False
        buf = await self._create_local_with_spill(oid, len(data))
        if buf is None:
            return self.store.contains(oid)  # racer may have restored it
        buf[:] = data
        del buf
        self.store.seal(oid)
        self.store.release(oid)
        self.spilled.pop(oid.binary(), None)
        self.spilled_bytes = max(0, self.spilled_bytes - len(data))
        try:
            self.spill_storage.delete(uri)
        except Exception:  # bucket backends raise beyond OSError; the
            pass           # restore itself already succeeded
        return True

    async def _create_local_with_spill(self, oid, size: int):
        """create_buffer that escalates to spilling OTHER objects on FULL
        (the raylet-side twin of core_worker._create_with_spill). Returns
        None when space cannot be made."""
        from ray_tpu_torch._private.object_store import StoreFullError

        for _ in range(8):
            try:
                return self.store.create_buffer(oid, size)
            except StoreFullError:
                freed = 0
                for cand in self.store.evictable(max_n=64):
                    if cand.binary() == oid.binary():
                        continue
                    before = self.store.stats()["bytes_allocated"]
                    if await self._spill_object(cand):
                        freed += before - self.store.stats()["bytes_allocated"]
                    if freed >= size:
                        break
                if not freed:
                    return None
            except Exception:
                return None  # e.g. ObjectExists: concurrent restore won
        return None

    async def rpc_free_local_object(self, conn, oid_bytes: bytes):
        """GCS free fan-out: drop this node's copy — store and/or disk."""
        from ray_tpu_torch._private.ids import ObjectID

        try:
            self.store.delete(ObjectID(oid_bytes))
        except Exception:
            pass
        entry = self.spilled.pop(oid_bytes, None)
        if entry is not None:
            uri, nbytes = entry
            self.spilled_bytes = max(0, self.spilled_bytes - nbytes)
            try:
                self.spill_storage.delete(uri)
            except Exception:  # bucket backends raise beyond OSError
                pass
        return True

    async def rpc_spill_now(self, conn, bytes_needed: int):
        """Synchronous spill request from a client whose create hit FULL:
        spill LRU objects until >= bytes_needed are free (or no candidates).
        Returns bytes freed."""
        freed = 0
        for oid in self.store.evictable(max_n=256):
            if freed >= int(bytes_needed) * 2:  # headroom: halve retry loops
                break
            before = self.store.stats()["bytes_allocated"]
            if await self._spill_object(oid):
                freed += before - self.store.stats()["bytes_allocated"]
        return freed

    def _maybe_kill_for_oom(self):
        threshold = GLOBAL_CONFIG.memory_usage_threshold
        if threshold >= 1.0 or self._host_memory_fraction() < threshold:
            return
        now = time.monotonic()
        # Cooldown: give the previous kill time to actually release memory
        # before deciding again (otherwise every leased worker dies within
        # one pressure spike).
        if now - getattr(self, "_last_oom_kill", 0.0) < 1.0:
            return
        # Retriable-FIFO policy: kill the most recently leased *task* worker
        # (its task retries; older tasks keep their progress). Actor workers
        # are exempt — killing one is permanent with max_restarts=0, which
        # "task will retry" cannot justify (reference group-by-owner policy
        # territory).
        newest = None
        for lease in self.leases.values():
            if lease.worker.proc is None or lease.worker.actor_id is not None:
                continue
            if newest is None or lease.granted_at > newest.granted_at:
                newest = lease
        if newest is not None and newest.worker.proc.poll() is None:
            self._last_oom_kill = now
            logger.warning(
                "memory pressure %.0f%% >= %.0f%%: killing worker %s "
                "(task will retry)",
                self._host_memory_fraction() * 100, threshold * 100,
                newest.worker.worker_id.hex()[:6],
            )
            newest.worker.proc.kill()

    # ------------- object plane -------------
    async def rpc_pull_object(self, conn, oid_bytes: bytes):
        """Ensure the object is in the local store (fetch from a remote
        node). Concurrent pulls of the SAME object are deduplicated into
        one in-flight fetch (parity: reference PullManager admission,
        pull_manager.h:52) — N workers asking for one hot object cost one
        transfer, not N."""
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(oid_bytes)
        if self.store.contains(oid):
            return True
        if await self._restore_object(oid):  # spilled here: restore from disk
            return True
        inflight = self._pulls_inflight.get(oid_bytes)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut = asyncio.get_running_loop().create_future()
        self._pulls_inflight[oid_bytes] = fut
        try:
            ok = await self._pull_object_once(oid, oid_bytes)
            if ok:
                self._pulls_completed += 1
            if not fut.done():
                fut.set_result(ok)
            return ok
        except BaseException:
            if not fut.done():
                fut.set_result(False)
            raise
        finally:
            self._pulls_inflight.pop(oid_bytes, None)

    async def _pull_object_once(self, oid, oid_bytes: bytes) -> bool:
        """One logical pull: locate holders, probe their metas, then run
        a windowed multi-peer striped fetch. A failed attempt (peer died
        or timed out mid-pull) aborts the partial buffer ONCE and retries
        with fresh locations up to ``object_transfer_retries`` times.

        Broadcast tree (``object_broadcast_fanout`` > 0): the pull first
        registers with the GCS pull registry (``pull_begin``). When K
        raylets pull the same large object concurrently, each is
        assigned an earlier-arrived puller as its tree PARENT and
        streams chunk ranges off the parent's in-progress pull (partial
        serve) instead of the source — source egress stays O(fanout),
        not O(K). A parent that dies, aborts, or never materializes is
        excluded and the puller walks up to an ancestor or the source.

        Chaos-replay-deterministic: source-order shuffles draw from the
        seeded per-raylet RNG so a replayed fault schedule meets the
        same pull traffic (raylint R4 guards this)."""
        retries = max(1, int(GLOBAL_CONFIG.object_transfer_retries))
        stripe = max(1, int(GLOBAL_CONFIG.object_transfer_stripe_peers))
        fanout = int(GLOBAL_CONFIG.object_broadcast_fanout)
        min_tree = int(GLOBAL_CONFIG.object_broadcast_min_bytes)
        trace = os.environ.get("RAYTPU_TRANSFER_TRACE")
        bad_parents: List[bytes] = []  # tree parents that failed us
        parent_misses: Dict[bytes, int] = {}  # parent -> no-meta probes
        registered = False
        try:
            for attempt in range(retries):
                t_loc = time.perf_counter()
                if self.store.contains(oid):
                    return True
                parents: List[bytes] = []
                # GCS read cache: a cached directory entry serves the
                # steady-state pull without round-tripping the GCS.
                # Tree-eligible objects (unknown size, or >= the
                # broadcast threshold) still call pull_begin — the
                # registry read doubles as the puller registration the
                # fan-out tree is built from. Retry attempts bypass and
                # drop the entry (stale locations are the usual reason
                # the previous attempt failed).
                if attempt == 0:
                    cached = self._loc_cache.get(oid_bytes)
                else:
                    self._loc_cache.pop(oid_bytes, None)
                    cached = None
                if cached is not None and cached["locs"] and (
                    fanout <= 0
                    or (cached["size"] is not None
                        and cached["size"] < min_tree)
                ):
                    self._gcs_cache_stats["loc_hits"] += 1
                    locs = list(cached["locs"])
                elif fanout > 0:
                    self._gcs_cache_stats["loc_misses"] += 1
                    try:
                        info = await self.gcs.call_async(
                            "pull_begin",
                            [oid_bytes, self.node_id, bad_parents],
                        )
                        registered = True
                        locs = info["locations"]
                        parents = [bytes(p) for p in info["parents"]]
                        self._tree_position = int(info.get("position", 0))
                    except rpc.RpcError as e:
                        if "unknown method" not in str(e):
                            raise
                        fanout = 0  # mixed-version GCS: no tree support
                        locs = await self.gcs.call_async(
                            "get_object_locations", oid_bytes
                        )
                    if locs:
                        self._loc_cache_put(oid_bytes, locs)
                else:
                    self._gcs_cache_stats["loc_misses"] += 1
                    locs = await self.gcs.call_async(
                        "get_object_locations", oid_bytes
                    )
                    if locs:
                        self._loc_cache_put(oid_bytes, locs)
                cands = []
                for node_id in locs:
                    nid_hex = bytes(node_id).hex()
                    if nid_hex == self.node_id.hex():
                        continue
                    node = self.cluster_nodes.get(nid_hex)
                    if node is None or not node.get("alive", True):
                        continue
                    cands.append(node)
                parent_nodes = []
                for p in parents:
                    node = self.cluster_nodes.get(p.hex())
                    if node is not None and node.get("alive", True):
                        parent_nodes.append((p, node))
                if not cands and not parent_nodes:
                    return False
                # randomize the source order so an N-node broadcast forms a
                # tree (each completed pull registers a new location) instead
                # of every node hammering the origin (push_manager.h:30 role)
                self._rng.shuffle(cands)
                # locality-aware stripe-peer preference (label-driven):
                # same-host copies first, same-gang second, so MeshGroup
                # weight/checkpoint pulls stay off the DCN when a local
                # copy exists. The stable sort keeps the seeded shuffle
                # order WITHIN each class — replay determinism intact.
                cands.sort(
                    key=lambda n: locality_class(self.labels,
                                                 n.get("labels"))
                )
                if GLOBAL_CONFIG.object_transfer_same_host_shm:
                    for node in cands:
                        if await self._pull_same_host_shm(oid, node):
                            # size-stamp the cache off the just-landed
                            # local copy (the socket path stamps from
                            # its meta probe below)
                            if locs:
                                view = self.store.get(oid, timeout=0)
                                if view is not None:
                                    nbytes = view.nbytes
                                    view.release()
                                    self.store.release(oid)
                                    self._loc_cache_put(
                                        oid_bytes, locs, nbytes
                                    )
                            return True
                addrs = [n["raylet_addr"] for n in cands]
                loc_by_addr = {
                    n["raylet_addr"]: locality_class(self.labels,
                                                     n.get("labels"))
                    for n in cands
                }
                paddrs = [n["raylet_addr"] for _, n in parent_nodes]
                probe_n = min(len(addrs), max(stripe, 2))
                t_meta = time.perf_counter()
                metas = await asyncio.gather(
                    *[self._peer_meta(a, oid)
                      for a in addrs[:probe_n] + paddrs]
                )
                if trace:
                    logger.info("pull %s: locations=%.3fs metas=%.3fs",
                                oid.hex()[:12], t_meta - t_loc,
                                time.perf_counter() - t_meta)
                pmetas = metas[probe_n:]
                sources = [
                    (a, m)
                    for a, m in zip(addrs, metas[:probe_n]) if m is not None
                ]
                # prefer in-memory copies over spill-restoring peers: stable
                # sort keeps the shuffled tree order within each class
                sources.sort(key=lambda am: bool(am[1].get("spilled")))
                if not sources and not any(m for m in pmetas):
                    for a in addrs[probe_n:]:
                        m = await self._peer_meta(a, oid)
                        if m is not None:
                            sources = [(a, m)]
                            break
                psources = [
                    (pid, a, m)
                    for (pid, _), a, m in zip(parent_nodes, paddrs, pmetas)
                    if m is not None
                ]
                sealed_size = (
                    int(sources[0][1]["size"]) if sources else None
                )
                if sealed_size is not None and locs:
                    # size-stamp the cache entry: a repeat pull of a
                    # known-small object can then skip the GCS entirely
                    self._loc_cache_put(oid_bytes, locs, sealed_size)
                if parent_nodes and not psources and (
                    sealed_size is None or sealed_size >= min_tree
                ):
                    # assigned parents haven't materialized their pulls
                    # yet (they are probing their own sources right now):
                    # re-probe on a short inner loop instead of hammering
                    # the sealed source — this wait is what keeps source
                    # egress O(fanout). Deeper tree levels ready later,
                    # so the budget covers several cascade hops. (Objects
                    # below the tree threshold skip the wait entirely.)
                    # bounded retry-budget clock, not a replay-schedule
                    # input (the fault schedule keys on frame seqs)
                    wait_deadline = time.monotonic() + 1.0  # raylint: disable=R4 — budget clock
                    while time.monotonic() < wait_deadline:  # raylint: disable=R4 — budget clock
                        await asyncio.sleep(0.05)
                        pmetas = await asyncio.gather(
                            *[self._peer_meta(a, oid) for a in paddrs]
                        )
                        psources = [
                            (pid, a, m) for (pid, _), a, m in zip(
                                parent_nodes, paddrs, pmetas
                            ) if m is not None
                        ]
                        if psources:
                            break
                    if not psources:
                        for pid, _ in parent_nodes:
                            parent_misses[pid] = (
                                parent_misses.get(pid, 0) + 1
                            )
                            if parent_misses[pid] >= 2:
                                # a full budget twice and still nothing
                                # to stream from: stop waiting on it
                                bad_parents.append(pid)
                if not sources and not psources:
                    # all candidates unreachable (dying peers / fault
                    # window): back off before refreshing locations
                    await asyncio.sleep(0.1 * (attempt + 1))
                    continue
                size = int(
                    (psources[0][2] if psources else sources[0][1])["size"]
                )
                if psources and size >= min_tree:
                    # ride the tree: stream off the assigned parent's
                    # (possibly still in-progress) copy — the source NIC
                    # is left to the tree roots
                    self._tree_pulls += 1
                    if await self._pull_striped(
                        oid, size, [a for _, a, _ in psources[:stripe]]
                    ):
                        return True
                    # the parent chain failed this attempt: exclude and
                    # let pull_begin re-assign (ancestor or source)
                    bad_parents.extend(pid for pid, _, _ in psources)
                    await asyncio.sleep(0.2 * (attempt + 1))
                    continue
                live_parents = [
                    pid for pid, _ in parent_nodes
                    if pid not in bad_parents
                ]
                if (live_parents and not psources
                        and (not sources or int(
                            sources[0][1]["size"]
                        ) >= min_tree)
                        and attempt < retries - 1):
                    # a parent is assigned but hasn't materialized its
                    # pull yet (it is probing the source right now):
                    # WAIT for it instead of hammering the source —
                    # that wait is what keeps source egress O(fanout).
                    # Two consecutive misses exclude the parent above,
                    # and the last attempt always falls through.
                    await asyncio.sleep(0.05 + 0.1 * attempt)
                    continue
                if psources and not sources and attempt < retries - 1:
                    # small object assigned a parent that is still
                    # pulling, and no sealed source is reachable: wait
                    # for the parent to seal rather than failing
                    await asyncio.sleep(0.1 * (attempt + 1))
                    continue
                if not sources:
                    await asyncio.sleep(0.1 * (attempt + 1))
                    continue
                if loc_by_addr.get(sources[0][0], 2) < 2:
                    self._locality_pref_hits += 1
                if await self._pull_striped(
                    oid, size, [a for a, _ in sources[:stripe]]
                ):
                    return True
                await asyncio.sleep(0.2 * (attempt + 1))
            return False
        finally:
            if registered:
                try:
                    await self.gcs.call_async(
                        "pull_end", [oid_bytes, self.node_id]
                    )
                except Exception:
                    pass  # GCS restarting: registry prunes by liveness

    async def _pull_same_host_shm(self, oid, node: Dict) -> bool:
        """Same-host fast path: attach the peer raylet's store arena by
        file path and copy the sealed object arena-to-arena — no sockets
        (parity: the reference shares plasma objects between same-node
        consumers without a transfer). Guarded by peer LIVENESS (a
        pooled-conn dial): a dead node's leftover arena must not
        resurrect objects the cluster considers lost."""
        path = node.get("store_path")
        if not path or not os.path.exists(path):
            return False
        addr = node["raylet_addr"]
        try:
            conn = await self._peer_pool.acquire(addr)
        except Exception:
            return False  # peer raylet not reachable: not provably live
        self._peer_pool.release(addr, conn)
        st = self._peer_stores.get(path)
        if st is None or st.closed:
            try:
                # attach() may compile the native store lib — off-loop (R7)
                st = await asyncio.to_thread(SharedMemoryStore.attach, path)
            except Exception:
                return False
            cur = self._peer_stores.get(path)
            if cur is not None and not cur.closed:
                st = cur  # concurrent attacher won during the await
            else:
                self._peer_stores[path] = st
        view = None
        try:
            view = st.get(oid, timeout=0)  # pins cross-process
            if view is None:
                return False  # not in memory there (e.g. spilled)
            size = view.nbytes
            t0 = time.perf_counter()
            chunk = int(GLOBAL_CONFIG.object_transfer_chunk_bytes)
            buf = await self._create_local_with_spill(oid, size)
            if buf is None:
                return self.store.contains(oid)
            try:
                for off in range(0, size, chunk):
                    n = min(chunk, size - off)
                    buf[off : off + n] = view[off : off + n]
                    self._transfer_bytes_in += n
                    # big copies must not starve heartbeats/pulls
                    await asyncio.sleep(0)
            except BaseException as e:
                # BaseException: CancelledError at the sleep must also
                # abort, or the unsealed pin leaks until restart (R14)
                try:
                    self.store.abort(oid)
                except Exception:
                    pass
                if not isinstance(e, Exception):
                    raise
                logger.warning("same-host shm pull of %s failed: %r",
                               oid.hex()[:12], e)
                return False
            finally:
                del buf
            self.store.seal(oid)
            self.store.release(oid)
            dt = time.perf_counter() - t0
            if size > 0 and dt > 0:
                self._last_pull_gbps = round(size / dt / 1e9, 3)
            try:
                await self.gcs.call_async(
                    "add_object_location", [oid.binary(), self.node_id]
                )
            except Exception:
                logger.warning("location registration for %s failed",
                               oid.hex()[:12])
            return True
        except Exception as e:
            logger.warning("same-host shm pull of %s failed: %r",
                           oid.hex()[:12], e)
            return False
        finally:
            if view is not None:
                view.release()
                try:
                    st.release(oid)
                except Exception:
                    pass

    async def _peer_meta(self, addr: str, oid):
        """Object meta from one peer over its pooled connection; None =
        peer unreachable or it no longer holds a copy."""
        try:
            conn = await self._peer_pool.acquire(addr)
        except Exception:
            return None
        try:
            meta = await conn.call_async(
                "read_object_meta", oid.binary(),
                timeout=float(GLOBAL_CONFIG.object_transfer_chunk_timeout_s),
            )
        except BaseException as e:
            # cancellation must hand the conn back too (R14); only a
            # real call failure taints it
            self._peer_pool.release(addr, conn, discard=isinstance(e, Exception))
            if not isinstance(e, Exception):
                raise
            return None
        self._peer_pool.release(addr, conn)
        return meta

    async def _pull_striped(self, oid, size: int, peers: List[str]) -> bool:
        """Windowed, striped fetch into a freshly created store buffer.

        Each peer runs ``object_transfer_window`` chunk requests in
        flight (bandwidth is window*chunk per RTT, not chunk per RTT);
        peers pop disjoint ranges off one shared queue, so large objects
        stripe across every source. Chunk payloads arrive as RAW frames
        and are copied once, transport thread -> store buffer
        (receive-into-place). A failed peer hands its ranges back to the
        queue for the survivors; if ranges remain unserved the partial
        buffer is aborted exactly once and the caller may retry."""
        import collections as _collections

        from ray_tpu_torch._private import conduit as _conduit

        t_create = time.perf_counter()
        buf = await self._create_local_with_spill(oid, size)
        if buf is None:
            return self.store.contains(oid)
        # Everything from here through the transfer loop runs under
        # one BaseException guard: the unsealed pin (and, once
        # registered, the sink / partial-serve entries) must be
        # released on ANY exit, including cancellation (R13/R14).
        sink_target = None
        token = 0
        native_sink = False
        try:
            t_create = time.perf_counter() - t_create
            chunk = int(GLOBAL_CONFIG.object_transfer_chunk_bytes)
            sink_target = _PullSink(buf, size=size, chunk=chunk)
            # Deposit sink: when the native engine carries this process's
            # peer connections, chunk payloads stream STRAIGHT off the
            # socket into `buf` (frames are tagged with this token) — the
            # kernel's recv copy is the only receive-side copy. On the
            # asyncio fallback the frames arrive inline and sink_target
            # copies them into place instead.
            token = int.from_bytes(os.urandom(7), "big") + 1
            # available() may compile the shim on first call — off-loop (R7)
            native_sink = bool(GLOBAL_CONFIG.native_wire and
                               await asyncio.to_thread(_conduit.available))
            if native_sink:
                _conduit.Engine.get().sink_register(token, buf)
            self._transfers[token] = sink_target
            # broadcast tree: landed ranges of this in-progress pull are now
            # servable onward to child pullers (read_object_chunks/meta)
            self._partial_serves[oid.binary()] = sink_target
            del buf
            ranges = _collections.deque(
                (off, min(chunk, size - off)) for off in range(0, size, chunk)
            )
            total_ranges = len(ranges)
            done = [0]
            landed = sink_target.landed
            window = max(1, int(GLOBAL_CONFIG.object_transfer_window))
            timeout_s = float(GLOBAL_CONFIG.object_transfer_chunk_timeout_s)
            chunk_tries = 1 + max(
                0, int(GLOBAL_CONFIG.object_transfer_chunk_retries)
            )
            t0 = time.perf_counter()

            async def fetch_batch(conn, todo):
                """One streamed batch request: the peer pushes each chunk as
                a raw frame (deposited natively or copied inline by
                _on_obj_chunk), then replies — ordered delivery means every
                frame of the batch precedes the reply, so arrival is checked
                against the ledger right after."""
                reply = await conn.call_async(
                    "read_object_chunks",
                    [oid.binary(), [[o, n] for o, n in todo], token],
                    timeout=timeout_s,
                )
                if reply is None:
                    raise _LocationMiss(oid.hex())

            async def fetch_legacy(conn, todo):
                """Per-chunk fallback for peers without the batch endpoint."""
                for off, n in todo:
                    def sink(meta, mv, _off=off, _n=n):
                        if len(mv) != _n:
                            raise ValueError("chunk size mismatch")
                        if sink_target.write(_off, mv):
                            sink_target.record(_off, _n)

                    meta = await conn.call_raw_async(
                        "read_object_chunk_raw",
                        [oid.binary(), off, n, token], sink,
                        timeout=timeout_s,
                    )
                    if meta is None:
                        raise _LocationMiss(oid.hex())
                    if native_sink:
                        sink_target.record(off, n)

            async def run_peer(addr: str) -> bool:
                """Drain ranges through one peer; True = no transport fault."""
                state = {"failed": False}
                batch_sem = asyncio.Semaphore(2)  # double-buffered batches
                tasks = []
                try:
                    conn = await self._peer_pool.acquire(addr)
                except Exception:
                    return False
                conn.raw_notify["obj_chunk"] = self._on_obj_chunk

                async def run_batch(batch):
                    self._pull_chunks_inflight += len(batch)
                    err = None
                    try:
                        attempt = 0
                        while attempt < chunk_tries:
                            todo = [r for r in batch if landed.get(r[0]) != r[1]]
                            if not todo:
                                break
                            attempt += 1
                            if attempt > 1:
                                # a chaos-dropped frame costs one timeout,
                                # not the whole striped attempt
                                self._transfer_chunk_retries += 1
                            try:
                                if state.get("legacy"):
                                    await fetch_legacy(conn, todo)
                                else:
                                    await fetch_batch(conn, todo)
                            except _LocationMiss as e:
                                # the peer no longer HOLDS a copy: a
                                # location miss, not a transport fault —
                                # retrying this peer cannot help, its
                                # pooled conn is healthy (keep it), and the
                                # outer pull attempt refreshes locations
                                err = e
                                break
                            except rpc.RpcError as e:
                                if "unknown method" in str(e) and not (
                                    state.get("legacy")
                                ):
                                    state["legacy"] = True  # pre-batch peer
                                    # the fallback probe must not burn a
                                    # retry: at chunk_retries=0 the legacy
                                    # path still gets its one attempt
                                    attempt -= 1
                                    continue
                                err = e
                                break
                            except Exception as e:
                                err = e
                                if conn.closed:
                                    break
                        missing = [
                            r for r in batch if landed.get(r[0]) != r[1]
                        ]
                        if missing:
                            state["failed"] = True
                            # per-CAUSE verdict: only a batch whose failure
                            # was NOT a pure location miss implicates the
                            # transport (a concurrent batch may time out on
                            # this same conn while another sees the miss)
                            if not isinstance(err, _LocationMiss):
                                state["transport_fault"] = True
                            if not state.get("logged"):
                                state["logged"] = True
                                logger.warning(
                                    "batch fetch of %s from %s failed "
                                    "(%d/%d chunks missing): %r",
                                    oid.hex()[:12], addr, len(missing),
                                    len(batch), err,
                                )
                            ranges.extend(missing)  # survivors take over
                        # landed chunks count exactly once, at their batch
                        for off, n in batch:
                            if landed.get(off) == n:
                                done[0] += 1
                                self._transfer_bytes_in += n
                    finally:
                        self._pull_chunks_inflight -= len(batch)
                        batch_sem.release()

                try:
                    while ranges and not state["failed"]:
                        batch = []
                        while ranges and len(batch) < window:
                            batch.append(ranges.popleft())
                        if not batch:
                            break
                        await batch_sem.acquire()
                        if state["failed"]:
                            ranges.extend(batch)
                            batch_sem.release()
                            break
                        tasks.append(
                            asyncio.get_running_loop().create_task(
                                run_batch(batch)
                            )
                        )
                    if tasks:
                        await asyncio.gather(*tasks, return_exceptions=True)
                finally:
                    # a lost-copy peer FAILED the pull (its ranges handed
                    # over to survivors) but its connection is perfectly
                    # healthy — discard only when some batch implicated the
                    # TRANSPORT (timeouts/errors that were not location
                    # misses), so a conn that both missed a copy and wedged
                    # still gets discarded
                    self._peer_pool.release(
                        addr, conn,
                        discard=bool(state.get("transport_fault")),
                    )
                return not state["failed"]

            survivors = list(peers)
            while ranges and survivors:
                done_before = done[0]
                results = await asyncio.gather(
                    *(run_peer(a) for a in survivors)
                )
                survivors = [a for a, ok in zip(survivors, results) if ok]
                if done[0] == done_before:
                    break  # zero chunks landed this round: don't spin
        except BaseException:
            # cancellation (raylet shutdown) or an unexpected fault must
            # not leak the registered sink (engine-pinned store buffer),
            # the _transfers entry, the partial-serve registration, or
            # the unsealed partial buffer
            self._transfers.pop(token, None)
            if self._partial_serves.get(oid.binary()) is sink_target:
                self._partial_serves.pop(oid.binary(), None)
            if native_sink:
                _conduit.Engine.get().sink_unregister(token)
            if sink_target is not None:
                sink_target.close()
            try:
                self.store.abort(oid)
            except Exception:
                pass
            raise

        self._transfers.pop(token, None)
        if native_sink:
            # blocks until any in-flight native deposit completes: after
            # this, seal/abort cannot race an engine write, and straggler
            # frames for the token are discarded by the engine
            _conduit.Engine.get().sink_unregister(token)
        # completeness comes from the arrival ledger, not the done[]
        # counter: a chunk landing between a timed-out batch's `missing`
        # computation and its count loop gets requeued AND counted, then
        # counted again by the survivor that re-serves it — the ledger
        # is immune to that double-count (and to duplicates generally)
        complete = all(
            landed.get(off) == min(chunk, size - off)
            for off in range(0, size, chunk)
        )
        if complete:
            t_seal = time.perf_counter()
            sink_target.close()
            self.store.seal(oid)
            self.store.release(oid)
            # sealed: children switch from partial serve to the store
            # path (the entry goes AFTER seal so they never see neither)
            if self._partial_serves.get(oid.binary()) is sink_target:
                self._partial_serves.pop(oid.binary(), None)
            dt = time.perf_counter() - t0
            if size > 0 and dt > 0:
                self._last_pull_gbps = round(size / dt / 1e9, 3)
            if os.environ.get("RAYTPU_TRANSFER_TRACE"):
                logger.info(
                    "pull %s: create=%.3fs transfer=%.3fs seal=%.3fs "
                    "(%.3f GB/s wire)",
                    oid.hex()[:12], t_create, t_seal - t0,
                    time.perf_counter() - t_seal,
                    size / max(t_seal - t0, 1e-9) / 1e9,
                )
            try:
                await self.gcs.call_async(
                    "add_object_location", [oid.binary(), self.node_id]
                )
            except Exception:
                logger.warning("location registration for %s failed",
                               oid.hex()[:12])
            return True
        # failure: stop straggler writes, then abort the partial buffer
        # exactly once (this is the only abort site for this attempt)
        self._pull_aborts += 1
        if self._partial_serves.get(oid.binary()) is sink_target:
            self._partial_serves.pop(oid.binary(), None)
        sink_target.close()
        try:
            self.store.abort(oid)
        except Exception:
            pass
        logger.warning(
            "striped pull of %s failed (%d/%d chunks, peers=%s)",
            oid.hex()[:12], done[0], total_ranges, len(peers),
        )
        return False

    def _on_obj_chunk(self, conn, meta, payload, token, deposited):
        """Inbound chunk frame of a streamed batch (transport thread:
        conduit reaper or IO loop). Native deposits already landed in
        the store buffer — just record; inline payloads copy into place
        here. Unknown tokens (aborted/finished transfers) are dropped."""
        sink_target = self._transfers.get(int(token))
        if sink_target is None:
            return
        off, n = int(meta[0]), int(meta[1])
        if deposited is None:
            if len(payload) == n and sink_target.write(off, payload):
                sink_target.record(off, n)
        elif deposited == n:
            sink_target.record(off, n)
        # deposited mismatch / -1 (discarded): not recorded — the batch
        # check re-fetches the range

    async def rpc_read_object_chunks(self, conn, data):
        """Streamed batch serve: push every requested chunk as a RAW
        frame (zero-copy out of the shm mmap, deposit-tagged for
        receive-into-place), then reply. Ordered delivery makes the
        reply a barrier: when the puller sees it, every chunk frame of
        the batch has been delivered (or the conn died). The store pin
        is held until the LAST chunk's bytes leave the process; outbound
        pacing bounds pinned in-flight bytes."""
        from ray_tpu_torch._private.ids import ObjectID

        oid_bytes, req_ranges, token = data[0], data[1], data[2]
        oid = ObjectID(oid_bytes)
        view = self.store.get(oid, timeout=0)
        if view is None and await self._restore_object(oid):
            view = self.store.get(oid, timeout=0)
        if view is None:
            # broadcast tree: no sealed copy, but an IN-PROGRESS pull of
            # this object can serve its landed ranges onward (the child
            # rides behind this raylet's own transfer)
            sink = self._partial_serves.get(bytes(oid_bytes))
            if sink is not None and not sink.closed:
                return await self._serve_chunks_partial(
                    conn, oid, sink, req_ranges, token
                )
            return None
        lock = threading.Lock()
        remaining = [1]  # the handler itself holds one ref

        def unref():
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                try:
                    view.release()
                    self.store.release(oid)
                except Exception:
                    pass

        served = 0
        try:
            for off, n in req_ranges:
                off, n = int(off), int(n)
                if off < 0 or n < 0 or off + n > view.nbytes:
                    break  # malformed range: stop serving the batch
                await self._outbound_sem.acquire()
                self._outbound_chunks += 1
                self._transfer_bytes_out += n
                sub = view[off : off + n]
                with lock:
                    remaining[0] += 1

                def on_sent(_sub=sub):
                    # reaper thread (conduit) / IO loop (asyncio): the
                    # bytes left the process — drop this chunk's refs
                    # and hand the pacing slot back
                    try:
                        _sub.release()
                    except Exception:
                        pass
                    unref()
                    try:
                        self._loop.call_soon_threadsafe(
                            self._outbound_sem.release
                        )
                    except RuntimeError:
                        pass  # loop closed (raylet shutdown)

                try:
                    conn.send_raw_frame(
                        rpc._NOTIFY, None, "obj_chunk", [off, n], sub,
                        on_sent=on_sent, token=int(token), off=off,
                    )
                except Exception:
                    break  # conn died; on_sent already fired
                served += 1
                # asyncio fallback only: its transport BUFFERS the
                # payload at write() and fires on_sent immediately, so
                # the pacing semaphore bounds nothing — drain past the
                # high-water mark or a slow puller piles the whole
                # window into the writer buffer. (The conduit engine
                # needs no drain: its EV_SENT fires when writev really
                # flushed, so the semaphore paces natively.)
                writer = getattr(conn, "writer", None)
                if writer is not None and (
                    writer.transport.get_write_buffer_size()
                    > rpc._DRAIN_HIGH_WATER
                ):
                    try:
                        async with conn._write_lock:
                            await writer.drain()
                    except Exception:
                        break  # conn died mid-drain
        finally:
            unref()
        return {"served": served}

    async def _serve_chunks_partial(self, conn, oid, sink,
                                    req_ranges, token) -> Optional[Dict]:
        """Broadcast-tree partial serve: push requested ranges of an
        in-progress pull as they LAND in the local sink's arrival
        ledger. Each range waits (bounded by the chunk timeout) for
        coverage; bytes are copied out under the sink lock — the child
        pipelines behind this raylet's own transfer instead of hitting
        the source. If the local pull seals mid-batch the remaining
        ranges serve from the sealed store; if it aborts, the loop stops
        and the child's batch check re-fetches elsewhere."""
        timeout_s = float(GLOBAL_CONFIG.object_transfer_chunk_timeout_s)
        deadline = time.monotonic() + max(1.0, timeout_s * 0.9)
        served = 0
        for off, n in req_ranges:
            off, n = int(off), int(n)
            if off < 0 or n < 0 or off + n > sink.size:
                break  # malformed range: stop serving the batch
            payload: Optional[bytes] = None
            while True:
                if sink.covered(off, n):
                    payload = sink.read(off, n)
                    if payload is not None:
                        break
                if sink.closed:
                    # sealed (serve from the store) or aborted (give up)
                    payload = self._read_sealed_bytes(oid, off, n)
                    break
                if time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.02)
            if payload is None:
                break
            # pacing slot AFTER the wait: parked ranges must not occupy
            # outbound capacity the sealed-serve path needs
            await self._outbound_sem.acquire()
            self._outbound_chunks += 1
            self._transfer_bytes_out += n
            self._partial_chunks_out += 1

            def on_sent():
                try:
                    self._loop.call_soon_threadsafe(
                        self._outbound_sem.release
                    )
                except RuntimeError:
                    pass  # loop closed (raylet shutdown)

            try:
                conn.send_raw_frame(
                    rpc._NOTIFY, None, "obj_chunk", [off, n], payload,
                    on_sent=on_sent, token=int(token), off=off,
                )
            except Exception:
                break  # conn died; on_sent already fired
            served += 1
            # asyncio fallback: drain past the high-water mark (see the
            # sealed-serve path for why the semaphore alone is not pacing)
            writer = getattr(conn, "writer", None)
            if writer is not None and (
                writer.transport.get_write_buffer_size()
                > rpc._DRAIN_HIGH_WATER
            ):
                try:
                    async with conn._write_lock:
                        await writer.drain()
                except Exception:
                    break
        return {"served": served}

    def _read_sealed_bytes(self, oid, off: int, n: int) -> Optional[bytes]:
        """One-shot copy of a sealed object's range (partial-serve's
        seal-transition fallback; the pin is held only for the copy)."""
        view = self.store.get(oid, timeout=0)
        if view is None:
            return None
        try:
            if off < 0 or n < 0 or off + n > view.nbytes:
                return None
            return bytes(view[off : off + n])
        finally:
            view.release()
            self.store.release(oid)

    async def rpc_read_object_meta(self, conn, oid_bytes: bytes):
        """Size + spill state of a local copy. Does NOT force a restore:
        pullers use the ``spilled`` flag to prefer in-memory peers, and a
        spilled copy restores lazily when its chunks are requested."""
        from ray_tpu_torch._private.ids import ObjectID

        view = self.store.get(ObjectID(oid_bytes), timeout=0)
        if view is not None:
            size = view.nbytes
            view.release()
            self.store.release(ObjectID(oid_bytes))
            self._objects_served += 1
            return {"size": size, "spilled": False}
        entry = self.spilled.get(oid_bytes)
        if entry is not None:
            self._objects_served += 1
            return {"size": entry[1], "spilled": True}
        sink = self._partial_serves.get(bytes(oid_bytes))
        if sink is not None and not sink.closed:
            # broadcast tree: an in-progress pull is a valid source —
            # children stream its landed ranges (partial serve)
            self._objects_served += 1
            return {"size": sink.size, "spilled": False, "partial": True}
        return None

    async def rpc_read_object_chunk_raw(self, conn, data):
        """Serve one chunk as a RAW frame: the payload is a memoryview
        straight over the shm store mmap, written out by the transport's
        scatter-gather send — no Python-level copy, no msgpack encode of
        the bulk bytes. The store pin is held until the transport reports
        the bytes left the process (on_sent), bounded in aggregate by the
        outbound semaphore (push-manager pacing role)."""
        from ray_tpu_torch._private.ids import ObjectID

        oid_bytes, off, n = data[0], data[1], data[2]
        token = int(data[3]) if len(data) > 3 else 0
        oid = ObjectID(oid_bytes)
        # a spilled object restores BEFORE pacing: a multi-second disk
        # restore must not occupy an outbound slot
        view = self.store.get(oid, timeout=0)
        if view is None and await self._restore_object(oid):
            view = self.store.get(oid, timeout=0)
        if view is None:
            return None
        off, n = int(off), int(n)
        nbytes = view.nbytes
        if off < 0 or n < 0 or off + n > nbytes:
            # same validation as the batch endpoint: a malformed range
            # must produce a clean error reply, not a negative-index
            # slice of the wrong bytes (and no pin/stat leak)
            view.release()
            self.store.release(oid)
            raise ValueError(
                f"chunk range [{off}, {off + n}) outside object of "
                f"{nbytes} bytes"
            )
        await self._outbound_sem.acquire()
        self._outbound_chunks += 1
        self._transfer_bytes_out += n
        sub = view[off : off + n]

        def on_sent():
            # conduit reaper thread (or IO loop on the asyncio fallback):
            # drop the store pin, then hand the pacing slot back on the
            # raylet loop
            try:
                sub.release()
                view.release()
                self.store.release(oid)
            except Exception:
                pass
            try:
                self._loop.call_soon_threadsafe(self._outbound_sem.release)
            except RuntimeError:
                pass  # loop already closed (raylet shutdown)

        return rpc.RawReply([int(off), int(n)], sub, on_sent=on_sent,
                            token=token, off=int(off))

    async def rpc_read_object_chunk(self, conn, data):
        """Legacy msgpack chunk read (kept for mixed-version interop and
        direct debugging; the pull path uses read_object_chunk_raw)."""
        from ray_tpu_torch._private.ids import ObjectID

        oid_bytes, off, n = data
        oid = ObjectID(oid_bytes)
        view = self.store.get(oid, timeout=0)
        if view is None and await self._restore_object(oid):
            view = self.store.get(oid, timeout=0)
        if view is None:
            return None
        try:
            off, n = int(off), int(n)
            if off < 0 or n < 0 or off + n > view.nbytes:
                # same validation as the raw/batch endpoints: negative
                # off would silently serve bytes from the object's END
                raise ValueError(
                    f"chunk range [{off}, {off + n}) outside object "
                    f"of {view.nbytes} bytes"
                )
            async with self._outbound_sem:
                self._outbound_chunks += 1
                self._transfer_bytes_out += n
                return bytes(view[off : off + n])
        finally:
            view.release()
            self.store.release(oid)

    # ------------- introspection -------------
    async def _task_plane_stats(self) -> Dict:
        """Aggregate task-plane counters from every registered worker
        and driver over their registration conns (best-effort: a dying
        worker just drops out of the sum). Cached for 2s: node_stats is
        polled by the autoscaler/status paths every tick, and the
        fan-out must not multiply control-plane RPCs per poll (nor let
        one unresponsive worker conn tax every caller)."""
        ts, cached = self._task_plane_cache
        now = time.monotonic()
        if now - ts < 2.0:
            return cached
        # stamp BEFORE the fan-out: concurrent node_stats callers in the
        # refresh window serve the stale dict instead of each re-running
        # the per-worker gather (single-flight-ish; a lost race just
        # refreshes twice)
        self._task_plane_cache = (now, cached)
        conns = [w.conn for w in self.workers.values()
                 if w.conn is not None and not w.conn.closed]
        conns += [c for c in self.drivers.values() if not c.closed]

        async def one(c):
            try:
                return await c.call_async("task_stats", None, timeout=1)
            except Exception:
                return None

        out = {"task_inline_hits": 0, "task_inline_bytes": 0,
               "worker_unsealed_creates": 0,
               "worker_window_outstanding": 0}
        for r in await asyncio.gather(*(one(c) for c in conns)):
            if r:
                out["task_inline_hits"] += int(r.get("task_inline_hits", 0))
                out["task_inline_bytes"] += int(
                    r.get("task_inline_bytes", 0)
                )
                lk = r.get("leaks") or {}
                out["worker_unsealed_creates"] += int(
                    lk.get("unsealed_creates", 0))
                out["worker_window_outstanding"] += int(
                    lk.get("actor_window_outstanding", 0))
        self._task_plane_cache = (now, out)
        return out

    async def _mesh_group_stats(self) -> Dict:
        """Gangs this node is a member of, from the GCS mesh-group
        registry: name -> {rank, ranks, host, epoch, state, steps,
        mesh_shape, last_failure, heal_state}. A gang runs one process
        per device, so a node holds ``ranks`` (its processes' ranks,
        ``rank`` the first of them) and is the gang's ``host``-th host.
        Cached for 2s like the task-plane fan-out; a GCS mid-restart
        yields the last cached view."""
        ts, cached = self._mesh_group_cache
        now = time.monotonic()
        if now - ts < 2.0:
            return cached
        self._mesh_group_cache = (now, cached)  # single-flight-ish
        out: Dict[str, Dict] = {}
        try:
            table = await self.gcs.call_async("mesh_group_table", None,
                                              timeout=2)
        except Exception:
            return cached
        me = self.node_id.hex()
        for name, rec in (table or {}).items():
            hosts = rec.get("host_index") or {}
            if me not in hosts:
                continue
            ranks = list((rec.get("ranks") or {}).get(me) or [])
            out[name] = {
                "rank": min(ranks) if ranks else None,
                "ranks": ranks,
                "host": hosts[me],
                "epoch": rec.get("epoch"),
                "state": rec.get("state"),
                "steps_run": rec.get("steps_run"),
                "hosts": rec.get("hosts"),
                "mesh_shape": rec.get("mesh_shape"),
                "last_failure": rec.get("last_failure") or "",
                "heal_state": rec.get("heal_state") or "",
            }
        self._mesh_group_cache = (now, out)
        return out

    async def rpc_ping(self, conn, _):
        return "pong"

    async def rpc_node_stats(self, conn, _):
        task_plane = await self._task_plane_stats()
        return {
            "node_id": self.node_id.hex(),
            # live label view (startup labels + GCS-side patches like a
            # MeshGroup's gang stamp) — the locality picker's inputs
            "labels": dict(self.labels),
            "available": self.available,
            "total": self.total_resources,
            # each card's id and the share of it no lease holds
            "gpu_cards": {"ids": list(self.card_ids),
                          "free": list(self.card_free)},
            "num_workers": len(self.workers),
            "num_idle": len(self.idle),
            "num_leases": len(self.leases),
            "queue_len": len(self.lease_queue),
            "demand": self._queued_demand(),
            "objects_served": self._objects_served,
            "outbound_chunks": self._outbound_chunks,
            "store": self.store.stats() if self.store else {},
            # GCS read caches (r11): object-location cache hit/miss/
            # invalidation counters + the pubsub-fed node-table churn —
            # how often steady-state pulls avoid a GCS round trip
            "gcs_cache": dict(self._gcs_cache_stats,
                              loc_entries=len(self._loc_cache),
                              node_entries=len(self.cluster_nodes)),
            "task_plane": task_plane,
            # resource-lifecycle leak ledger (r20): the runtime
            # counterpart of raylint R13 — every counter must return to
            # zero at quiesce (test teardown asserts it via
            # test_utils.assert_no_leaks). A persistently non-zero entry
            # means an acquire escaped its release path at runtime.
            "leaks": {
                "open_sinks": len(self._transfers),
                "partial_serves": len(self._partial_serves),
                "held_creator_pins": (self.store.unsealed_creates
                                      if self.store else 0),
                "unreleased_pool_conns":
                    self._peer_pool.stats()["in_use"],
                "worker_unsealed_creates":
                    task_plane.get("worker_unsealed_creates", 0),
                "worker_window_outstanding":
                    task_plane.get("worker_window_outstanding", 0),
            },
            # gang membership of this node (mesh-group compute plane):
            # rendezvous epoch, lifecycle state, steps, last failure
            "mesh_groups": await self._mesh_group_stats(),
            "transfer": {
                "bytes_in": self._transfer_bytes_in,
                "bytes_out": self._transfer_bytes_out,
                "last_pull_gbps": self._last_pull_gbps,
                "chunks_inflight": self._pull_chunks_inflight,
                "pulls_inflight": len(self._pulls_inflight),
                # remote fetches that landed a local copy (dedup'd: N
                # waiters on one in-flight pull count once) — the data
                # plane's re-read/transfer accounting
                "pulls_completed": self._pulls_completed,
                "pull_aborts": self._pull_aborts,
                "chunk_retries": self._transfer_chunk_retries,
                "peer_conns": self._peer_pool.stats(),
                # broadcast tree: chunks this node relayed onward from
                # in-progress pulls, pulls it rode through a tree parent,
                # and its last assigned position in the pull registry
                "partial_chunks_out": self._partial_chunks_out,
                # stripe picks whose first-choice peer shared this
                # node's host/gang label (locality-aware ordering)
                "locality_pref_hits": self._locality_pref_hits,
                "tree_pulls": self._tree_pulls,
                "tree_position": self._tree_position,
                "partial_serves_open": len(self._partial_serves),
            },
        }

    # ------------- per-node agent surface -------------
    # Parity: the reference runs a per-node dashboard agent process
    # (dashboard/agent.py + modules/reporter/reporter_agent.py:266
    # psutil-based worker stats, modules/log log tailing over HTTP).
    # Here the raylet IS the per-node daemon, so the collector lives in
    # it rather than in a sibling process — same data, one less process
    # to babysit per host.

    @staticmethod
    def _proc_stats(pid: int):
        """CPU seconds + RSS bytes for one pid from /proc (no psutil)."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            tick = os.sysconf("SC_CLK_TCK")
            cpu_s = (int(parts[11]) + int(parts[12])) / tick
            with open(f"/proc/{pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
            return {
                "cpu_seconds": round(cpu_s, 2),
                "rss_bytes": rss_pages * os.sysconf("SC_PAGE_SIZE"),
            }
        except Exception:
            return {"cpu_seconds": None, "rss_bytes": None}

    async def rpc_agent_stats(self, conn, _):
        """Live per-worker process stats + node memory + store fill
        (reference reporter_agent.py role)."""
        workers = {}
        for wid, w in self.workers.items():
            ws = self._proc_stats(w.proc.pid)
            ws["pid"] = w.proc.pid
            ws["idle"] = w in self.idle
            ws["lease_id"] = (
                w.lease_id.hex() if w.lease_id is not None else None
            )
            workers[wid.hex()[:12]] = ws
        mem_total = mem_avail = None
        try:
            # procfs: kernel-memory read, never touches disk — fast
            # raylint: disable=R1 — /proc read, not real file I/O
            with open("/proc/meminfo") as f:
                mi = dict(
                    line.split(":", 1) for line in f.read().splitlines()
                )
            mem_total = int(mi["MemTotal"].split()[0]) * 1024
            mem_avail = int(mi["MemAvailable"].split()[0]) * 1024
        except Exception:
            pass
        store = self.store.stats() if self.store else {}
        return {
            "node_id": self.node_id.hex(),
            "raylet": self._proc_stats(os.getpid()),
            "workers": workers,
            "host_mem_total": mem_total,
            "host_mem_available": mem_avail,
            "store_bytes_allocated": store.get("bytes_allocated"),
            "store_capacity": store.get("capacity"),
            "spilled_bytes": self.spilled_bytes,
        }

    async def rpc_tail_log(self, conn, req: Dict):
        """Tail a worker/raylet log file over the control plane
        (reference dashboard/modules/log HTTP tailing). ``req``:
        {"proc": "worker-<hex12>" | "raylet", "tail_bytes": n}.
        The proc name is resolved against this node's OWN log dir only
        (no path traversal: the name must match a live or past worker
        or the literal "raylet")."""
        proc = str(req.get("proc") or "")
        tail = min(int(req.get("tail_bytes") or 65536), 4 << 20)
        known = {f"worker-{w.hex()[:12]}" for w in self._ever_workers}
        known.add("raylet")
        if proc not in known:
            return {"error": f"unknown proc {proc!r}", "known":
                    sorted(known)}
        path = os.path.join(self.session_dir, "logs", f"{proc}.log")

        def read_tail():
            # thread (to_thread): up to 4 MB off disk must not stall the
            # event loop serving heartbeats/pulls (raylint R1)
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail))
                return size, f.read()

        try:
            size, data = await asyncio.to_thread(read_tail)
            return {"proc": proc, "size": size,
                    "data": data.decode("utf-8", "replace")}
        except FileNotFoundError:
            return {"proc": proc, "size": 0, "data": ""}


def main():
    import argparse
    import json

    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.fate_share import fate_share_with_parent

    fate_share_with_parent()

    p = argparse.ArgumentParser()
    p.add_argument("--sock")
    p.add_argument("--store")
    p.add_argument("--gcs")
    p.add_argument("--node-id")
    p.add_argument("--resources", default="{}")
    p.add_argument("--labels", default="{}")
    p.add_argument("--session-dir")
    p.add_argument("--config", default="")
    args = p.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="[raylet %(asctime)s] %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    chaos.install_from_env("raylet-" + args.node_id[:12])
    if args.config:
        GLOBAL_CONFIG.load(json.loads(args.config))

    # The shm store file must not outlive this raylet: when fate-sharing
    # SIGTERMs us (driver died), the pre-faulted arena's committed pages
    # would otherwise stay pinned in tmpfs until someone cleans /dev/shm.
    import signal

    def _unlink_store_and_exit(_sig, _frm):
        try:
            os.unlink(args.store)
        except OSError:
            pass
        os._exit(0)

    signal.signal(signal.SIGTERM, _unlink_store_and_exit)

    async def run():
        raylet = Raylet(
            node_id=bytes.fromhex(args.node_id),
            sock_path=args.sock,
            store_path=args.store,
            gcs_addr=args.gcs,
            resources=json.loads(args.resources),
            session_dir=args.session_dir,
            labels=json.loads(args.labels),
        )
        await raylet.start()
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    finally:
        try:
            os.unlink(args.store)
        except OSError:
            pass


if __name__ == "__main__":
    main()
