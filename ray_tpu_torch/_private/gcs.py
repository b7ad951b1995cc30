"""GCS: the head-node control plane (Global Control Service).

Parity: reference ``src/ray/gcs/gcs_server/`` — node membership
(gcs_node_manager.h:43), actor lifecycle FSM with max_restarts
(gcs_actor_manager.h:281, restart at gcs_actor_manager.cc:1117), internal KV
(gcs_kv_manager.h:101), function/code storage (gcs_function_manager.h:30),
job table (gcs_job_manager.h:41), health checking
(gcs_health_check_manager.h:39), pubsub publisher (src/ray/pubsub/).

Redesigns (TPU build): one asyncio loop instead of asio; push-based pubsub
over the persistent RPC connections instead of long-poll; actor placement is
delegated to the chosen raylet ("CreateActor" RPC) instead of GCS leasing
workers itself — the raylet owns its worker pool either way.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import chaos as _chaos
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.protocol import NodeInfo, TaskSpec

logger = logging.getLogger(__name__)

# Tie-break order when state timestamps collide (within one attempt the
# transitions happen fast enough to share a clock tick).
_STATE_ORDER = ["PENDING_NODE_ASSIGNMENT", "RUNNING", "FINISHED", "FAILED"]


def _latest_state(rec: Dict) -> str:
    if not rec["states"]:
        return "UNKNOWN"
    return max(
        rec["states"].items(),
        key=lambda kv: (kv[1], _STATE_ORDER.index(kv[0])
                        if kv[0] in _STATE_ORDER else -1),
    )[0]


# Actor FSM states (parity: rpc::ActorTableData::ActorState)
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"

# Placement-group states (parity: rpc::PlacementGroupTableData)
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_RESCHEDULING = "RESCHEDULING"
PG_REMOVED = "REMOVED"


class PgRecord:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "state", "assignment")

    def __init__(self, pg_id: bytes, bundles: List[Dict], strategy: str,
                 name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles  # list of resource dicts
        self.strategy = strategy  # PACK/SPREAD/STRICT_PACK/STRICT_SPREAD
        self.name = name
        self.state = PG_PENDING
        # node_id (bytes) per bundle; None = not placed
        self.assignment: List[Optional[bytes]] = [None] * len(bundles)

    def to_wire(self):
        return {
            "pg_id": self.pg_id,
            "bundles": self.bundles,
            "strategy": self.strategy,
            "name": self.name,
            "state": self.state,
            "assignment": self.assignment,
        }

    # journal/snapshot round-trip (same shape as the wire form)
    to_state = to_wire

    @classmethod
    def from_state(cls, d: Dict) -> "PgRecord":
        rec = cls(bytes(d["pg_id"]), [dict(b) for b in d["bundles"]],
                  d["strategy"], name=d.get("name") or "")
        rec.state = d["state"]
        rec.assignment = [
            bytes(a) if a is not None else None
            for a in (d.get("assignment") or [None] * len(rec.bundles))
        ]
        return rec


class ActorRecord:
    __slots__ = (
        "actor_id", "spec", "state", "address", "num_restarts",
        "restarts_left", "name", "death_cause", "owner_addr",
        "accelerator_ids",
    )

    def __init__(self, actor_id: bytes, spec: Dict, name: str = ""):
        self.actor_id = actor_id
        self.spec = spec  # TaskSpec wire dict of the creation task
        self.state = PENDING
        self.address: Optional[List] = None  # Address wire
        self.num_restarts = 0
        self.restarts_left = spec.get("max_restarts", 0)
        self.name = name
        self.death_cause = ""
        self.owner_addr = spec.get("owner")
        # the cards the actor's worker holds ({"GPU": [card id, ...]}), as
        # its raylet reported them at placement; {} off a card
        self.accelerator_ids: Dict = {}

    def to_wire(self):
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "address": self.address,
            "num_restarts": self.num_restarts,
            "name": self.name,
            "death_cause": self.death_cause,
            "method_meta": self.spec.get("method_meta") or {},
            "max_concurrency": self.spec.get("max_concurrency", 1),
            "resources": self.spec.get("resources") or {},
            "accelerator_ids": self.accelerator_ids,
        }

    def to_state(self) -> Dict:
        """Full durable state (journal/snapshot): unlike ``to_wire`` this
        carries the creation spec, so a restarted GCS can re-place."""
        return {
            "actor_id": self.actor_id,
            "spec": self.spec,
            "state": self.state,
            "address": self.address,
            "num_restarts": self.num_restarts,
            "restarts_left": self.restarts_left,
            "name": self.name,
            "death_cause": self.death_cause,
            "accelerator_ids": self.accelerator_ids,
        }

    @classmethod
    def from_state(cls, d: Dict) -> "ActorRecord":
        rec = cls(bytes(d["actor_id"]), d["spec"], name=d.get("name") or "")
        rec.state = d["state"]
        rec.address = d.get("address")
        rec.num_restarts = int(d.get("num_restarts", 0))
        rec.restarts_left = int(d.get("restarts_left", 0))
        rec.death_cause = d.get("death_cause") or ""
        rec.accelerator_ids = dict(d.get("accelerator_ids") or {})
        return rec


class GcsJournal:
    """Append-only mutation log: the file backend's answer to a LIVE GCS
    SIGKILL with NO snapshot-flush window (role parity: the reference's
    Redis store client, redis_store_client.h:33 — every mutation is
    durable at ack time, not at the next snapshot tick).

    GROUP COMMIT (r11): mutating RPCs ``buffer()`` their records and the
    server flushes the whole batch with ONE ``write()+flush()`` (and one
    fsync when ``gcs_journal_fsync`` is set) at the end of the event-loop
    tick — the RPC replies are deferred until the covering flush lands,
    so every acked mutation is still durable at ack time.
    ``write()+flush()`` lands the bytes in the OS page cache, which
    survives process death (fsync additionally buys power-loss
    durability). Restore = snapshot + ``.old`` journal (if a rotation's
    snapshot never landed) + current journal, in order — records are
    absolute values, so replay is idempotent and a torn tail (killed
    mid-append) is skipped, not raised.

    Frame format (UNCHANGED by batching — a batch is just N consecutive
    frames, so pre-group-commit journals replay byte-compatibly):
    [u32 len][msgpack record].
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        # A SIGKILL mid-append leaves a torn final record; appending
        # after it would strand every later record behind the tear
        # (replay stops at the first bad frame). Truncate back to the
        # last whole-frame boundary before reopening for append.
        torn = self.scan_valid_prefix(path)
        if torn is not None:
            with open(path, "r+b") as f:
                f.truncate(torn)
        self._f = open(path, "ab")
        self.appended = 0  # records flushed (durable)
        self.flushes = 0   # write+flush batches (group-commit batching)
        self._buf = bytearray()
        self._buf_records = 0

    @property
    def buffered(self) -> int:
        return self._buf_records

    def buffer(self, rec) -> int:
        """Frame one record into the in-memory batch; returns the batch
        depth. Durable only after the next :meth:`flush_buffered`."""
        body = rpc.msgpack.packb(rec, use_bin_type=True)
        self._buf += len(body).to_bytes(4, "big") + body
        self._buf_records += 1
        return self._buf_records

    def take_batch(self) -> Tuple[bytes, int]:
        """Snapshot-and-clear the buffered batch. Must run on the thread
        that calls :meth:`buffer` (the event loop): the swap is not
        atomic, so doing it from an executor could race a concurrent
        ``buffer()`` and silently drop an acked record."""
        buf, n = bytes(self._buf), self._buf_records
        self._buf = bytearray()
        self._buf_records = 0
        return buf, n

    def write_batch(self, buf: bytes, n: int) -> int:
        """Write one already-taken batch with one write+flush (+ one
        fsync when enabled); returns the record count that became
        durable. Touches only the file handle and counters, so it is
        safe on an executor thread while the loop keeps buffering the
        NEXT batch."""
        if not n:
            return 0
        self._f.write(buf)
        self._f.flush()  # into the page cache: survives SIGKILL
        if self.fsync:
            os.fsync(self._f.fileno())
        self.appended += n
        self.flushes += 1
        return n

    def flush_buffered(self) -> int:
        """take_batch + write_batch inline (loop-side or no-loop
        contexts: append(), rotate(), close(), the fsync-off path)."""
        return self.write_batch(*self.take_batch())

    def append(self, rec) -> None:
        """Per-record append (buffer + immediate flush): the
        pre-group-commit shape, kept for unit tests and as the
        ``gcs_journal_batch_max=1`` semantics."""
        self.buffer(rec)
        self.flush_buffered()

    def append_frames(self, frames: List[bytes]) -> int:
        """Append already-framed records verbatim (one write+flush): the
        standby's journal write side — shipped batches arrive as the
        primary's raw frames and must land byte-identical, so a
        promotion's replay sees exactly the primary's log."""
        for fb in frames:
            self._buf += fb
        self._buf_records += len(frames)
        return self.flush_buffered()

    def rotate(self) -> str:
        """Move the current log aside (journal.old) and start fresh; the
        caller snapshots the tables in the same event-loop tick, so the
        ``.old`` file is exactly the delta the pending snapshot covers.
        Must only be called when no ``.old`` exists (i.e. the previous
        snapshot landed) — otherwise un-snapshotted records would be
        overwritten."""
        self.flush_buffered()  # buffered records belong to this segment
        self._f.close()
        old = self.path + ".old"
        os.replace(self.path, old)
        self._f = open(self.path, "ab")
        return old

    def reset(self) -> None:
        """Truncate (state fully captured by a just-written snapshot)."""
        self._buf = bytearray()
        self._buf_records = 0
        self._f.close()
        self._f = open(self.path, "wb")

    def close(self) -> None:
        try:
            self.flush_buffered()
        except Exception:
            pass
        try:
            self._f.close()
        except Exception:
            pass

    @staticmethod
    def scan_valid_prefix(path: str) -> Optional[int]:
        """Byte length of the whole-frame prefix of ``path``, or None
        when the file is absent/fully clean. A torn tail (SIGKILL
        mid-append) shows up as a trailing partial frame — the returned
        offset is where an appender must truncate to keep later records
        reachable by replay."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        good = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                n = int.from_bytes(hdr, "big")
                body = f.read(n)
                if len(body) < n:
                    break
                good += 4 + n
        return good if good < size else None

    @staticmethod
    def replay(path: str):
        """Yield records until EOF or the first torn/corrupt frame (a
        SIGKILL mid-append leaves a truncated final record: skip it —
        only the un-acked tail mutation is lost — never raise)."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return
        with f:
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    if hdr:
                        logger.warning(
                            "journal %s: torn tail (partial length "
                            "word) skipped", path)
                    return
                n = int.from_bytes(hdr, "big")
                body = f.read(n)
                if len(body) < n:
                    logger.warning(
                        "journal %s: torn tail (%d of %d body bytes) "
                        "skipped", path, len(body), n)
                    return
                try:
                    yield rpc.msgpack.unpackb(body, raw=False)
                except Exception:
                    logger.warning(
                        "journal %s: undecodable record skipped "
                        "(replay stops here)", path)
                    return


class GcsJournalTailer:
    """Record-exact incremental reader of a LIVE journal that the writer
    may rotate (``rotate()`` os.replace's current → ``.old``) under it
    at any moment — the journal-shipping read side.

    The rotation race this closes: a naive tailer holding an offset into
    the journal PATH loses the rotated-out tail (the path suddenly names
    an empty file) or re-reads from 0. This tailer holds the open FD:
    POSIX keeps the renamed segment's bytes readable through it, so the
    handoff drains the old segment to EOF — the writer never appends to
    a rotated-out file again — and only then reopens the path at offset
    0. The switch therefore lands at an exact record boundary: no frame
    is split across segments, none is skipped, none repeats.

    A trailing partial frame (the tailer racing the writer's in-flight
    ``write()``) is left unconsumed — the next call re-reads it whole.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._ino = None
        self.records = 0    # total records yielded since construction
        self.rotations = 0  # segment handoffs observed
        # open EAGERLY: the fd must be pinned to the current segment
        # BEFORE any rotation can happen, or a rotate-before-first-read
        # would silently skip the rotated-out records (the lazy open
        # would land on the fresh post-rotation file)
        self._open_current()

    def _open_current(self) -> bool:
        try:
            self._f = open(self.path, "rb")
        except FileNotFoundError:
            self._f = None
            return False
        self._ino = os.fstat(self._f.fileno()).st_ino
        return True

    def _drain(self, out: List[bytes]):
        """Whole frames from the held fd's position to EOF; a partial
        tail rewinds so the next drain re-reads it complete."""
        f = self._f
        while True:
            start = f.tell()
            hdr = f.read(4)
            if len(hdr) < 4:
                f.seek(start)
                return
            n = int.from_bytes(hdr, "big")
            body = f.read(n)
            if len(body) < n:
                f.seek(start)
                return
            out.append(hdr + body)

    def read_new(self) -> List[bytes]:
        """Every record frame (raw ``[u32 len][msgpack]`` bytes) that
        became readable since the last call, in append order, each
        exactly once — across any number of rotations."""
        out: List[bytes] = []
        for _ in range(64):  # bounds a pathological rotate storm
            if self._f is None and not self._open_current():
                break
            st = os.fstat(self._f.fileno())
            if st.st_size < self._f.tell():
                # truncated in place under us (writer reset()): the
                # whole file is new content
                self._f.seek(0)
            self._drain(out)
            try:
                cur_ino = os.stat(self.path).st_ino
            except FileNotFoundError:
                break  # current unlinked (shutdown); nothing newer
            if cur_ino == self._ino:
                break  # same segment, drained to its frame tail
            # rotated under us: the writer flushed nothing more into the
            # old segment after the rename, so one final drain of the
            # held fd empties it — then hand off to the new current
            self._drain(out)
            self._f.close()
            self._f = None
            self.rotations += 1
        self.records += len(out)
        return out

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class GcsServer:
    def __init__(self, sock_path: str, storage_path: Optional[str] = None,
                 peer_addrs: Optional[List[str]] = None):
        self.sock_path = sock_path
        # GCS epoch (failover fencing): bumped by exactly one on every
        # standby promotion, persisted in the snapshot and as an
        # "epoch" journal record so it survives any crash. Every reply
        # this server sends is stamped with it (rpc.set_epoch_provider)
        # and requests minted under a lower epoch are refused typed.
        self.epoch = 1
        # other GCS endpoints (the standby, or after promotion the old
        # primary): probed by _standby_watch_loop for split-brain
        # fencing whenever no standby is subscribed
        self.peer_addrs = [a for a in (peer_addrs or []) if a]
        self._fenced = asyncio.Event()
        self._fence_task: Optional[asyncio.Task] = None
        # file-backed table persistence (parity: reference Redis GCS FT,
        # gcs_table_storage.h:252 / redis_store_client.h:33): KV + jobs
        # reload across GCS restarts; runtime state (nodes, actors) is
        # re-established by raylets re-registering.
        self.storage_path = storage_path
        self._dirty = False
        # Seeded under an installed chaos plane: placement picks replay
        # identically for the same chaos seed (raylint R4).
        self._rng = _chaos.replay_rng("gcs")
        from ray_tpu_torch._private.conduit_rpc import make_server

        self.server = make_server(
            sock_path, rpc.handler_table(self), name="gcs"
        )
        # tables
        self.kv: Dict[str, bytes] = {}
        self.nodes: Dict[bytes, NodeInfo] = {}
        self.node_heartbeat: Dict[bytes, float] = {}
        self.node_resources: Dict[bytes, Dict] = {}  # available/total per node
        self.actors: Dict[bytes, ActorRecord] = {}
        self.named_actors: Dict[str, bytes] = {}
        self.placement_groups: Dict[bytes, PgRecord] = {}
        self.jobs: Dict[bytes, Dict] = {}
        self.task_events: Dict[bytes, Dict] = {}  # insertion-ordered
        # pubsub: channel -> set of connections
        self.subs: Dict[str, Set[rpc.Connection]] = {}
        # broadcast-tree pull registry: oid -> in-progress puller node
        # ids in ARRIVAL ORDER (transient — not journaled; a GCS restart
        # just degrades concurrent pulls to direct source fetches until
        # they re-register). Parents are always EARLIER arrivals, so the
        # assignment can never cycle.
        self._pulls: Dict[bytes, List[bytes]] = {}
        # mesh-group registry: gang name -> controller-published record
        # (membership, rendezvous epoch, steps, last failure). Transient
        # observability like the pull registry — not journaled; the
        # controller republishes on every state change, so a restarted
        # GCS repopulates at the gang's next transition.
        self.mesh_groups: Dict[str, Dict] = {}
        # autoscaler intents: intent key (e.g. "heal:<gang>") -> record
        # naming the queued-resource request in flight. JOURNALED, unlike
        # the registries above: an intent is the only durable evidence a
        # replacement slice was requested — lose it across a GCS SIGKILL
        # and a healer either leaks the pending request or files a duplicate.
        self.autoscaler_intents: Dict[str, Dict] = {}
        self._raylet_clients: Dict[bytes, rpc.Connection] = {}
        self._health_task: Optional[asyncio.Task] = None
        self._started = asyncio.Event()
        # mutation journal (file backend only): effectively the WAL of the
        # tables; see GcsJournal. ``_recovering`` holds journal-restored
        # actors awaiting their raylet's restore_actors replay.
        self._journal_w: Optional[GcsJournal] = None
        self._journal_rotated_old: Optional[str] = None
        self._recovering: Set[bytes] = set()
        # group-commit state: one pending flush future covers every
        # record buffered since the previous flush; handlers await it
        # before replying (durable-at-ack). ``_journal_flushing`` keeps
        # executor-side fsync flushes single-file so batches land in
        # buffer order.
        self._journal_flush_fut: Optional[asyncio.Future] = None
        self._journal_flush_handle = None
        self._journal_flushing = False
        # journal shipping: subscribed standby conns -> stats,
        # the tailer feeding them, the buffered-record counter that
        # numbers the stream, and the ack-gating waiters (handlers
        # blocked until the standby APPLIES their covering batch)
        self._standby_conns: Dict[rpc.Connection, Dict] = {}
        self._ship_tailer: Optional[GcsJournalTailer] = None
        self._journal_seq = 0     # records buffered since journal reset
        self._standby_acked = 0   # highest standby-applied seq
        self._ship_waiters: List[Tuple[int, asyncio.Future]] = []

    # ---------------- lifecycle ----------------
    async def start(self, preloaded: bool = False):
        """``preloaded=True`` is the standby-promotion entry: the tables
        and ``_journal_w`` were populated live by the ship stream (and
        ``epoch`` already bumped + journaled), so storage load is
        skipped — everything else (startup compaction, recovery marks,
        bind, loops) runs exactly like a restart."""
        if not preloaded:
            self._load_storage()
            if self.storage_path:
                self._journal_w = GcsJournal(
                    self.storage_path + ".journal",
                    fsync=GLOBAL_CONFIG.gcs_journal_fsync,
                )
        else:
            self._derive_restore_state()
        if self._journal_w is not None:
            # startup compaction: everything just restored goes into one
            # fresh snapshot, then both journals reset — replay stays O(one
            # snapshot interval), not O(uptime)
            try:
                # fsync-bearing snapshot write; nothing serves yet, but a
                # multi-ms stall on the loop here delays first heartbeat
                # registration (raylint R7)
                await asyncio.to_thread(self._startup_compact)
            except Exception:
                logger.exception("GCS startup snapshot compaction failed")
            # ship read side: the tailer follows the freshly-reset
            # journal; seq numbering restarts with it
            self._journal_seq = 0
            self._standby_acked = 0
            self._ship_tailer = GcsJournalTailer(
                self.storage_path + ".journal")
        # every reply from this process now carries the epoch; stale-
        # epoch requests get the typed refusal (rpc.run_idempotent)
        rpc.set_epoch_provider(lambda: self.epoch)
        await self.server.start_async()
        loop = asyncio.get_running_loop()
        self._health_task = loop.create_task(self._health_loop())
        if self.storage_path:
            self._persist_task = loop.create_task(self._persist_loop())
        if self.peer_addrs:
            self._fence_task = loop.create_task(self._standby_watch_loop())
        if self._recovering or any(
            pg.state in (PG_PENDING, PG_RESCHEDULING)
            for pg in self.placement_groups.values()
        ):
            rpc.spawn(self._recover_after_grace())
        self._started.set()

    async def stop(self):
        if self._health_task:
            self._health_task.cancel()
        if self._fence_task is not None and not self._fenced.is_set():
            self._fence_task.cancel()
        self._drop_standbys()
        if self._ship_tailer is not None:
            self._ship_tailer.close()
        if getattr(self, "_persist_task", None):
            self._persist_task.cancel()
            if self.storage_path:
                # same split as _persist_loop: consistent copy on the
                # loop, fsync-bearing flush off it (raylint R7)
                snap = self._snapshot()
                await asyncio.to_thread(self._flush_snapshot, snap)
        if self._journal_w is not None:
            self._journal_w.close()
        await self.server.stop_async()

    # ---------------- persistence (file backend) ----------------

    def _mirror_storage(self):
        """External-storage mirror for snapshots (``gcs_snapshot_mirror_
        uri``): the answer to a LOST HEAD VOLUME, which the local file
        backend cannot survive. Role parity: the reference's Redis GCS
        tier (redis_store_client.h:33) — here a replicated-object write
        to the same pluggable bucket interface spilling uses. The
        backend is memoized per URI (a bucket client per 0.5s snapshot
        tick would re-auth constantly)."""
        uri = GLOBAL_CONFIG.gcs_snapshot_mirror_uri
        if not uri:
            return None
        cached = getattr(self, "_mirror_cache", None)
        if cached is not None and cached[0] == uri:
            return cached[1]
        from ray_tpu_torch._private.external_storage import storage_from_uri

        backend = storage_from_uri(uri)
        self._mirror_cache = (uri, backend)
        return backend

    def _load_storage(self):
        if not self.storage_path:
            return
        import pickle

        snap = None
        if os.path.exists(self.storage_path):
            try:
                with open(self.storage_path, "rb") as f:
                    snap = pickle.load(f)
            except Exception:
                logger.exception("failed to load local GCS snapshot")
        if snap is None:
            # local volume gone/corrupt: restore from the mirror
            try:
                mirror = self._mirror_storage()
                if mirror is not None:
                    data = mirror.get(mirror.uri_for("gcs/snapshot"))
                    snap = pickle.loads(data)
                    logger.info("restored GCS tables from mirror %s",
                                GLOBAL_CONFIG.gcs_snapshot_mirror_uri)
            except FileNotFoundError:
                logger.info("no GCS snapshot mirror object; starting empty")
            except Exception:
                # a mirror that EXISTS but cannot be read is the failure
                # the operator must see, not an info line
                logger.exception(
                    "GCS snapshot mirror exists but is unreadable; "
                    "starting empty"
                )
        if snap is not None:
            self.kv = snap.get("kv", {})
            self.jobs = snap.get("jobs", {})
            self.autoscaler_intents = dict(snap.get("intents") or {})
            self.epoch = int(snap.get("epoch") or 1)
            for d in snap.get("actors") or []:
                rec = ActorRecord.from_state(d)
                self.actors[rec.actor_id] = rec
            for d in snap.get("pgs") or []:
                rec = PgRecord.from_state(d)
                self.placement_groups[rec.pg_id] = rec
        # journal replay ON TOP of the snapshot: ``.old`` first (exists
        # only when a rotation's snapshot never landed), then the current
        # log. Records are absolute values — replay is idempotent.
        replayed = 0
        for path in (self.storage_path + ".journal.old",
                     self.storage_path + ".journal"):
            for rec in GcsJournal.replay(path):
                try:
                    self._journal_apply(rec)
                    replayed += 1
                except Exception:
                    logger.exception("bad journal record skipped: %r",
                                     rec[:1])
        if snap is None and not replayed:
            return
        self._derive_restore_state(replayed)

    def _derive_restore_state(self, replayed: int = 0):
        """Post-restore reconciliation, shared by the restart path and a
        standby promotion (whose tables arrived via the ship stream):
        the named-actor index and the raylet-reclaim recovery marks
        derive from the restored records."""
        for rec in self.actors.values():
            if rec.name and rec.state != DEAD:
                self.named_actors.setdefault(rec.name, rec.actor_id)
            if rec.state in (ALIVE, PENDING, RESTARTING):
                # the worker may well still be alive — wait for its raylet
                # to re-register and reclaim it before re-placing
                rec.state = RESTARTING
                self._recovering.add(rec.actor_id)
        logger.info(
            "restored GCS tables (%d kv keys, %d jobs, %d actors, %d pgs; "
            "%d journal records replayed; epoch %d)",
            len(self.kv), len(self.jobs), len(self.actors),
            len(self.placement_groups), replayed, self.epoch,
        )

    def _journal_apply(self, rec: List):
        op = rec[0]
        if op == "kv":
            key, value = rec[1], rec[2]
            if value is None:
                self.kv.pop(key, None)
            else:
                self.kv[key] = value
        elif op == "job":
            self.jobs[bytes(rec[1])] = rec[2]
        elif op == "actor":
            arec = ActorRecord.from_state(rec[1])
            self.actors[arec.actor_id] = arec
            if arec.name and arec.state == DEAD and (
                self.named_actors.get(arec.name) == arec.actor_id
            ):
                self.named_actors.pop(arec.name, None)
        elif op == "pg":
            prec = PgRecord.from_state(rec[1])
            self.placement_groups[prec.pg_id] = prec
        elif op == "intent":
            key, value = str(rec[1]), rec[2]
            if value is None:
                self.autoscaler_intents.pop(key, None)
            else:
                self.autoscaler_intents[key] = dict(value)
        elif op == "epoch":
            # promotion fence record: epochs only move forward (a
            # shipped/replayed stale bump must never regress a newer one)
            self.epoch = max(self.epoch, int(rec[1]))

    # -- journal write side (no-ops on the memory backend) --
    def _journal(self, rec: List) -> Optional[asyncio.Future]:
        """Group-commit append: frame ``rec`` into the journal's batch
        buffer and return the future of the COVERING flush (mutations
        within one event-loop tick share a single write+flush+fsync).
        Mutating RPC handlers ``await`` the returned future before
        replying — the durable-at-ack contract of the old per-record
        ``append()`` at amortized-batch cost. Background mutation paths
        (placement loops, node-death sweeps) may drop the future: their
        records ride the same batch and no client is awaiting an ack."""
        j = self._journal_w
        if j is None:
            return None
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (unit tests / teardown): per-record semantics
            try:
                j.append(rec)
                self._journal_seq += 1
            except Exception:
                logger.exception(
                    "GCS journal append failed; journaling disabled")
                self._journal_w = None
            self._mark_dirty()
            return None
        try:
            depth = j.buffer(rec)
        except Exception:
            logger.exception("GCS journal append failed; journaling disabled")
            self._journal_w = None
            self._mark_dirty()
            return None
        self._journal_seq += 1
        self._mark_dirty()
        fut = self._journal_flush_fut
        if fut is None or fut.done():
            fut = self._journal_flush_fut = loop.create_future()
        # stream position of the LAST record the covering flush includes:
        # _journal_wait's standby ack gate waits for the standby to apply
        # through here (conservative for earlier records in the batch —
        # the whole batch ships as one notify anyway)
        fut._gcs_seq = self._journal_seq
        if depth >= max(1, int(GLOBAL_CONFIG.gcs_journal_batch_max)):
            self._flush_journal_now()
        elif self._journal_flush_handle is None and not self._journal_flushing:
            interval = GLOBAL_CONFIG.gcs_journal_flush_interval_s
            if interval and interval > 0:
                self._journal_flush_handle = loop.call_later(
                    interval, self._flush_journal_now)
            else:
                # end-of-tick flush: call_soon runs after the currently
                # ready callbacks, so every handler that buffered in
                # this tick shares the batch
                self._journal_flush_handle = loop.call_soon(
                    self._flush_journal_now)
        return fut

    def _flush_journal_now(self):
        """Group-commit flush; runs on the event loop. With fsync off
        the batched write+flush lands inline (page-cache write — the
        same cost the old per-record path paid per mutation, now per
        BATCH); with fsync on, the file IO runs in the default executor
        so the ~ms sync never stalls heartbeats/RPCs on the loop
        (raylint R1's loop-inline contract)."""
        h, self._journal_flush_handle = self._journal_flush_handle, None
        if h is not None:
            h.cancel()
        if self._journal_flushing:
            return  # in-flight executor flush re-runs this on completion
        j = self._journal_w
        fut, self._journal_flush_fut = self._journal_flush_fut, None
        if j is None or not j.buffered:
            if fut is not None and not fut.done():
                fut.set_result(True)
            return
        if not j.fsync:
            try:
                j.flush_buffered()
            except Exception:
                logger.exception(
                    "GCS journal flush failed; journaling disabled")
                self._journal_w = None
            if fut is not None and not fut.done():
                fut.set_result(True)
            self._ship_pump()
            return
        loop = asyncio.get_running_loop()
        self._journal_flushing = True
        # swap the batch out HERE on the loop — the executor gets an
        # immutable snapshot, so handlers buffering mid-flush can't
        # race the swap (their records form the next batch, re-flushed
        # by _done below)
        buf, n = j.take_batch()

        def _done(task):
            self._journal_flushing = False
            if task.exception() is not None:
                logger.error("GCS journal flush failed; journaling "
                             "disabled: %r", task.exception())
                self._journal_w = None
            else:
                self._ship_pump()
            if fut is not None and not fut.done():
                fut.set_result(True)
            if self._journal_w is not None and self._journal_w.buffered:
                self._flush_journal_now()  # records buffered mid-flush
            elif self._journal_flush_fut is not None:
                # journaling just got disabled (or the mid-flush batch
                # emptied some other way): handlers that buffered while
                # this flush was in flight await the SUCCESSOR future —
                # resolve it or their RPC replies hang forever (matches
                # the disabled-journal contract: mutations apply
                # unjournaled, acks still go out)
                nxt, self._journal_flush_fut = self._journal_flush_fut, None
                if not nxt.done():
                    nxt.set_result(True)

        loop.run_in_executor(
            None, j.write_batch, buf, n).add_done_callback(_done)

    async def _journal_wait(self, fut: Optional[asyncio.Future]):
        """Durable-at-ack barrier: await the flush covering a just-
        buffered record (no-op on the memory backend). With a standby
        subscribed and ``gcs_standby_ack`` on, "durable" additionally
        means standby-APPLIED: the ack only goes out once the covering
        batch landed on the standby, so a primary SIGKILL immediately
        after the ack can never lose the mutation across the failover.
        Degrades (never blocks the control plane) when the standby
        misses the ack window."""
        if fut is None:
            return
        await fut
        seq = getattr(fut, "_gcs_seq", 0)
        if (seq and self._standby_conns
                and GLOBAL_CONFIG.gcs_standby_ack):
            await self._await_standby_ack(seq)

    def _journal_actor(self, rec: "ActorRecord") -> Optional[asyncio.Future]:
        if self._journal_w is not None:
            return self._journal(["actor", rec.to_state()])
        return None

    def _journal_pg(self, rec: "PgRecord") -> Optional[asyncio.Future]:
        if self._journal_w is not None:
            return self._journal(["pg", rec.to_state()])
        return None

    # ---------------- journal shipping + failover fencing ------

    def _ship_pump(self):
        """Stream newly-flushed journal frames to subscribed standbys;
        runs (on the loop) after EVERY flush, even with no subscriber —
        the tailer's record counter must stay aligned with the journal
        or a later subscriber's stream would be misnumbered. The tailer
        hands segments off at exact record boundaries across rotations,
        so a shipped batch is always whole records."""
        t = self._ship_tailer
        if t is None:
            return
        try:
            frames = t.read_new()
        except Exception:
            logger.exception("journal ship tailer failed; shipping "
                             "disabled until restart")
            self._ship_tailer = None
            self._drop_standbys()
            return
        if not frames or not self._standby_conns:
            return
        batch = {"epoch": self.epoch, "seq": t.records - len(frames),
                 "recs": frames}
        for conn in list(self._standby_conns):
            rpc.spawn(self._ship_send(conn, batch))

    async def _ship_send(self, conn: rpc.Connection, batch: Dict):
        try:
            await conn.notify_async("journal_batch", batch)
        except Exception:
            conn._do_close()  # close callback runs _on_standby_gone

    async def rpc_journal_sync(self, conn, data):
        """Standby bootstrap + ship subscription: registers ``conn`` as
        a journal-stream subscriber and returns the full table state
        with its covering stream seq — both in THIS event-loop tick, so
        snapshot, seq and stream are mutually consistent (no flush can
        land between the copy and the subscribe). Shipped records with
        index < the returned seq are duplicates the standby skips."""
        if self._journal_w is None or self._ship_tailer is None:
            return {"ok": False,
                    "error": "journal shipping unavailable (no journal)"}
        conn.chaos_peer = "standby"
        self._standby_conns[conn] = {"acked": 0, "since": time.time()}
        conn.add_close_callback(self._on_standby_gone)
        logger.info("journal ship subscriber attached (%d standby%s)",
                    len(self._standby_conns),
                    "" if len(self._standby_conns) == 1 else "s")
        return {
            "ok": True,
            "epoch": self.epoch,
            "seq": self._journal_seq,
            "snap": self._tables_state(),
        }

    async def rpc_journal_ack(self, conn, data):
        """Standby apply-progress: resolves the durable-at-ack waiters
        whose records the standby has now applied."""
        ent = self._standby_conns.get(conn)
        seq = int(data.get("seq") or 0)
        if ent is not None:
            ent["acked"] = seq
        if seq > self._standby_acked:
            self._standby_acked = seq
            self._resolve_ship_waiters(seq)
        return True

    async def rpc_gcs_probe(self, conn, data):
        """Peer/diagnostic probe: epoch + role, no registration needed
        (the split-brain fence and the standby's liveness ping ride
        this)."""
        return {"epoch": self.epoch, "role": "primary",
                "fenced": self._fenced.is_set()}

    def _on_standby_gone(self, conn):
        if self._standby_conns.pop(conn, None) is None:
            return
        logger.warning("journal ship subscriber lost (%d remain)",
                       len(self._standby_conns))
        if not self._standby_conns:
            # no applier left: durable-at-ack degrades to primary-disk;
            # blocked handlers must not each wait out the full timeout
            self._resolve_ship_waiters(None)

    def _drop_standbys(self):
        for conn in list(self._standby_conns):
            try:
                conn._do_close()
            except Exception:
                pass
        self._standby_conns.clear()
        self._resolve_ship_waiters(None)

    def _resolve_ship_waiters(self, upto: Optional[int]):
        """Release ack-gate waiters with seq <= ``upto`` (None = all)."""
        keep: List[Tuple[int, asyncio.Future]] = []
        for seq, fut in self._ship_waiters:
            if upto is None or seq <= upto:
                if not fut.done():
                    fut.set_result(True)
            else:
                keep.append((seq, fut))
        self._ship_waiters = keep

    async def _await_standby_ack(self, seq: int):
        if seq <= self._standby_acked or not self._standby_conns:
            return
        fut = asyncio.get_running_loop().create_future()
        self._ship_waiters.append((seq, fut))
        window = max(0.1, GLOBAL_CONFIG.gcs_standby_ack_timeout_s)
        try:
            await asyncio.wait_for(fut, window)
        except asyncio.TimeoutError:
            # availability over the stronger tier: a wedged standby must
            # not stall every control-plane ack — drop it (it will
            # resync when healthy) and serve at primary-disk durability
            logger.warning(
                "standby apply-ack for seq %d missed the %.1fs window; "
                "degrading durable-at-ack to primary-disk and dropping "
                "the standby subscription", seq, window)
            self._drop_standbys()

    async def _standby_watch_loop(self):
        """Split-brain guard on any GCS started with peer endpoints:
        while no standby is subscribed (a subscribed standby cannot have
        promoted), probe the peers — one serving at a HIGHER epoch means
        this instance was failed over while dead or partitioned. Fence:
        stop serving (the daemon exits with code 3) instead of feeding
        stale acks to clients that haven't learned the new epoch yet.
        Clients that HAVE seen the new epoch reject this instance on
        their own (reply-epoch regression); this loop closes the window
        for the rest."""
        period = max(0.5, GLOBAL_CONFIG.gcs_failover_grace_s / 2.0)
        while not self._fenced.is_set():
            await asyncio.sleep(period)
            if self._standby_conns:
                continue
            for addr in self.peer_addrs:
                conn = None
                try:
                    conn = await rpc.connect_async(
                        addr, timeout=1.0, name="gcs->peer")
                    r = await conn.call_async("gcs_probe", None,
                                              timeout=2.0)
                except Exception:
                    continue  # peer down/unreachable: nothing to fence on
                finally:
                    if conn is not None:
                        conn._do_close()
                ep = int(r.get("epoch") or 0) if isinstance(r, dict) else 0
                if ep > self.epoch:
                    self._fence(ep)
                    return

    def _fence(self, peer_epoch: int):
        if self._fenced.is_set():
            return
        logger.critical(
            "GCS epoch-fenced: a peer serves at epoch %d > ours %d "
            "(promoted while this instance was dead or partitioned); "
            "ceasing to serve", peer_epoch, self.epoch)
        self._fenced.set()
        rpc.spawn(self.stop())

    async def _recover_after_grace(self):
        """Journal-restored runtime state reconciliation: give raylets one
        grace window to re-register and reclaim their live actors
        (rpc_restore_actors); whatever stays unclaimed is re-placed from
        its journaled spec. Restarts spent on recovery are free — the
        actor didn't crash, the GCS did."""
        await asyncio.sleep(GLOBAL_CONFIG.gcs_actor_recovery_grace_s)
        for aid in list(self._recovering):
            self._recovering.discard(aid)
            rec = self.actors.get(aid)
            if rec is None or rec.state != RESTARTING:
                continue
            logger.info("re-placing journal-restored actor %s "
                        "(raylet never reclaimed it)", aid.hex()[:12])
            rec.address = None
            self._journal_actor(rec)
            rpc.spawn(self._place_actor(rec))
        for pg in self.placement_groups.values():
            if pg.state in (PG_PENDING, PG_RESCHEDULING):
                rpc.spawn(self._place_pg(pg))

    def _mark_dirty(self):
        self._dirty = True

    def _snapshot(self) -> Dict:
        """Copy tables ON the event-loop thread (no concurrent mutation) and
        clear the dirty flag atomically with the copy — a put landing after
        this is a NEW dirty state. The journal rotates in the same tick, so
        ``.old`` holds exactly the delta this snapshot captures; rotation
        is skipped while a previous ``.old`` is still pending (its
        snapshot flush failed), which only means a longer replay."""
        self._dirty = False
        # never rotate while an executor-side fsync flush is mid-write
        # (rotate() would swap the file under it) or while records sit
        # buffered awaiting their group-commit flush (rotate() flushes
        # them INLINE — with fsync on that's ms of disk wait on the
        # loop, the exact stall the executor hop exists to avoid).
        # Skipping just means a longer replay, same as a still-pending
        # ``.old``
        if (self._journal_w is not None
                and self._journal_rotated_old is None
                and not self._journal_flushing
                and not self._journal_w.buffered):
            old = self.storage_path + ".journal.old"
            if not os.path.exists(old):
                try:
                    self._journal_rotated_old = self._journal_w.rotate()
                except Exception:
                    logger.exception("journal rotation failed")
        return self._tables_state()

    def _tables_state(self) -> Dict:
        """Pure copy of the journal-backed tables (+ epoch) — the
        snapshot payload, also the ``journal_sync`` bootstrap a standby
        loads. No side effects: callers that need the rotation/dirty
        bookkeeping use :meth:`_snapshot`. Runs on the event loop, so
        the copy is a consistent point-in-time state."""
        return {
            "kv": dict(self.kv),
            "jobs": dict(self.jobs),
            "actors": [r.to_state() for r in self.actors.values()],
            "pgs": [r.to_state() for r in self.placement_groups.values()],
            "intents": {k: dict(v)
                        for k, v in self.autoscaler_intents.items()},
            "epoch": self.epoch,
        }

    def _write_snapshot(self, blob: bytes):
        """Atomic snapshot write (pre-serialized bytes — pickled once,
        shared with the mirror upload). Durability policy is CONFIGURABLE
        (VERDICT r3 weak #9): ``gcs_snapshot_fsync`` additionally
        fsyncs the data and the directory entry, so a committed snapshot
        survives host power loss — at ~ms write cost. Off by default:
        the file backend's threat model is GCS *process* death (the
        rename is crash-atomic for that), and lost-disk recovery is the
        mirror/Redis tier's job, not this one's."""
        tmp = self.storage_path + f".tmp.{os.urandom(4).hex()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            if GLOBAL_CONFIG.gcs_snapshot_fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self.storage_path)
        if GLOBAL_CONFIG.gcs_snapshot_fsync:
            dfd = os.open(os.path.dirname(self.storage_path) or ".",
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _flush_snapshot(self, snap: Dict):
        """Local write + mirror upload, called OFF the event loop (the
        persist loop's executor hop / the shutdown path): a
        multi-hundred-ms bucket upload on the loop would stall
        heartbeats/RPCs exactly when FT is enabled."""
        import pickle

        blob = pickle.dumps(snap, protocol=5)  # serialized ONCE for both
        self._write_snapshot(blob)
        # the snapshot covering the rotated-out journal segment landed:
        # that segment is now redundant
        old = self._journal_rotated_old
        if old is not None:
            self._journal_rotated_old = None
            try:
                os.unlink(old)
            except OSError:
                pass
        try:
            mirror = self._mirror_storage()
            if mirror is not None:
                mirror.put("gcs/snapshot", blob)
        except Exception:  # incl. an unconstructible backend (bad URI)
            logger.exception("GCS snapshot mirror write failed "
                             "(local snapshot intact)")

    def _startup_compact(self):
        """Fold the restored state into one fresh snapshot and reset the
        journals (called before serving: no concurrent mutation)."""
        import pickle

        self._write_snapshot(pickle.dumps(self._snapshot(), protocol=5))
        self._journal_rotated_old = None
        try:
            os.unlink(self.storage_path + ".journal.old")
        except OSError:
            pass
        self._journal_w.reset()

    def _persist_now(self):
        if self.storage_path:
            self._flush_snapshot(self._snapshot())

    async def _persist_loop(self):
        while True:
            await asyncio.sleep(
                max(0.05, GLOBAL_CONFIG.gcs_snapshot_interval_s)
            )
            if self._dirty:
                snap = self._snapshot()  # loop thread: consistent copy
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._flush_snapshot, snap
                    )
                except Exception:
                    logger.exception("GCS persistence flush failed")

    # ---------------- pubsub ----------------
    def _publish_locs(self, oid: bytes, locs):
        """Object-directory invalidation feed ("locs" channel): raylets
        holding a cached location entry for ``oid`` replace it with
        ``locs`` (None = object gone everywhere). Published on exactly
        the mutations that make a cached read STALE — remove-location,
        free, dead-node purge (additions never stale a cached subset
        and skip the fan-out) — so the raylet read cache never serves
        a location the directory has dropped."""
        if self.subs.get("locs"):
            self._publish("locs", [[bytes(oid), locs]])

    def _publish(self, channel: str, data: Any):
        dead = []
        for conn in self.subs.get(channel, ()):
            if conn.closed:
                dead.append(conn)
                continue
            rpc.spawn(conn.notify_async("publish", [channel, data]))
        for c in dead:
            self.subs.get(channel, set()).discard(c)

    async def rpc_subscribe(self, conn, channels: List[str]):
        for ch in channels:
            self.subs.setdefault(ch, set()).add(conn)
        # Snapshot semantics: subscriber immediately gets current state of
        # snapshot-able channels so subscribe-then-read races can't drop data.
        snap = {}
        for ch in channels:
            if ch == "nodes":
                snap[ch] = [n.to_wire() for n in self.nodes.values()]
            elif ch == "actors":
                snap[ch] = [a.to_wire() for a in self.actors.values()]
            elif ch == "resources":
                snap[ch] = self._resource_view()
        return snap

    # ---------------- KV (function table etc.) ----------------
    async def rpc_kv_put(self, conn, data):
        key, value, overwrite = data
        if not overwrite and key in self.kv:
            return False
        self.kv[key] = value
        self._mark_dirty()
        await self._journal_wait(self._journal(["kv", key, value]))
        return True

    async def rpc_kv_get(self, conn, key):
        return self.kv.get(key)

    async def rpc_kv_del(self, conn, key):
        self._mark_dirty()
        existed = self.kv.pop(key, None) is not None
        await self._journal_wait(self._journal(["kv", key, None]))
        return existed

    async def rpc_kv_exists(self, conn, key):
        return key in self.kv

    async def rpc_kv_keys(self, conn, prefix):
        return [k for k in self.kv if k.startswith(prefix)]

    # ---------------- nodes ----------------
    async def rpc_register_node(self, conn, info_wire):
        info = NodeInfo.from_wire(info_wire)
        self.nodes[info.node_id] = info
        self.node_heartbeat[info.node_id] = time.monotonic()
        conn.on_close = self._make_node_close_handler(info.node_id)
        # chaos-plane peer tag: lets node-pair partition rules match this
        # server-side connection
        conn.chaos_peer = "raylet-" + info.node_id.hex()[:12]
        self._raylet_clients[info.node_id] = conn
        logger.info("node registered: %s", info.node_id.hex()[:12])
        self._publish("nodes", [info.to_wire()])
        # epoch in the registration reply: the raylet's fencing floor —
        # it refuses to re-register against a GCS whose epoch regresses
        # (a resurrected pre-failover primary)
        return {"node_id": info.node_id, "config": GLOBAL_CONFIG.dump(),
                "epoch": self.epoch}

    def _make_node_close_handler(self, node_id: bytes):
        def on_close(conn):
            # Raylet connection dropped => node presumed dead — unless a
            # re-registration already superseded this conn (a raylet
            # cycling its GCS link must not kill its fresh registration).
            if self._raylet_clients.get(node_id) is not conn:
                return
            rpc.spawn(self._mark_node_dead(node_id))

        return on_close

    async def rpc_heartbeat(self, conn, data):
        node_id, resources = data
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            # This GCS doesn't know the node (journal-restored after a
            # SIGKILL, or the node was declared dead during a partition/
            # blackout): tell the raylet to run the full re-registration —
            # register + resubscribe + replay its live actors.
            return {"reregister": True}
        self.node_heartbeat[node_id] = time.monotonic()
        if resources:
            self.node_resources[node_id] = resources
            self._publish("resources", self._resource_view())
        return {"ok": True}

    async def rpc_get_all_nodes(self, conn, _):
        return [n.to_wire() for n in self.nodes.values()]

    async def rpc_update_node_labels(self, conn, data):
        """Merge a label patch into a live node's record (``None`` value
        deletes the key) and republish it. An optional third element
        ``expect`` ({key: value}) makes the patch conditional — applied
        only while every expected key still holds its expected value
        (compare-and-set, so a gang clearing its OWN stamp cannot wipe
        a successor gang's). MeshGroup controllers stamp gang
        membership here; the object plane's locality-aware stripe-peer
        picker reads the labels off every raylet's cluster-node view.
        Not journaled: labels reset to the raylet's registration values
        on a GCS restart, and label owners (gangs) re-stamp at their
        next transition."""
        node_id, patch = bytes(data[0]), dict(data[1])
        expect = dict(data[2]) if len(data) > 2 and data[2] else None
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return {"ok": False, "error": "unknown or dead node"}
        if expect is not None and any(
            info.labels.get(k) != v for k, v in expect.items()
        ):
            return {"ok": False, "error": "expectation failed"}
        changed = False
        for key, val in patch.items():
            if val is None:
                if key in info.labels:
                    info.labels.pop(key, None)
                    changed = True
            elif info.labels.get(key) != str(val):
                info.labels[key] = str(val)
                changed = True
        # No-op patches (same key -> same value, e.g. a gang re-stamping
        # its membership every transition) must not republish: every
        # ``nodes`` subscriber would re-process an unchanged record.
        if changed:
            self._publish("nodes", [info.to_wire()])
        return {"ok": True, "changed": changed}

    # -- mesh-group registry (gang observability; transient) --

    async def rpc_mesh_group_update(self, conn, rec: Dict):
        self.mesh_groups[str(rec["name"])] = dict(rec)
        return {"ok": True}

    async def rpc_mesh_group_remove(self, conn, name: str):
        return {"ok": self.mesh_groups.pop(str(name), None) is not None}

    async def rpc_mesh_group_table(self, conn, _):
        return dict(self.mesh_groups)

    # -- autoscaler intents (durable provisioning WAL for healers) --

    async def rpc_autoscaler_intent_put(self, conn, data):
        key, rec = str(data[0]), dict(data[1])
        self.autoscaler_intents[key] = rec
        self._mark_dirty()
        await self._journal_wait(self._journal(["intent", key, rec]))
        return {"ok": True}

    async def rpc_autoscaler_intent_del(self, conn, key):
        existed = self.autoscaler_intents.pop(str(key), None) is not None
        self._mark_dirty()
        await self._journal_wait(self._journal(["intent", str(key), None]))
        return {"ok": existed}

    async def rpc_autoscaler_intent_table(self, conn, _):
        return {k: dict(v) for k, v in self.autoscaler_intents.items()}

    def _resource_view(self):
        return {
            nid.hex(): res
            for nid, res in self.node_resources.items()
            if nid in self.nodes and self.nodes[nid].alive
        }

    async def _mark_node_dead(self, node_id: bytes):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        logger.warning("node dead: %s", node_id.hex()[:12])
        self._raylet_clients.pop(node_id, None)
        self.node_resources.pop(node_id, None)
        self._publish("nodes", [info.to_wire()])
        self._publish("resources", self._resource_view())
        # Purge the dead node from the object directory so pulls don't chase
        # vanished copies (owners then trigger lineage reconstruction).
        for key in [k for k in self.kv if k.startswith("loc:")]:
            locs = [bytes(l) for l in rpc.msgpack.unpackb(self.kv[key])]
            if node_id in locs:
                locs = [l for l in locs if l != node_id]
                oid = bytes.fromhex(key[4:])
                if locs:
                    self.kv[key] = rpc.msgpack.packb(locs)
                    self._journal(["kv", key, self.kv[key]])
                    self._publish_locs(oid, locs)
                else:
                    self.kv.pop(key, None)
                    self._journal(["kv", key, None])
                    self._publish_locs(oid, None)
        # Placement groups lose the dead node's bundles -> reschedule them.
        for pg in self.placement_groups.values():
            lost = [i for i, n in enumerate(pg.assignment) if n == node_id]
            if lost and pg.state in (PG_CREATED, PG_PENDING, PG_RESCHEDULING):
                for i in lost:
                    pg.assignment[i] = None
                if pg.state == PG_CREATED:
                    pg.state = PG_RESCHEDULING
                    self._journal_pg(pg)
                    self._publish("placement_groups", [pg.to_wire()])
                    rpc.spawn(self._place_pg(pg))
        # Actors on that node die (and maybe restart elsewhere).
        for rec in list(self.actors.values()):
            if rec.address and rec.address[2] == node_id and rec.state in (
                ALIVE, PENDING, RESTARTING,
            ):
                await self._on_actor_death(rec, f"node {node_id.hex()[:12]} died")

    async def _health_loop(self):
        period = GLOBAL_CONFIG.health_check_period_ms / 1e3
        timeout = GLOBAL_CONFIG.health_check_timeout_ms / 1e3
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for nid, last in list(self.node_heartbeat.items()):
                info = self.nodes.get(nid)
                if info is not None and info.alive and now - last > timeout:
                    await self._mark_node_dead(nid)

    # ---------------- jobs ----------------
    async def rpc_register_job(self, conn, data):
        job_id, meta = data
        self.jobs[job_id] = dict(meta, start_time=time.time())
        self._mark_dirty()
        await self._journal_wait(
            self._journal(["job", job_id, self.jobs[job_id]])
        )
        return True

    async def rpc_get_jobs(self, conn, _):
        return {k.hex(): v for k, v in self.jobs.items()}

    # ---------------- actors ----------------
    async def rpc_create_actor(self, conn, data):
        """Register + asynchronously place an actor. Returns immediately.

        Idempotent at the APPLICATION level, keyed on the client-generated
        actor id: the rpc-layer dedup cache dies with a SIGKILLed GCS, so
        a client replaying create_actor against the restarted process must
        land on the journal-restored record, not re-create (or collide
        with its own name registration)."""
        spec = data
        actor_id = spec["actor_id"]
        if actor_id in self.actors:
            return {"ok": True}  # duplicate submission (replay): applied once
        name = spec.get("name_register") or ""
        if name:
            if self.named_actors.get(name, actor_id) != actor_id:
                return {"ok": False, "error": f"actor name {name!r} taken"}
            self.named_actors[name] = actor_id
        rec = ActorRecord(actor_id, spec, name=name)
        self.actors[actor_id] = rec
        fut = self._journal_actor(rec)
        rpc.spawn(self._place_actor(rec))
        await self._journal_wait(fut)
        return {"ok": True}

    def _pick_node_for(
        self, resources: Dict[str, float], strategy=None
    ) -> Optional[bytes]:
        """Actor placement honoring the scheduling strategy (parity: the
        reference GcsActorScheduler consults the task's strategy;
        gcs_actor_scheduler.h:111). Default is pack-biased."""
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        parsed = parse_pg_strategy(strategy)
        if parsed is not None:
            pg_id, idx = parsed
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg.state != PG_CREATED:
                return None  # keep waiting; _place_actor retries
            cands = (
                [pg.assignment[idx]] if 0 <= idx < len(pg.assignment)
                else [n for n in pg.assignment if n is not None]
            )
            alive = [
                nid for nid in cands
                if nid is not None and nid in self.nodes
                and self.nodes[nid].alive
            ]
            # Randomize so a full bundle's node is not retried exclusively
            # while another bundle (idx=-1) has free capacity.
            return self._rng.choice(alive) if alive else None
        if isinstance(strategy, (list, tuple)) and strategy and (
            strategy[0] == "affinity"
        ):
            target_hex, soft = str(strategy[1]), bool(strategy[2])
            for nid, info in self.nodes.items():
                if nid.hex() == target_hex and info.alive:
                    return nid
            if not soft:
                return None  # hard affinity to a gone node: keep waiting
            # soft: fall through to default
        if isinstance(strategy, (list, tuple)) and strategy and (
            strategy[0] == "labels"
        ):
            from ray_tpu_torch.util.scheduling_strategies import labels_match

            hard, soft = strategy[1] or {}, strategy[2] or {}
            # soft is BEST-EFFORT: prefer (soft-match, fits-available),
            # then any hard-match that fits totals — never fail an actor
            # because the preferred node is too small
            best = None  # (rank, nid); lower rank wins
            for nid, info in self.nodes.items():
                if not info.alive or not labels_match(info.labels, hard):
                    continue
                res_view = self.node_resources.get(nid, {})
                avail = res_view.get("available", {})
                total = res_view.get("total", {})
                fits_avail = all(
                    avail.get(r, 0.0) >= q for r, q in resources.items()
                )
                fits_total = all(
                    total.get(r, 0.0) >= q for r, q in resources.items()
                )
                if not fits_total:
                    continue
                rank = (
                    0 if labels_match(info.labels, soft) and fits_avail
                    else 1 if fits_avail
                    else 2 if labels_match(info.labels, soft)
                    else 3
                )
                if best is None or rank < best[0]:
                    best = (rank, nid)
            return best[1] if best else None  # None: keep waiting
        spread = strategy == "SPREAD"
        best, best_score = None, None
        for nid, info in self.nodes.items():
            if not info.alive:
                continue
            avail = self.node_resources.get(nid, {}).get("available", {})
            if all(avail.get(r, 0.0) >= q for r, q in resources.items()):
                score = sum(avail.values())
                better = (
                    best is None
                    or (score > best_score if spread else score < best_score)
                )
                if better:
                    best, best_score = nid, score
        if best is None:
            # fall back to any alive node that *totals* enough (queue there)
            for nid, info in self.nodes.items():
                total = self.node_resources.get(nid, {}).get("total", {})
                if info.alive and all(
                    total.get(r, 0.0) >= q for r, q in resources.items()
                ):
                    return nid
        return best

    async def _place_actor(self, rec: ActorRecord, delay: float = 0.0):
        if delay:
            await asyncio.sleep(delay)
        from ray_tpu_torch._private.protocol import parse_pg_strategy

        spec = rec.spec
        strategy = spec.get("scheduling_strategy")
        # An actor stays PENDING while some alive node could EVER satisfy it
        # (reference: pending actors wait for resources indefinitely,
        # gcs_actor_scheduler.h:111 — busy != infeasible). Only a request no
        # alive node's TOTAL resources cover fails, after a grace window for
        # nodes to join. PG-strategy and hard-affinity placements wait
        # INDEFINITELY: a pending placement group or temporarily-gone target
        # node is "not yet", never "infeasible" (their own lifecycles decide).
        waits_forever = parse_pg_strategy(strategy) is not None or (
            isinstance(strategy, (list, tuple))
            and strategy and strategy[0] == "affinity"
            and not bool(strategy[2])  # hard affinity
        )
        grace = GLOBAL_CONFIG.infeasible_task_grace_s
        infeasible_deadline = time.monotonic() + grace
        # Separately bound *persistent placement errors* (raylet RPC raising
        # or rejecting for a reason other than "busy"): those indicate a
        # wedged node, not a full one, and must surface instead of hanging
        # every caller forever. Reset whenever an attempt is healthy.
        error_deadline = None
        while rec.state in (PENDING, RESTARTING):
            node_id = self._pick_node_for(
                spec.get("resources") or {}, strategy=strategy
            )
            raylet = self._raylet_clients.get(node_id) if node_id else None
            if raylet is None or raylet.closed:
                if not waits_forever and time.monotonic() > infeasible_deadline:
                    await self._fail_actor(
                        rec,
                        "infeasible: no alive node can satisfy actor "
                        f"resources {spec.get('resources')}",
                    )
                    return
                await asyncio.sleep(0.2)
                continue
            infeasible_deadline = time.monotonic() + grace
            try:
                reply = await raylet.call_async("create_actor", spec, timeout=120)
            except Exception as e:
                logger.warning("actor placement on %s failed: %s",
                               node_id.hex()[:12], e)
                if error_deadline is None:
                    error_deadline = time.monotonic() + 120.0
                elif time.monotonic() > error_deadline:
                    await self._fail_actor(
                        rec, f"placement kept failing: {e!r}"
                    )
                    return
                await asyncio.sleep(0.2)
                continue
            if reply.get("ok"):
                if rec.state == DEAD:
                    # killed while placing: reap the freshly-created worker
                    try:
                        await raylet.call_async(
                            "kill_worker",
                            [reply["address"][0], rec.actor_id],
                            timeout=10,
                        )
                    except Exception:
                        pass
                    return
                rec.address = reply["address"]
                rec.accelerator_ids = dict(reply.get("accelerator_ids") or {})
                rec.state = ALIVE
                self._journal_actor(rec)
                self._publish("actors", [rec.to_wire()])
                return
            logger.warning("actor %s placement rejected: %s",
                           rec.actor_id.hex()[:12], reply.get("error"))
            if reply.get("fatal"):
                await self._fail_actor(rec, reply.get("error", "creation failed"))
                return
            err = reply.get("error", "")
            if reply.get("retryable"):
                # busy node (structured flag from the raylet — lease parked
                # then timed out / bundle full): stay PENDING, retry forever;
                # a healthy-but-full attempt clears the error bound
                error_deadline = None
            else:
                if error_deadline is None:
                    error_deadline = time.monotonic() + 120.0
                elif time.monotonic() > error_deadline:
                    await self._fail_actor(
                        rec, err or "placement kept failing"
                    )
                    return
            await asyncio.sleep(0.2)

    async def _fail_actor(self, rec: ActorRecord, reason: str):
        rec.state = DEAD
        rec.death_cause = reason
        if rec.name:
            self.named_actors.pop(rec.name, None)
        # Durable-at-ack (R11): the DEAD record must be flushed before any
        # rpc_ caller replies, else a kill acked to the client can be
        # forgotten by a journal-replayed GCS (the actor resurrects).
        await self._journal_wait(self._journal_actor(rec))
        self._publish("actors", [rec.to_wire()])

    async def _on_actor_death(self, rec: ActorRecord, reason: str):
        if rec.state == DEAD:
            return
        if rec.restarts_left != 0:
            if rec.restarts_left > 0:
                rec.restarts_left -= 1
            rec.num_restarts += 1
            rec.state = RESTARTING
            rec.address = None
            rec.accelerator_ids = {}
            # Durable-at-ack (R11): a restart decision that is acked but
            # lost on failover double-spends restarts_left after replay.
            await self._journal_wait(self._journal_actor(rec))
            self._publish("actors", [rec.to_wire()])
            logger.info("restarting actor %s (%d restarts)",
                        rec.actor_id.hex()[:12], rec.num_restarts)
            await self._place_actor(rec)
        else:
            rec.death_cause = reason
            await self._fail_actor(rec, reason)

    async def rpc_restore_actors(self, conn, hosted: List[Dict]):
        """A (re-)registering raylet replays its live actors so a restarted
        GCS rebuilds its actor table (GCS FT). Journal-restored records
        awaiting reclaim (``_recovering``) are ADOPTED — state back to
        ALIVE at the replayed address, no re-placement, no restart spent.
        Replayed actors whose record meanwhile moved on (restarted
        elsewhere, or killed) are returned as ``stale`` so the raylet
        reaps the orphaned worker instead of leaking it."""
        restored = 0
        stale: List[bytes] = []
        touched: List[bytes] = []
        for item in hosted:
            spec = item["spec"]
            actor_id = bytes(spec["actor_id"])
            name = spec.get("name_register") or ""
            rec = self.actors.get(actor_id)
            if rec is None:
                rec = ActorRecord(actor_id, spec, name=name)
                rec.state = ALIVE
                rec.address = item["address"]
                rec.accelerator_ids = dict(item.get("accelerator_ids") or {})
                self.actors[actor_id] = rec
                if name:
                    self.named_actors.setdefault(name, actor_id)
                restored += 1
                touched.append(actor_id)
            elif actor_id in self._recovering:
                self._recovering.discard(actor_id)
                rec.state = ALIVE
                rec.address = item["address"]
                rec.accelerator_ids = dict(item.get("accelerator_ids") or {})
                if rec.name:
                    self.named_actors.setdefault(rec.name, actor_id)
                restored += 1
                touched.append(actor_id)
            elif rec.state == ALIVE and rec.address == item["address"]:
                pass  # already known (idempotent replay)
            else:
                stale.append(actor_id)
        fut = None
        for aid in touched:
            fut = self._journal_actor(self.actors[aid])
        await self._journal_wait(fut)
        if restored:
            logger.info("restored %d live actor(s) from a raylet", restored)
            self._publish(
                "actors", [self.actors[aid].to_wire() for aid in touched]
            )
        return {"restored": restored, "stale": stale}

    async def rpc_report_actor_death(self, conn, data):
        """Raylet reports an actor worker exited."""
        actor_id, reason, expected = data
        rec = self.actors.get(actor_id)
        if rec is None:
            return False
        if expected:  # ray.kill(no_restart) / actor __exit__
            await self._fail_actor(rec, reason or "actor exited")
        else:
            await self._on_actor_death(rec, reason or "worker died")
        return True

    async def rpc_kill_actor(self, conn, data):
        actor_id, no_restart = data
        rec = self.actors.get(actor_id)
        if rec is None:
            return False
        if no_restart:
            rec.restarts_left = 0
            await self._journal_wait(self._journal_actor(rec))
        if rec.address is None:
            # Still placing (PENDING/RESTARTING): mark dead now; _place_actor
            # checks state and kills a worker that wins the race.
            if no_restart and rec.state in (PENDING, RESTARTING):
                await self._fail_actor(rec, "killed via kill_actor")
            return True
        # Tell the hosting raylet to SIGKILL the worker.
        if rec.address is not None:
            node_id = rec.address[2]
            raylet = self._raylet_clients.get(node_id)
            if raylet is not None and not raylet.closed:
                try:
                    await raylet.call_async(
                        "kill_worker", [rec.address[0], actor_id], timeout=10
                    )
                except Exception:
                    pass
        return True

    async def rpc_get_actor(self, conn, actor_id):
        rec = self.actors.get(actor_id)
        return rec.to_wire() if rec else None

    async def rpc_get_named_actor(self, conn, name):
        aid = self.named_actors.get(name)
        if aid is None:
            return None
        return self.actors[aid].to_wire()

    async def rpc_list_actors(self, conn, _):
        """Every actor record: the serve controller reconciles its replicas
        against the states here, and the state API lists them."""
        return [a.to_wire() for a in self.actors.values()]

    async def rpc_create_placement_group(self, conn, spec: Dict):
        pg_id = spec["pg_id"]
        if pg_id in self.placement_groups:
            # duplicate submission (client replay across a GCS restart):
            # the journal-restored record owns the 2PC, apply once
            return {"ok": True}
        rec = PgRecord(
            pg_id,
            [dict(b) for b in spec["bundles"]],
            spec.get("strategy") or "PACK",
            name=spec.get("name") or "",
        )
        if rec.strategy not in ("PACK", "SPREAD", "STRICT_PACK",
                                "STRICT_SPREAD"):
            return {"ok": False, "error": f"bad strategy {rec.strategy!r}"}
        self.placement_groups[pg_id] = rec
        fut = self._journal_pg(rec)
        rpc.spawn(self._place_pg(rec))
        await self._journal_wait(fut)
        return {"ok": True}

    async def rpc_get_placement_group(self, conn, pg_id: bytes):
        rec = self.placement_groups.get(pg_id)
        return rec.to_wire() if rec else None

    async def rpc_placement_group_table(self, conn, _):
        return {
            pid.hex(): rec.to_wire()
            for pid, rec in self.placement_groups.items()
        }

    async def rpc_remove_placement_group(self, conn, pg_id: bytes):
        rec = self.placement_groups.get(pg_id)
        if rec is None:
            return False
        rec.state = PG_REMOVED
        nodes = {n for n in rec.assignment if n is not None}
        rec.assignment = [None] * len(rec.bundles)
        fut = self._journal_pg(rec)
        for nid in nodes:
            raylet = self._raylet_clients.get(nid)
            if raylet is not None and not raylet.closed:
                try:
                    await raylet.call_async("release_bundles", pg_id,
                                            timeout=10)
                except Exception:
                    pass
        self._publish("placement_groups", [rec.to_wire()])
        # Durable-at-ack (R11): flush overlaps the release round-trips
        # above; the ack must not outrun the PG_REMOVED journal record.
        await self._journal_wait(fut)
        return True

    def _plan_bundles(self, rec: PgRecord) -> Optional[List[bytes]]:
        """Advisory bundle->node plan from the latest resource view; the
        authoritative admission check is each raylet's PREPARE."""
        free: Dict[bytes, Dict[str, float]] = {}
        for nid, info in self.nodes.items():
            if info.alive:
                avail = self.node_resources.get(nid, {}).get("available")
                if avail is None:  # pre-first-heartbeat: use static totals
                    avail = dict(info.resources or {})
                free[nid] = dict(avail)
        if not free:
            return None

        def fits(nid, res):
            return all(free[nid].get(r, 0.0) >= q for r, q in res.items())

        def charge(nid, res):
            for r, q in res.items():
                free[nid][r] = free[nid].get(r, 0.0) - q

        unplaced = [
            (i, rec.bundles[i])
            for i in range(len(rec.bundles))
            if rec.assignment[i] is None
        ]
        plan: List[Optional[bytes]] = list(rec.assignment)
        if rec.strategy == "STRICT_PACK":
            anchored = {n for n in rec.assignment if n is not None}
            cands = list(anchored) if anchored else list(free)
            for nid in cands:
                trial = dict(free[nid])
                ok = True
                for _, b in unplaced:
                    for r, q in b.items():
                        trial[r] = trial.get(r, 0.0) - q
                        if trial[r] < 0:
                            ok = False
                    if not ok:
                        break
                if ok:
                    for i, b in unplaced:
                        plan[i] = nid
                    return plan  # all on one node
            return None
        used = {n for n in rec.assignment if n is not None}
        for i, b in unplaced:
            if rec.strategy == "STRICT_SPREAD":
                cands = [n for n in free if n not in used and fits(n, b)]
            elif rec.strategy == "SPREAD":
                fresh = [n for n in free if n not in used and fits(n, b)]
                cands = fresh or [n for n in free if fits(n, b)]
            else:  # PACK: prefer nodes already in use
                cands = sorted(
                    (n for n in free if fits(n, b)),
                    key=lambda n: (n not in used,),
                )
            if not cands:
                return None
            nid = cands[0]
            plan[i] = nid
            charge(nid, b)
            used.add(nid)
        return plan

    async def _place_pg(self, rec: PgRecord):
        backoff = 0.1
        while rec.state in (PG_PENDING, PG_RESCHEDULING):
            plan = self._plan_bundles(rec)
            if plan is None or any(p is None for p in plan):
                await asyncio.sleep(min(backoff, 1.0))
                backoff *= 1.5
                continue
            # group NEW bundles per node
            per_node: Dict[bytes, List] = {}
            for i, nid in enumerate(plan):
                if rec.assignment[i] is None:
                    per_node.setdefault(nid, []).append(
                        [i, rec.bundles[i]]
                    )
            # PREPARE phase
            prepared: List[bytes] = []
            ok = True
            for nid, items in per_node.items():
                raylet = self._raylet_clients.get(nid)
                if raylet is None or raylet.closed:
                    ok = False
                    break
                try:
                    r = await raylet.call_async(
                        "prepare_bundles",
                        {"pg_id": rec.pg_id, "bundles": items},
                        timeout=15,
                    )
                except Exception:
                    r = {"ok": False}
                if not r.get("ok"):
                    ok = False
                    break
                prepared.append(nid)
            if not ok or rec.state == PG_REMOVED:
                for nid in prepared:
                    raylet = self._raylet_clients.get(nid)
                    if raylet is not None and not raylet.closed:
                        try:
                            await raylet.call_async(
                                "cancel_bundles", rec.pg_id, timeout=10
                            )
                        except Exception:
                            pass
                if rec.state == PG_REMOVED:
                    return
                await asyncio.sleep(min(backoff, 1.0))
                backoff *= 1.5
                continue
            # COMMIT phase. Publish the tentative assignment FIRST so the
            # node-death handler can void entries while commits are in
            # flight; any bundle whose commit fails (node died mid-2PC) is
            # cleared and re-placed by the next loop iteration.
            rec.assignment = plan
            for nid, items in per_node.items():
                committed = False
                raylet = self._raylet_clients.get(nid)
                if raylet is not None and not raylet.closed:
                    try:
                        r = await raylet.call_async(
                            "commit_bundles", rec.pg_id, timeout=15
                        )
                        committed = bool(r.get("ok"))
                    except Exception:
                        committed = False
                if not committed:
                    for i, _ in items:
                        rec.assignment[i] = None
            if rec.state == PG_REMOVED:  # removed during commit: roll back
                await self.rpc_remove_placement_group(None, rec.pg_id)
                return
            if any(a is None for a in rec.assignment):
                continue  # a commit failed or a node died: re-place the rest
            rec.state = PG_CREATED
            self._journal_pg(rec)
            self._publish("placement_groups", [rec.to_wire()])
            logger.info("placement group %s created over %d node(s)",
                        rec.pg_id.hex()[:12], len(set(plan)))
            return

    # ---------------- object directory ----------------
    # Locations of plasma objects (node ids). Parity: the reference resolves
    # locations through owner workers (ownership_based_object_directory.h:37);
    # here the GCS keeps the directory — simpler, and the owner still drives
    # lifetime via free_objects.
    async def rpc_add_object_location(self, conn, data):
        oid, node_id = data
        key = "loc:" + oid.hex()
        locs = self.kv.get(key)
        locs = set(bytes(l) for l in rpc.msgpack.unpackb(locs)) if locs else set()
        locs.add(node_id)
        self.kv[key] = rpc.msgpack.packb([bytes(l) for l in locs])
        # journaled so a live GCS restart loses no object directory entries
        # (a lost loc: entry surfaces as ObjectLost to the owner).
        # NOT published to the locs channel: an ADDED copy never stales
        # a cached entry (a subset of live locations still serves a
        # pull), so adds don't pay the fan-out
        fut = self._journal(["kv", key, self.kv[key]])
        await self._journal_wait(fut)
        return True

    async def rpc_remove_object_location(self, conn, data):
        oid, node_id = data
        key = "loc:" + oid.hex()
        locs = self.kv.get(key)
        if locs is None:
            return False
        s = set(bytes(l) for l in rpc.msgpack.unpackb(locs))
        s.discard(node_id)
        if s:
            self.kv[key] = rpc.msgpack.packb(sorted(s))
            fut = self._journal(["kv", key, self.kv[key]])
            self._publish_locs(oid, sorted(s))
        else:
            self.kv.pop(key, None)
            fut = self._journal(["kv", key, None])
            self._publish_locs(oid, None)
        await self._journal_wait(fut)
        return True

    async def rpc_get_object_locations(self, conn, oid):
        locs = self.kv.get("loc:" + oid.hex())
        return rpc.msgpack.unpackb(locs) if locs else []

    # ---------------- broadcast-tree pull registry ----------------
    # K raylets pulling one large object register here; each is assigned
    # a tree PARENT (an earlier in-progress puller) to stream from, so
    # the sealed source serves O(fanout) copies instead of K (reference
    # pull-manager dedup / push-manager fan-out role). The raylet-side
    # partial-serve path (raylet.rpc_read_object_chunks) makes an
    # in-progress pull a valid chunk source.

    async def rpc_pull_begin(self, conn, data):
        """Register ``node_id`` as pulling ``oid``; returns sealed
        locations plus the assigned tree parents. Re-registration keeps
        the node's arrival position, so a retrying puller walks UP its
        ancestor chain (skipping ``exclude`` + dead nodes) instead of
        being reshuffled below a later arrival (which could cycle)."""
        oid, node_id = bytes(data[0]), bytes(data[1])
        exclude = {bytes(x) for x in (data[2] if len(data) > 2 else [])}
        locs = self.kv.get("loc:" + oid.hex())
        locs = rpc.msgpack.unpackb(locs) if locs else []
        sealed = {bytes(x) for x in locs}
        fanout = max(1, int(GLOBAL_CONFIG.object_broadcast_fanout or 1))
        lst = self._pulls.setdefault(oid, [])
        # prune dead pullers IN PLACE (relative order — and with it the
        # no-cycle invariant — is preserved)
        lst[:] = [
            n for n in lst
            if n in self.nodes and self.nodes[n].alive
        ]
        if node_id not in lst:
            lst.append(node_id)
        pos = lst.index(node_id)
        # k-ary heap walk: nearest live, non-excluded ancestor serves as
        # parent; position 0 (or no usable ancestor) pulls the source
        parent = None
        p = pos
        while p > 0:
            p = (p - 1) // fanout
            cand = lst[p]
            if (cand not in exclude and cand not in sealed
                    and cand != node_id):
                parent = cand
                break
        return {
            "locations": [bytes(x) for x in locs],
            "parents": [parent] if parent is not None else [],
            "position": pos,
        }

    async def rpc_pull_end(self, conn, data):
        """Deregister a finished/aborted puller. Success is implicit —
        the puller adds a sealed location separately; children it was
        serving re-register and find it there (or another ancestor)."""
        oid, node_id = bytes(data[0]), bytes(data[1])
        lst = self._pulls.get(oid)
        if lst is None:
            return False
        try:
            lst.remove(node_id)
        except ValueError:
            return False
        if not lst:
            self._pulls.pop(oid, None)
        return True

    async def rpc_free_object(self, conn, oid_bytes: bytes):
        """Owner freed its last reference: delete every copy — in-store AND
        spilled — on every node that holds one (parity: reference
        FreeObjects fan-out). One RPC from the owner; the GCS fans out only
        to copy-holding raylets."""
        key = "loc:" + oid_bytes.hex()
        locs = self.kv.pop(key, None)
        self._pulls.pop(bytes(oid_bytes), None)  # freed: entry is moot
        fut = None
        if locs is not None:
            fut = self._journal(["kv", key, None])
            self._publish_locs(bytes(oid_bytes), None)
        nodes = (
            [bytes(n) for n in rpc.msgpack.unpackb(locs)] if locs else []
        )
        for nid in nodes:
            raylet = self._raylet_clients.get(nid)
            if raylet is not None and not raylet.closed:
                rpc.spawn(raylet.call_async("free_local_object", oid_bytes,
                                            timeout=10))
        await self._journal_wait(fut)
        return True

    # ---------------- task events (observability) ----------------
    # Parity: reference GcsTaskManager (gcs_task_manager.h:61) — the sink
    # for worker TaskEventBuffers; powers list_tasks/summary/timeline.

    MAX_TASK_RECORDS = 10000

    async def rpc_add_task_events(self, conn, batch: List[Dict]):
        for ev in batch:
            tid = bytes(ev["task_id"])
            rec = self.task_events.get(tid)
            if rec is None:
                if len(self.task_events) >= self.MAX_TASK_RECORDS:
                    # drop oldest record (insertion order ~ submission order)
                    self.task_events.pop(next(iter(self.task_events)))
                rec = {
                    "task_id": tid,
                    "name": ev.get("name") or "",
                    "actor_id": ev.get("actor_id"),
                    "states": {},
                    "node": None,
                    "worker": None,
                    "error": "",
                    "attempts": 0,
                }
                if ev.get("trace_id"):
                    rec["trace_id"] = ev["trace_id"]
                    rec["parent_span_id"] = ev.get("parent_span_id", "")
                    rec["span_id"] = ev.get("span_id", "")
                self.task_events[tid] = rec
            state = ev["state"]
            if state == "RUNNING":
                rec["attempts"] += 1
                rec["node"] = ev.get("node")
                rec["worker"] = ev.get("worker")
                # a retry attempt supersedes the previous terminal state
                rec["states"].pop("FINISHED", None)
                rec["states"].pop("FAILED", None)
            rec["states"][state] = ev["ts"]
            if ev.get("error"):
                rec["error"] = ev["error"]
        return True

    async def rpc_list_task_events(self, conn, filters: Optional[Dict]):
        filters = filters or {}
        limit = int(filters.get("limit") or 1000)
        out = []
        for rec in reversed(list(self.task_events.values())):
            if len(out) >= limit:
                break
            if filters.get("name") and filters["name"] not in rec["name"]:
                continue
            state = _latest_state(rec)
            if filters.get("state") and filters["state"] != state:
                continue
            out.append(dict(rec, state=state))
        return out

    async def rpc_publish_logs(self, conn, batch):
        """Raylet log monitors forward worker stdout/stderr; fan out to
        subscribed drivers (reference log monitor -> driver, services.py:971)."""
        self._publish("logs", batch)
        return True

    # ---------------- debug ----------------
    async def rpc_ping(self, conn, _):
        return "pong"

    async def rpc_internal_state(self, conn, _):
        return {
            "num_nodes": len([n for n in self.nodes.values() if n.alive]),
            "num_actors": len(self.actors),
            "kv_keys": len(self.kv),
            "num_pgs": len(self.placement_groups),
            "subs": {
                ch: len([c for c in conns if not c.closed])
                for ch, conns in self.subs.items()
            },
            "journal_appended": (
                self._journal_w.appended if self._journal_w else None
            ),
            # group-commit effectiveness: flushes << appended means the
            # batcher is actually amortizing write+flush(+fsync) calls
            "journal_flushes": (
                self._journal_w.flushes if self._journal_w else None
            ),
            "journal_buffered": (
                self._journal_w.buffered if self._journal_w else None
            ),
            "recovering_actors": len(self._recovering),
            "epoch": self.epoch,
            "standbys": len(self._standby_conns),
            "standby_acked_seq": self._standby_acked,
            "journal_seq": self._journal_seq,
            "shipped_records": (
                self._ship_tailer.records if self._ship_tailer else None
            ),
            "method_stats": rpc.method_stats().snapshot(),
        }


def main():
    import argparse
    import sys

    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.fate_share import fate_share_with_parent

    fate_share_with_parent()
    chaos.install_from_env("gcs")
    p = argparse.ArgumentParser()
    p.add_argument("--sock")
    p.add_argument("--config", default="")
    p.add_argument("--storage", default="")
    # comma-separated peer GCS endpoints (the warm standby): probed for
    # split-brain fencing — a peer at a higher epoch means THIS daemon
    # was failed over and must stop serving
    p.add_argument("--peers", default="")
    args = p.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="[gcs %(asctime)s] %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    if args.config:
        import json

        GLOBAL_CONFIG.load(json.loads(args.config))

    async def run() -> int:
        gcs = GcsServer(
            args.sock, storage_path=args.storage or None,
            peer_addrs=[a.strip() for a in args.peers.split(",")
                        if a.strip()],
        )
        await gcs.start()
        # serve until epoch-fenced (never, without a promoted peer);
        # exit code 3 tells the supervisor this was a split-brain
        # rejection, not a crash — do not blindly respawn
        await gcs._fenced.wait()
        return 3

    sys.exit(asyncio.run(run()))


if __name__ == "__main__":
    main()
