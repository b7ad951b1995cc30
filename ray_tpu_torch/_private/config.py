"""Global config table, env-var overridable.

Design parity: the reference's ``RAY_CONFIG(type, name, default)`` macro table
(``src/ray/common/ray_config_def.h``, 205 entries) materialized as a singleton with
``RAY_<name>`` env overrides.  Here: a typed registry with ``RAYTPU_<NAME>`` env
overrides plus a runtime ``system_config`` dict applied at ``init()`` and shipped to
every worker (the reference distributes ``_system_config`` through the GCS).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAYTPU_"


class _ConfigEntry:
    __slots__ = ("name", "type", "default", "value")

    def __init__(self, name, type_, default):
        self.name = name
        self.type = type_
        self.default = default
        self.value = default


class Config:
    def __init__(self):
        self._entries: Dict[str, _ConfigEntry] = {}

    def define(self, name: str, type_, default):
        self._entries[name] = _ConfigEntry(name, type_, default)

    def __getattr__(self, name: str):
        entries = object.__getattribute__(self, "_entries")
        if name in entries:
            return entries[name].value
        raise AttributeError(name)

    def get(self, name: str):
        return self._entries[name].value

    def initialize(self, system_config: Dict[str, Any] | None = None):
        """Apply env vars then the explicit system_config dict (highest priority)."""
        for e in self._entries.values():
            e.value = e.default
            env = os.environ.get(_ENV_PREFIX + e.name.upper())
            if env is not None:
                e.value = _coerce(env, e.type)
        for k, v in (system_config or {}).items():
            if k not in self._entries:
                raise ValueError(f"Unknown system config key: {k}")
            self._entries[k].value = _coerce(v, self._entries[k].type)

    def dump(self) -> Dict[str, Any]:
        return {k: e.value for k, e in self._entries.items()}

    def load(self, dumped: Dict[str, Any]):
        for k, v in dumped.items():
            if k in self._entries:
                self._entries[k].value = v


def _coerce(v, type_):
    if isinstance(v, str):
        if type_ is bool:
            return v.lower() in ("1", "true", "yes")
        if type_ in (dict, list):
            return json.loads(v)
        return type_(v)
    return type_(v)


GLOBAL_CONFIG = Config()
_d = GLOBAL_CONFIG.define

# --- core ---
_d("object_store_memory_bytes", int, 2 * 1024**3)
_d("inline_object_max_bytes", int, 100 * 1024)  # small objects ride in RPCs
_d("default_max_retries", int, 3)
_d("health_check_period_ms", int, 1000)
_d("health_check_timeout_ms", int, 10000)
# how long CoreWorker.shutdown waits for its RPC server to stop before it
# aborts the connections that are left (an unread in-flight reply would
# otherwise hold the stop forever)
_d("core_worker_shutdown_timeout_s", float, 5.0)
_d("lineage_pinning_enabled", bool, True)
# streaming generators: executor pauses when this many reported yields are
# unconsumed by the caller (parity: reference
# _generator_backpressure_num_objects)
_d("streaming_generator_backpressure_items", int, 8)
# cross-process span propagation in task metadata (reference
# RAY_TRACING_ENABLED / tracing_helper.py:322)
_d("tracing_enabled", bool, False)
_d("prestart_workers", bool, True)
_d("infeasible_task_grace_s", float, 30.0)
_d("object_transfer_chunk_bytes", int, 8 * 1024 * 1024)
# outbound chunk-serve concurrency per raylet: bounds chunk payloads
# pinned in flight on the send side (zero-copy sends hold their store
# pin until the bytes hit the socket) — push-manager pacing role
_d("object_transfer_max_concurrent_chunks", int, 16)
# windowed pipelining: chunk requests a puller keeps in flight PER PEER
# (bandwidth is window*chunk per RTT instead of one chunk per RTT)
_d("object_transfer_window", int, 8)
# multi-peer striping: a pull fetches disjoint chunk ranges from up to
# this many location-holding raylets concurrently
_d("object_transfer_stripe_peers", int, 3)
# per-chunk-request timeout inside a windowed pull (covers queueing
# behind the window, not just the wire RTT)
_d("object_transfer_chunk_timeout_s", float, 30.0)
# same-peer retries per chunk before the peer is declared failed and its
# ranges hand over to the other stripe peers (a chaos-dropped frame
# costs one chunk timeout, not the whole striped attempt)
_d("object_transfer_chunk_retries", int, 2)
# full pull attempts (fresh locations + striped fetch) before giving up
_d("object_transfer_retries", int, 3)
# same-host fast path: when a LIVE peer raylet's store arena is
# reachable as a file (multi-raylet hosts, simulated clusters), pull by
# attaching it and copying arena-to-arena — no sockets (the reference
# shares plasma objects between same-node workers the same way)
_d("object_transfer_same_host_shm", bool, True)
# broadcast tree: K raylets pulling the SAME large object form a k-ary
# pull tree over the GCS pull registry (pull_begin/pull_end) — children
# stream chunk ranges off an ancestor's IN-PROGRESS pull (partial serve)
# instead of K-x'ing the source NIC (reference pull-manager dedup role).
# This is the fanout k; 0 disables the tree (every puller hits a sealed
# location directly).
_d("object_broadcast_fanout", int, 2)
# objects below this size skip the tree (a sub-chunk object gains
# nothing from riding behind a parent's pull)
_d("object_broadcast_min_bytes", int, 16 * 1024 * 1024)
# --- data plane (streaming ingest) ---
# soft-affinity tasks queued at a feasible-but-SATURATED target node
# spill to an idle peer after this long ungranted (transient saturation
# keeps locality; a consumer-holds-the-slots deadlock degrades to
# default placement instead of wedging the pipeline)
_d("soft_affinity_spill_after_s", float, 0.2)
# packed exchanges: a partition task's P outputs land as ONE contiguous
# block that every merge pulls (hot blocks ride the broadcast tree —
# source egress O(fanout), not O(P)) when the exchange is at most this
# wide; wider exchanges keep per-column refs, where moving 1/P of each
# input per merge beats re-pulling the whole pack P times. 0 disables
# packing entirely (legacy per-column shape).
_d("data_exchange_packed_max_parts", int, 8)
# how many tasks an owner keeps in flight per lease. DEFAULT 1: a task
# blocked in a nested get() must not strand tasks committed behind it on
# the same serial worker (they would get their own leases instead).
# Raise for flat data-parallel workloads (the perf bench uses 8) —
# parity: reference max_tasks_in_flight_per_worker lease multiplexing.
_d("lease_push_pipeline_depth", int, 1)
# ms an exhausted push loop lingers on its leased worker waiting for new
# same-shaped tasks before returning it (0 = return immediately). Bursty
# submitters avoid a full lease round trip per burst — parity: reference
# idle worker-lease caching (worker_lease_timeout_milliseconds)
_d("lease_keepalive_ms", int, 0)
# in-flight pushed calls per ordered actor (round 4 pipelined submitter;
# the executor's per-caller ticket queue keeps execution submission-order)
_d("actor_pipeline_depth", int, 256)
# serve worker task endpoints through the native conduit wire engine
# (src/conduit/conduit.cpp) when it builds; asyncio transport otherwise
_d("native_wire", bool, True)
# owners open their worker-push connections through the conduit engine
# too (corked bursts flush as ONE native cd_push_batch; frame parsing
# and socket IO leave the asyncio loop). Same wire format either way —
# disable to force the asyncio client transport (interop testing).
_d("native_push_conns", bool, True)
# task returns at most this many packed bytes ride INLINE in the
# task_done completion frame ("v" element) — the owner materializes the
# ObjectRef straight from the frame, no store put/pin/get round trip.
# Bigger returns are store-backed ("p" element). 0 disables inlining
# (every return store-backed — the legacy/interop fallback shape).
_d("task_inline_return_bytes", int, 64 * 1024)
# latency-shaped completion fast path (r11): a SINGLETON task_done
# (one-completion batch — the sync round-trip shape) resolves the
# return entry directly on the conduit reaper thread, skipping the
# coalesced reaper->loop wakeup the batched throughput path pays; the
# blocked caller wakes one thread-hop earlier. Bursty batches (>1
# completion/frame) keep the coalesced loop path. Disable to force
# every completion through the loop (debugging/interop testing).
_d("task_done_reaper_fastpath", bool, True)
# submit-leg twin of the above: a lone ordered-actor call on a warm
# streamed connection (empty queue, no pump in flight, plain args,
# free window credit) pushes its frame straight from the CALLER
# thread — no IO-loop wakeup on the submit leg at all. Bursts still
# ride the corked pump (the throughput path).
_d("actor_direct_submit", bool, True)
# raylet-side GCS read cache: object-location entries kept (LRU-ish
# bounded; populate-on-read, invalidated by the "locs" pubsub channel).
# 0 disables the cache (every pull round-trips the GCS directory).
_d("raylet_loc_cache_entries", int, 4096)
# conduit reap-queue high-water mark: past this many MB of unreaped
# frames the engine stops reading sockets (bounded memory under a
# stalled reaper; backpressure propagates to senders' queues)
_d("conduit_ev_high_water_mb", int, 512)
# cap on concurrent lease requests per (resources, strategy) key: enough
# to saturate a node's parallelism without parking one request per queued
# task at the raylet (100k-deep queues)
_d("max_lease_requests_in_flight", int, 32)
_d("memory_monitor_refresh_ms", int, 250)
_d("memory_usage_threshold", float, 0.95)
_d("task_events_enabled", bool, True)
_d("object_spilling_enabled", bool, True)
_d("object_spilling_threshold", float, 0.8)
# external spill target: "" = session-local disk; file:///path, or a
# bucket URI (gs://..., mock-bucket:///dir for cloud-free testing) —
# reference external_storage.py smart_open cloud spilling
_d("spill_storage_uri", str, "")
_d("log_to_driver", bool, True)
# "memory" | "file": file-backed GCS tables reload across GCS restarts
# (reference Redis-backed GCS FT, redis_store_client.h:33)
_d("gcs_storage_backend", str, "memory")
# file-backend durability policy: how often dirty tables snapshot, and
# whether each snapshot fsyncs data + dirent (power-loss durability at
# ~ms/write; default off — the file tier's threat model is GCS process
# death, where the atomic rename alone suffices)
_d("gcs_snapshot_interval_s", float, 0.5)
_d("gcs_snapshot_fsync", bool, False)
# external-storage URI (file:///mnt/nfs/..., bucket://...) mirroring every
# GCS snapshot: survives a lost head volume (the Redis-tier role of the
# reference's GCS FT); "" = local snapshots only
_d("gcs_snapshot_mirror_uri", str, "")
# --- delivery semantics / chaos survival ---
# sync rpc.Client replay: per-attempt timeout CAP (a dropped frame costs
# one attempt, not the caller's whole budget; slow handlers are safe —
# retries join the in-flight attempt via server dedup) and the total
# at-least-once retry window (wide enough to ride a GCS restart/
# partition/blackout; bounded so a permanently-dead server still
# errors). Server-side request-id dedup makes the replay
# effectively-once.
_d("client_call_attempt_timeout_s", float, 5.0)
_d("client_retry_window_s", float, 20.0)
# fsync the GCS mutation journal per append (SIGKILL survival needs only
# the write() -> page cache; fsync buys power-loss durability at ~ms/op)
_d("gcs_journal_fsync", bool, False)
# journal GROUP COMMIT (r11): mutations buffered within one event-loop
# tick land as ONE write+flush (+one fsync) batch; replies defer until
# the covering flush, so durable-at-ack is preserved. batch_max forces
# an immediate flush at that depth (1 = the legacy per-record shape);
# flush_interval_s > 0 trades mutation-ack latency for deeper batches
# (0 = flush at the end of the current tick).
_d("gcs_journal_batch_max", int, 256)
_d("gcs_journal_flush_interval_s", float, 0.0)
# after a journal-restored GCS boots, how long raylets get to re-register
# and reclaim their live actors before unclaimed ones are re-placed
_d("gcs_actor_recovery_grace_s", float, 10.0)
# --- train ---
# a worker group's torch.distributed rendezvous, and the bound on every
# collective of its process group (the reference's
# tpu_mesh_bootstrap_timeout_s)
_d("mesh_bootstrap_timeout_s", float, 300.0)
# --- mesh groups (gang-scheduled multi-rank jobs) ---
# STRICT_SPREAD gang reservation + worker boot budget
_d("mesh_group_placement_timeout_s", float, 120.0)
# torch.distributed rendezvous + global-mesh build budget (covers every
# rank's first torch import and CUDA context), and the gang process
# group's bound on every collective
_d("mesh_group_rendezvous_timeout_s", float, 180.0)
# per-lockstep-call budget (compile / run_step / save / restore); a rank
# missing the deadline breaks the gang exactly like a rank death
_d("mesh_group_step_timeout_s", float, 300.0)
