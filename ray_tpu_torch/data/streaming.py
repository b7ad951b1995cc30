"""Streaming executor: pipelined block processing with backpressure.

Parity: reference ``python/ray/data/_internal/execution/streaming_executor.py``
(:49, loop step :217), the op-state machine ``streaming_executor_state.py``
(:312,376 ``select_operator_to_run``), the physical operators under
``_internal/execution/operators/`` (``TaskPoolMapOperator`` /
``ActorPoolMapOperator``) and the exchange machinery
(``_internal/planner/exchange/``, ``push_based_shuffle.py``). Blocks flow
between operators as ObjectRefs (never materialized on the driver).

Two operator kinds:

- ``Stage`` — 1:1 per-block map, executed as remote tasks (default) or on a
  stateful actor pool (``compute=ActorPoolStrategy(...)`` — the reference's
  ActorPoolMapOperator; required for class UDFs that carry expensive state
  like a loaded model).
- ``ExchangeStage`` — an all-to-all (shuffle/sort/repartition/groupby)
  executed INSIDE the streaming machine: an optional per-block ``prepare``
  pass (samples/counts) runs as inputs arrive, the partition pass
  (``num_returns=P`` tasks) runs streamingly behind upstream, and merges
  launch in output order under the downstream buffer cap, dropping each
  partition column's refs as soon as its merge completes. The unavoidable
  exchange footprint (every partition output exists between the last
  partition and its merge) lives in the object store where spilling, not
  driver memory, absorbs datasets larger than RAM.

Backpressure: a map stage is only scheduled when its un-consumed output +
in-flight (+ the terminal reorder buffer for the last stage) is under
``max_buffered_blocks``; the block the ordered consumer needs next bypasses
the cap so a full reorder buffer can't deadlock behind one straggler.

Card shape: the terminal consumer is typically a process feeding its card
through ``data.iterator.device_batches``; keeping the object plane as the
buffer means host RAM, not device memory, absorbs burstiness.

Fast-plane composition:

- **Placement-aware block routing** — ``locality_hints`` (rank-ordered
  node ids, e.g. a consuming ``MeshGroup``'s members) soft-pin the
  ordered tail of the pipeline so output block ``idx`` is PRODUCED on
  the host that will consume shard ``idx % n``: the consumer's ``get``
  is then a same-arena zero-copy map, not a cross-node transfer. Stages
  before the last exchange (no stable shard mapping) stay inside the
  consuming gang via a soft ``raytpu.io/gang`` label constraint
  (``gang=``), so intermediate blocks ride the same-host/same-gang
  locality classes the stripe-peer picker already prefers.
- **Packed exchanges** — a partition task's P outputs land as ONE
  contiguous packed block instead of P per-column refs; every merge of
  the exchange then pulls the SAME object and slices its partition out.
  K merges of a hot partition block ride the transient pull registry /
  partial-serve broadcast tree, costing the producing node
  ~O(tree fanout) egress instead of K point reads. Wide exchanges
  (nparts > ``data_exchange_packed_max_parts``) keep the per-column
  shape, where moving only 1/P of each input per merge is cheaper than
  the tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch


class ActorPoolStrategy:
    """``map_batches(..., compute=ActorPoolStrategy(size=n))`` — process
    blocks on ``size`` long-lived actors instead of stateless tasks
    (parity: reference ``ActorPoolMapOperator`` / ``ActorPoolStrategy``).
    Class UDFs are constructed once per actor."""

    def __init__(self, size: int = 2, max_tasks_in_flight_per_actor: int = 2):
        if size < 1:
            raise ValueError("ActorPoolStrategy size must be >= 1")
        self.size = size
        self.per_actor = max_tasks_in_flight_per_actor


class Stage:
    """One 1:1 map operator.

    ``fn``: block-UDF (or a class — actors only), receiving the block in
    ``batch_format``: None = native block form (row ``list`` or columnar
    ``dict[str, np.ndarray]``), "rows" = list of rows, "numpy" = columnar
    batch. Returns rows, a dict-of-arrays, or an ndarray.
    ``with_index=True`` passes the block's pipeline position as a second
    argument (map stages are 1:1, so the index is stable end-to-end)."""

    def __init__(self, name: str, fn: Callable, num_cpus: float = 1.0,
                 with_index: bool = False,
                 batch_format: Optional[str] = None,
                 compute: Optional[ActorPoolStrategy] = None):
        if batch_format not in (None, "rows", "numpy"):
            raise ValueError(f"unknown batch_format {batch_format!r}")
        if isinstance(fn, type) and compute is None:
            raise ValueError(
                "class UDFs require compute=ActorPoolStrategy(...) "
                "(state lives on pool actors, not per-task)"
            )
        self.name = name
        self.fn = fn
        self.num_cpus = num_cpus
        self.with_index = with_index
        self.batch_format = batch_format
        self.compute = compute

    def __repr__(self):
        return f"Stage({self.name})"


class ExchangeStage:
    """One all-to-all operator: prepare? -> partition -> merge.

    ``prepare_fn(block) -> meta``: optional per-input-block pass (e.g. key
    samples for sort boundaries, row counts for repartition) run as blocks
    arrive; ``make_partition(metas: dict[idx -> meta]) -> partition_fn``
    builds the partition body once all metas are in (called immediately
    with ``{}`` when there is no prepare pass);
    ``partition_fn(block, idx) -> P blocks``; ``merge_fn(p, *parts) ->
    block`` merges column ``p`` of every input."""

    def __init__(self, name: str, nparts: int,
                 make_partition: Callable[[Dict[int, Any]], Callable],
                 merge_fn: Callable, prepare_fn: Optional[Callable] = None,
                 num_cpus: float = 1.0, packed: Optional[bool] = None):
        if nparts < 1:
            raise ValueError("nparts must be >= 1")
        self.name = name
        self.nparts = nparts
        self.make_partition = make_partition
        self.merge_fn = merge_fn
        self.prepare_fn = prepare_fn
        self.num_cpus = num_cpus
        # None = decide by width (see module docstring): narrow exchanges
        # pack so hot partition blocks ride the broadcast tree, wide ones
        # keep per-column refs
        self.packed = packed

    def is_packed(self) -> bool:
        if self.packed is not None:
            return self.packed
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return self.nparts <= int(
            GLOBAL_CONFIG.data_exchange_packed_max_parts
        )

    def __repr__(self):
        return f"ExchangeStage({self.name}, P={self.nparts})"


# ---------------- task bodies ----------------


def _run_stage_fn(fn, batch_format, with_index, idx, block):
    from ray_tpu_torch.data.block import BlockAccessor

    if batch_format is None:
        arg = block
    else:
        acc = BlockAccessor.for_block(block)
        arg = acc.to_rows() if batch_format == "rows" else (
            acc.to_numpy_batch()
        )
    out = fn(arg, idx) if with_index else fn(arg)
    return BlockAccessor.batch_to_block(out)


class _PoolWorker:
    """Actor-pool worker: constructs a class UDF once, applies it per block."""

    def __init__(self, fn_or_cls, batch_format, with_index):
        self._fn = fn_or_cls() if isinstance(fn_or_cls, type) else fn_or_cls
        self._fmt = batch_format
        self._with_index = with_index

    def apply(self, idx, block):
        return _run_stage_fn(self._fn, self._fmt, self._with_index, idx,
                             block)


def _run_partition(partition_fn, idx, nparts, block):
    parts = partition_fn(block, idx)
    if len(parts) != nparts:
        raise ValueError(
            f"partition_fn returned {len(parts)} parts, expected {nparts}"
        )
    return parts[0] if nparts == 1 else tuple(parts)


def _run_merge(merge_fn, p, *parts):
    return merge_fn(p, *parts)


def _run_partition_packed(partition_fn, idx, nparts, block):
    """Packed-exchange partition body: the P parts land as ONE contiguous
    block plus a row-offset table, stored once — every merge of this
    exchange pulls this single (possibly hot) object and the concurrent
    pulls ride the broadcast tree instead of P point reads."""
    from ray_tpu_torch.data.block import BlockAccessor

    parts = partition_fn(block, idx)
    if len(parts) != nparts:
        raise ValueError(
            f"partition_fn returned {len(parts)} parts, expected {nparts}"
        )
    offsets = [0]
    for part in parts:
        offsets.append(
            offsets[-1] + BlockAccessor.for_block(part).num_rows()
        )
    return offsets, BlockAccessor.concat(list(parts))


def _slice_packed_part(packed, p):
    """Materialize partition ``p`` out of one packed block: a plain slice
    would be a VIEW pinning the whole packed object in the store for the
    merge's lifetime — copy out only the partition's rows instead."""
    from ray_tpu_torch.data.block import BlockAccessor

    offsets, block = packed
    part = BlockAccessor.for_block(block).slice(offsets[p], offsets[p + 1])
    if isinstance(part, dict):
        return {k: np.array(v) for k, v in part.items()}
    return list(part)


def _run_merge_packed(merge_fn, p, packed_refs):
    """Packed-exchange merge body: fetches the packed partition blocks
    ONE AT A TIME (each ``get`` is a locality-aware windowed striped pull
    — deposit sinks wire->arena — deduplicated against sibling merges by
    the local store and tree-assembled by the pull registry when the
    block is hot), slices out partition ``p``, and drops the shm pin
    before the next pull so a store smaller than the exchange still
    flows by eviction/spilling."""
    import ray_tpu_torch

    parts = []
    for ref in packed_refs:
        packed = ray_tpu_torch.get(ref)
        parts.append(_slice_packed_part(packed, p))
        del packed  # release the packed block's pin before the next pull
    return merge_fn(p, *parts)


# ---------------- executor ----------------

_MAP, _EXCHANGE = "map", "exchange"


class _OpState:
    """Driver-side runtime state for one operator."""

    def __init__(self, stage, index: int):
        self.stage = stage
        self.index = index
        self.kind = _EXCHANGE if isinstance(stage, ExchangeStage) else _MAP
        self.inputs: List[Tuple[int, Any]] = []   # (idx, ref) pending
        self.inflight: Dict[Any, Tuple] = {}      # signal ref -> meta
        self.outputs: List[Tuple[int, Any]] = []  # (idx, ref) finished
        self.no_more_inputs = False
        # map/actor-pool state
        self.pool: List = []            # actors (lazy)
        self.pool_load: List[int] = []  # in-flight per actor
        # exchange state
        self.phase = "prepare"          # prepare -> partition -> merge
        self.metas: Dict[int, Any] = {}
        self.held: List[Tuple[int, Any]] = []   # inputs awaiting partition
        self.parts: Dict[int, List] = {}        # input idx -> P part refs
        self.partition_fn = None
        self.partition_task = None
        self.merge_task = None
        self.merges_launched = 0
        self.merges_done = 0
        self.merge_order: Optional[List[int]] = None  # sorted input idxs

    def done(self) -> bool:
        base = (self.no_more_inputs and not self.inputs
                and not self.inflight and not self.outputs)
        if self.kind == _MAP:
            return base
        return (base and not self.held
                and (self.phase == "merge")
                and self.merges_launched >= self.stage.nparts)


class StreamingExecutor:
    """Pull-based streaming execution of ``stages`` over ``source_blocks``.

    ``max_tasks_in_flight``: per-operator concurrent task cap.
    ``max_buffered_blocks``: per-map-stage output-queue cap — the
    backpressure valve. Exchange partition outputs are exempt (the
    all-to-all footprint is inherent and spillable; see module docstring).

    ``locality_hints``: rank-ordered node ids (hex) — output block
    ``idx`` (and the 1:1 tail producing it) is soft-pinned to
    ``hints[idx % n]``, the host consuming shard ``idx % n``.
    ``gang``: a MeshGroup name — stages with no stable shard mapping get
    a soft ``raytpu.io/gang`` label constraint so intermediate blocks
    stay on gang hosts.
    """

    def __init__(
        self,
        stages: List[Any],
        source_blocks: List[Any],  # ObjectRefs of input blocks
        max_tasks_in_flight: int = 4,
        max_buffered_blocks: int = 4,
        locality_hints: Optional[List[str]] = None,
        gang: Optional[str] = None,
    ):
        self.max_in_flight = max_tasks_in_flight
        self.max_buffered = max_buffered_blocks
        self._hints = [
            h.hex() if isinstance(h, bytes) else str(h)
            for h in (locality_hints or [])
        ]
        self._gang = gang
        self._routed_launches = 0  # shard-pinned task launches (tests)
        self._task_memo: Dict[Any, Any] = {}  # see _task_for
        self.ops = [_OpState(s, i) for i, s in enumerate(stages)]
        self._source = list(enumerate(source_blocks))
        self._no_op_outputs: List[Tuple[int, Any]] = []
        if self.ops:
            self.ops[0].inputs = list(self._source)
            self.ops[0].no_more_inputs = True
        else:
            self._no_op_outputs = list(self._source)
        self._peak_buffered = 0  # observability / tests
        self._ready: Dict[int, Any] = {}  # terminal reorder buffer
        self._next_idx = 0
        # ops at/after this index feed the ordered terminal through 1:1
        # maps only — HOL bypass applies there; ops before the last
        # exchange feed an unordered consumer (the exchange itself).
        last_ex = max(
            (i for i, o in enumerate(self.ops) if o.kind == _EXCHANGE),
            default=-1,
        )
        self._ordered_from = last_ex + 1

    # -- backpressure accounting --

    def _buffered(self, i: int) -> int:
        op = self.ops[i]
        n = len(op.outputs)
        if op.kind == _MAP:
            n += len(op.inflight)
        else:
            n += sum(1 for m in op.inflight.values() if m[0] == "merge")
        if i == len(self.ops) - 1:
            n += len(self._ready)
        return n

    def _wants_next(self, entries, i: int) -> bool:
        """Does this (idx, ref) list contain the terminal's next block?"""
        if i < self._ordered_from:
            return False
        return any(idx == self._next_idx for idx, _ in entries)

    # -- scheduling --

    def _schedulable(self, i: int) -> bool:
        op = self.ops[i]
        if op.kind == _MAP:
            if not op.inputs:
                return False
            if len(op.inflight) >= self.max_in_flight:
                return False
            if op.stage.compute is not None and op.pool and not any(
                load < op.stage.compute.per_actor for load in op.pool_load
            ):
                return False  # every pool actor is at its in-flight cap
            if self._buffered(i) < self.max_buffered:
                return True
            return self._wants_next(op.inputs, i)
        return self._exchange_schedulable(op)

    def _exchange_schedulable(self, op: "_OpState") -> bool:
        st = op.stage
        if op.phase == "prepare":
            if st.prepare_fn is None:
                # no prepare pass: partition directly
                if op.partition_fn is None:
                    op.partition_fn = st.make_partition({})
                op.phase = "partition"
                return self._exchange_schedulable(op)
            if (op.no_more_inputs and not op.inputs and not op.inflight):
                # all prepares done (or zero inputs): move on
                op.partition_fn = st.make_partition(op.metas)
                op.phase = "partition"
                return self._exchange_schedulable(op)
            return bool(op.inputs) and len(op.inflight) < self.max_in_flight
        if op.phase == "partition":
            if op.inputs or op.held:
                return len(op.inflight) < self.max_in_flight
            if (op.no_more_inputs and not op.inflight
                    and op.partition_fn is not None):
                op.merge_order = sorted(op.parts)
                op.phase = "merge"
                return self._exchange_schedulable(op)
            return False
        # merge phase: launch merges in output order, under the output cap
        if op.merges_launched >= st.nparts:
            return False
        if len(op.inflight) >= self.max_in_flight:
            return False
        if self._buffered(op.index) < self.max_buffered:
            return True
        # HOL: the next merge IS the terminal's next block when only maps
        # follow this exchange
        return (op.index >= self._ordered_from - 1
                and op.merges_launched == self._next_idx)

    # -- placement-aware routing --

    def _placement(self, idx, tail: bool):
        """(strategy, memo-key) for a task launch. Tail tasks (the 1:1
        ordered chain producing output block ``idx``) are soft-pinned to
        the host consuming shard ``idx % n`` — the block lands in that
        host's store arena, so the consumer's ``get`` is a same-host
        zero-copy map. Stages with no stable shard mapping (pre-exchange
        maps, prepare/partition tasks) get the soft ``raytpu.io/gang``
        label instead, keeping their blocks in locality classes 0/1.
        Soft means soft: a saturated or lost hint node degrades to
        default placement, never an infeasible task."""
        if tail and self._hints:
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy,
            )

            h = self._hints[idx % len(self._hints)]
            return NodeAffinitySchedulingStrategy(h, soft=True), ("s", h)
        if self._gang:
            from ray_tpu_torch._private.protocol import LABEL_GANG
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeLabelSchedulingStrategy,
            )

            return NodeLabelSchedulingStrategy(
                soft={LABEL_GANG: [self._gang]}
            ), ("g",)
        return None, None

    def _task_for(self, body, num_cpus, idx=None, tail: bool = False,
                  num_returns=None):
        """Memoized task wrapper: a fresh ``ray_tpu_torch.remote()(body)`` +
        ``.options()`` per launch is measurable per-task Python at
        ingest rates, and placement is a pure function of
        (body, idx % n, gang) — so the handful of distinct wrappers is
        built once and reused for the whole execution."""
        if tail and self._hints:
            self._routed_launches += 1
        strat, skey = self._placement(idx, tail)
        key = (id(body), float(num_cpus), skey, num_returns)
        task = self._task_memo.get(key)
        if task is None:
            task = ray_tpu_torch.remote(num_cpus=num_cpus)(body)
            opts = {}
            if strat is not None:
                opts["scheduling_strategy"] = strat
            if num_returns is not None:
                opts["num_returns"] = num_returns
            if opts:
                task = task.options(**opts)
            self._task_memo[key] = task
        return task

    def _launch(self, i: int):
        op = self.ops[i]
        if op.kind == _MAP:
            self._launch_map(op)
        else:
            self._launch_exchange(op)

    def _launch_map(self, op: "_OpState"):
        st = op.stage
        # Pop the lowest pipeline index first: the ordered consumer wants
        # low indices, and FIFO arrival order is not index order once
        # upstream tasks complete out of order.
        k = min(range(len(op.inputs)), key=lambda j: op.inputs[j][0])
        idx, block_ref = op.inputs.pop(k)
        if st.compute is not None:
            # pool actors are long-lived and shared across shards: no
            # per-block routing (the pool amortizes state, not locality)
            if not op.pool:
                actor_cls = ray_tpu_torch.remote(num_cpus=st.num_cpus)(_PoolWorker)
                op.pool = [
                    actor_cls.remote(st.fn, st.batch_format, st.with_index)
                    for _ in range(st.compute.size)
                ]
                op.pool_load = [0] * len(op.pool)
            a = min(range(len(op.pool)), key=lambda j: op.pool_load[j])
            out_ref = op.pool[a].apply.remote(idx, block_ref)
            op.pool_load[a] += 1
            op.inflight[out_ref] = ("map", idx, a)
            return
        task = self._task_for(
            _run_stage_fn, st.num_cpus, idx=idx,
            tail=op.index >= self._ordered_from,
        )
        out_ref = task.remote(st.fn, st.batch_format, st.with_index, idx,
                              block_ref)
        op.inflight[out_ref] = ("map", idx, None)

    def _launch_exchange(self, op: "_OpState"):
        st = op.stage
        if op.phase == "prepare":
            idx, ref = op.inputs.pop(0)
            op.held.append((idx, ref))
            task = self._task_for(st.prepare_fn, st.num_cpus)
            sig = task.remote(ref)
            op.inflight[sig] = ("prepare", idx)
            return
        if op.phase == "partition":
            if op.inputs:
                idx, ref = op.inputs.pop(0)
            else:
                idx, ref = op.held.pop(0)
            if st.is_packed():
                task = self._task_for(_run_partition_packed, st.num_cpus)
                pref = task.remote(op.partition_fn, idx, st.nparts, ref)
                op.parts[idx] = [pref]
                op.inflight[pref] = ("part", idx, ref)
                return
            task = self._task_for(_run_partition, st.num_cpus,
                                  num_returns=st.nparts)
            out = task.remote(op.partition_fn, idx, st.nparts, ref)
            refs = [out] if st.nparts == 1 else list(out)
            op.parts[idx] = refs
            # signal ref (part 0) carries the input ref so it stays alive
            # until the partition task has consumed it
            op.inflight[refs[0]] = ("part", idx, ref)
            return
        # merge. The LAST exchange's merge p IS output block p: route it
        # to the consuming shard's host.
        p = op.merges_launched
        op.merges_launched += 1
        tail = op.index == self._ordered_from - 1
        if st.is_packed():
            # every merge reads the SAME packed blocks: pass the refs as
            # a VALUE (not auto-resolved args) so the merge task pulls
            # them one at a time — concurrent merges of a hot packed
            # block then form a broadcast tree instead of K point reads
            refs = [op.parts[j][0] for j in op.merge_order]
            task = self._task_for(_run_merge_packed, st.num_cpus,
                                  idx=p, tail=tail)
            sig = task.remote(st.merge_fn, p, refs)
            op.inflight[sig] = ("merge", p)
            return
        cols = [op.parts[j][p] for j in op.merge_order]
        task = self._task_for(_run_merge, st.num_cpus, idx=p, tail=tail)
        sig = task.remote(st.merge_fn, p, *cols)
        op.inflight[sig] = ("merge", p)

    # -- pump --

    def _harvest_one(self, op: "_OpState", sig, meta):
        kind = meta[0]
        if kind == "map":
            idx, actor = meta[1], meta[2]
            op.outputs.append((idx, sig))
            if actor is not None:
                op.pool_load[actor] -= 1
        elif kind == "prepare":
            op.metas[meta[1]] = ray_tpu_torch.get(sig)
            if (op.no_more_inputs and not op.inputs and not any(
                m[0] == "prepare" for m in op.inflight.values()
            )):
                op.partition_fn = op.stage.make_partition(op.metas)
                op.phase = "partition"
        elif kind == "part":
            pass  # parts recorded at launch; input ref now droppable
        elif kind == "merge":
            p = meta[1]
            op.outputs.append((p, sig))
            op.merges_done += 1
            if op.stage.is_packed():
                # every merge reads every packed block: the refs free
                # together once the LAST merge has consumed them
                if op.merges_done >= op.stage.nparts:
                    op.parts.clear()
            else:
                # free this partition column: its refs are no longer
                # needed
                for j in list(op.parts):
                    if p < len(op.parts[j]):
                        op.parts[j][p] = None

    def _pump(self, timeout: float = 0.2) -> bool:
        """One loop step: launch what's schedulable, harvest what finished.
        Returns True if anything might still move."""
        launched = False
        # Prefer downstream stages (drain before filling; reference's
        # select_operator_to_run ranks by downstream memory usage).
        for i in reversed(range(len(self.ops))):
            while self._schedulable(i):
                self._launch(i)
                launched = True
        all_inflight = [
            (sig, op) for op in self.ops for sig in op.inflight
        ]
        if all_inflight:
            sigs = [sig for sig, _ in all_inflight]
            ready, _ = ray_tpu_torch.wait(
                sigs,
                num_returns=1,
                timeout=None if launched else timeout,
                fetch_local=False,
            )
            if ready:
                # drain EVERYTHING already finished, not just the one
                # the blocking wait returned: harvesting one completion
                # per loop iteration made each output block pay a full
                # launch-scan + wait round (~2x block latency at ingest
                # rates)
                ready, _ = ray_tpu_torch.wait(
                    sigs, num_returns=len(sigs), timeout=0,
                    fetch_local=False,
                )
            ready_set = set(ready)
            for sig, op in all_inflight:
                if sig in ready_set:
                    self._harvest_one(op, sig, op.inflight.pop(sig))
        buffered = (
            sum(self._buffered(i) for i in range(len(self.ops)))
            # _buffered(last) already counted _ready once; don't recount
        )
        self._peak_buffered = max(self._peak_buffered, buffered)
        return bool(all_inflight or launched)

    # -- wiring --

    def _wire(self):
        """Move finished blocks downstream — but only while the downstream
        stage is under its buffer cap, so backpressure propagates upstream
        (a full stage j stalls stage j-1's scheduling via its output
        queue). The terminal's head-of-line block moves regardless."""
        for i in range(len(self.ops) - 1):
            j = i + 1
            dn = self.ops[j]
            while self.ops[i].outputs:
                if dn.kind == _EXCHANGE:
                    # exchanges consume unordered and retain inputs anyway;
                    # keep their pending queue modest, no ordering logic
                    if len(dn.inputs) >= self.max_buffered + (
                        self.max_in_flight
                    ):
                        break
                    dn.inputs.append(self.ops[i].outputs.pop(0))
                    continue
                under_cap = (
                    len(dn.inputs) + self._buffered(j) < self.max_buffered
                )
                has_next = self._wants_next(self.ops[i].outputs, j)
                if not under_cap and not has_next:
                    break
                if under_cap:
                    k = 0
                else:
                    k = next(
                        k for k, (idx, _) in enumerate(self.ops[i].outputs)
                        if idx == self._next_idx
                    )
                dn.inputs.append(self.ops[i].outputs.pop(k))
        # propagate upstream-done flags (op 0 is seeded at init)
        for i in range(1, len(self.ops)):
            up = self.ops[i - 1]
            self.ops[i].no_more_inputs = (
                up.no_more_inputs and not up.inputs and not up.inflight
                and not up.outputs and not up.held
                and (up.kind == _MAP or (
                    up.phase == "merge"
                    and up.merges_launched >= up.stage.nparts
                ))
            )

    def _done(self) -> bool:
        return all(op.done() for op in self.ops)

    def stats(self) -> Dict[str, Any]:
        """Executor observability: peak buffered blocks (backpressure
        proof) and how many task launches were shard-routed to a
        locality hint (placement proof)."""
        return {
            "peak_buffered": self._peak_buffered,
            "routed_launches": self._routed_launches,
            "hints": len(self._hints),
            "gang": self._gang,
        }

    # -- consumption --

    def iter_output_refs(self) -> Iterator[Any]:
        """Yield final-stage block refs in OUTPUT-INDEX ORDER as they
        materialize (reference parity: dataset iteration order is
        deterministic). Out-of-order blocks wait in ``self._ready``, which
        counts toward the last stage's buffer cap (``_buffered``) so the
        pipeline cannot run ahead behind one straggler; the head-of-line
        block bypasses the cap so that straggler always completes."""
        if not self.ops:
            for _idx, ref in self._no_op_outputs:
                yield ref
            return
        last = self.ops[-1]
        try:
            while True:
                self._wire()
                while last.outputs:
                    idx, ref = last.outputs.pop(0)
                    self._ready[idx] = ref
                while self._next_idx in self._ready:
                    yield self._ready.pop(self._next_idx)
                    self._next_idx += 1
                if self._done():
                    for idx in sorted(self._ready):  # stragglers: none expected
                        yield self._ready.pop(idx)
                    self._next_idx = 0
                    return
                self._pump()
        finally:
            # covers early exit (take(n) closing the generator) too
            self._shutdown_pools()

    def _shutdown_pools(self):
        for op in self.ops:
            for a in op.pool:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            op.pool = []
