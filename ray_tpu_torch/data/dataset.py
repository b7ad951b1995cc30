"""Dataset: lazy block-based distributed data pipelines.

Parity: reference ``python/ray/data/dataset.py:170`` (Dataset over blocks
with a lazy plan), ``read_api.py`` sources, ``iterator.py`` consumption and
``streaming_split`` (``dataset.py:1125``). Blocks are row lists OR columnar
dicts of numpy arrays (block.py — the reference's Arrow/pandas block role):
columnar blocks live once in shm and reach consumers as zero-copy views,
so the trainer ingest path is array slicing, not per-row Python.

All-to-all ops (shuffle/sort/groupby/repartition) are ExchangeStages
executed inside the StreamingExecutor (shuffle.py) — they stream behind
the upstream pipeline instead of materializing it (reference
``push_based_shuffle.py`` role).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import VALUE_COL, BlockAccessor
from ray_tpu_torch.data.streaming import (
    ActorPoolStrategy,
    ExchangeStage,
    Stage,
    StreamingExecutor,
)


def batches_from_blocks(block_iter: Iterator, batch_size: int,
                        batch_format: str = "rows") -> Iterator:
    """Re-chunk a stream of NATIVE blocks into fixed-size batches (tail
    partial). Shared by Dataset.iter_batches and DataIterator.iter_batches.

    batch_format: "rows" yields lists of items; "numpy" yields the columnar
    batch (dict of arrays, or a bare stacked array for tensor/scalar rows)
    — the device-put-ready form (parity: reference
    iter_batches(batch_format="numpy")). A batch cut from a single columnar
    block is a zero-copy view over the object store.
    """
    # validate at CALL time (a generator would defer the error to first
    # iteration, far from the bad call site)
    if batch_format not in ("rows", "numpy"):
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def assemble(pending: List, n: int):
        taken, need = [], n
        while need:
            acc = BlockAccessor.for_block(pending[0])
            avail = acc.num_rows()
            if avail <= need:
                taken.append(pending.pop(0))
                need -= avail
            else:
                taken.append(acc.slice(0, need))      # views, no copy
                pending[0] = acc.slice(need, avail)
                need = 0
        if batch_format == "rows":
            out: List = []
            for b in taken:
                out.extend(BlockAccessor.for_block(b).to_rows())
            return out
        block = taken[0] if len(taken) == 1 else BlockAccessor.concat(taken)
        return BlockAccessor.for_block(block).to_numpy_batch()

    def gen():
        pending: List = []
        pending_rows = 0
        for block in block_iter:
            nrows = BlockAccessor.for_block(block).num_rows()
            if not nrows:
                continue
            pending.append(block)
            pending_rows += nrows
            while pending_rows >= batch_size:
                yield assemble(pending, batch_size)
                pending_rows -= batch_size
        if pending_rows:
            yield assemble(pending, pending_rows)

    return gen()


class Dataset:
    """Lazy pipeline: source block refs + a chain of stages (1:1 map stages
    and all-to-all ExchangeStages, both run by the StreamingExecutor).

    A Dataset may instead carry a ``source_factory`` — a thunk producing the
    source refs on first consumption (used by ``limit``/``union``, whose
    shapes depend on materialized content); the factory result is cached.
    """

    def __init__(self, source_refs: Optional[List] = None,
                 stages: Optional[List] = None,
                 source_factory: Optional[Callable[[], List]] = None,
                 plan_blocks: Optional[int] = None):
        if (source_refs is None) == (source_factory is None):
            raise ValueError(
                "exactly one of source_refs / source_factory required"
            )
        self._source = source_refs
        self._source_factory = source_factory
        self._stages = stages or []
        self._plan_blocks_hint = plan_blocks

    @property
    def _source_refs(self) -> List:
        if self._source is None:
            self._source = self._source_factory()
        return self._source

    def _num_source_blocks(self) -> int:
        if self._source is not None:
            return len(self._source)
        if self._plan_blocks_hint is not None:
            return self._plan_blocks_hint
        return len(self._source_refs)

    def _plan_width(self) -> int:
        """Output block count WITHOUT forcing a source_factory (exchange
        construction must stay lazy): falls back to a default width when
        the factory result isn't known yet."""
        if self._source is not None:
            n = len(self._source)
        elif self._plan_blocks_hint is not None:
            n = self._plan_blocks_hint
        else:
            n = 8  # unknown-width factory source: default exchange fan-out
        for s in self._stages:
            if isinstance(s, ExchangeStage):
                n = s.nparts
        return max(1, n)

    # ---------------- transforms (lazy) ----------------

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_format: Optional[str] = None,
        compute: Optional[ActorPoolStrategy] = None,
        num_cpus: float = 1.0,
        name: Optional[str] = None,
    ) -> "Dataset":
        """Per-block transform. ``fn`` receives the block as:
        ``batch_format=None`` — native form (row list or columnar dict);
        ``"rows"`` — list of rows; ``"numpy"`` — columnar batch. It may
        return rows, a dict of arrays (columnar), or an ndarray.

        ``compute=ActorPoolStrategy(size=n)`` runs blocks on n stateful
        actors (reference ActorPoolMapOperator); ``fn`` may then be a class,
        constructed once per actor (model-loading UDFs)."""
        return Dataset(
            self._source_refs,
            self._stages + [Stage(name or "map_batches", fn, num_cpus,
                                  batch_format=batch_format,
                                  compute=compute)],
        )

    def map(self, fn: Callable[[Any], Any], **kw) -> "Dataset":
        return self.map_batches(
            lambda rows, _fn=fn: [_fn(x) for x in rows],
            name="map", batch_format="rows", **kw,
        )

    def filter(self, fn: Callable[[Any], bool], **kw) -> "Dataset":
        return self.map_batches(
            lambda rows, _fn=fn: [x for x in rows if _fn(x)],
            name="filter", batch_format="rows", **kw,
        )

    def flat_map(self, fn: Callable[[Any], List[Any]], **kw) -> "Dataset":
        return self.map_batches(
            lambda rows, _fn=fn: [y for x in rows for y in _fn(x)],
            name="flat_map", batch_format="rows", **kw,
        )

    def select_columns(self, cols: List[str], **kw) -> "Dataset":
        def select(block, _c=tuple(cols)):
            if isinstance(block, dict):  # columnar: column subset, no copy
                return {k: block[k] for k in _c}
            return [{k: r[k] for k in _c} for r in block]

        return self.map_batches(select, name="select_columns", **kw)

    def drop_columns(self, cols: List[str], **kw) -> "Dataset":
        drop = set(cols)

        def dropper(block, _d=drop):
            if isinstance(block, dict):
                return {k: v for k, v in block.items() if k not in _d}
            return [
                {k: v for k, v in r.items() if k not in _d} for r in block
            ]

        return self.map_batches(dropper, name="drop_columns", **kw)

    def add_column(self, name: str, fn: Callable[[Any], Any],
                   **kw) -> "Dataset":
        def add(rows, _n=name, _fn=fn):
            return [{**r, _n: _fn(r)} for r in rows]

        return self.map_batches(add, name="add_column", batch_format="rows",
                                **kw)

    # ---------------- all-to-all ops (in-executor exchanges) ----------------

    def _materialized_refs(self) -> List:
        return list(self._executor().iter_output_refs())

    def _with_exchange(self, stage: ExchangeStage) -> "Dataset":
        if self._source is not None:
            return Dataset(self._source, self._stages + [stage])
        return Dataset(source_factory=self._source_factory,
                       stages=self._stages + [stage],
                       plan_blocks=self._plan_blocks_hint)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """EXACT global shuffle as a streaming exchange (reference
        push_based_shuffle.py semantics)."""
        from ray_tpu_torch.data.shuffle import shuffle_stage

        return self._with_exchange(shuffle_stage(self._plan_width(), seed))

    def repartition(self, num_blocks: int) -> "Dataset":
        from ray_tpu_torch.data.shuffle import repartition_stage

        return self._with_exchange(repartition_stage(num_blocks))

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        """Distributed sort (sampled range partition + per-partition sort);
        output is globally ordered across blocks."""
        from ray_tpu_torch.data.shuffle import sort_stage

        return self._with_exchange(
            sort_stage(self._plan_width(), key, descending)
        )

    def groupby(self, key) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        def build():
            refs = list(self._materialized_refs())
            for o in others:
                refs.extend(o._materialized_refs())
            return refs

        return Dataset(
            source_factory=build,
            plan_blocks=self._plan_width() + sum(
                o._plan_width() for o in others
            ),
        )

    def limit(self, n: int) -> "Dataset":
        """Truncate to the first n rows (lazy; on consumption, stops pulling
        upstream blocks once n rows have materialized)."""

        def build():
            out_refs, count = [], 0
            for ref in self._executor().iter_output_refs():
                acc = BlockAccessor.for_block(ray_tpu_torch.get(ref))
                if count + acc.num_rows() <= n:
                    out_refs.append(ref)
                    count += acc.num_rows()
                else:
                    out_refs.append(
                        ray_tpu_torch.put(acc.slice(0, n - count))
                    )
                    count = n
                if count >= n:
                    break
            return out_refs or [ray_tpu_torch.put([])]

        return Dataset(source_factory=build,
                       plan_blocks=self._plan_width())

    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets of near-equal row counts (materializing)."""
        import builtins

        from ray_tpu_torch.data.shuffle import repartition_blocks

        refs = repartition_blocks(self._materialized_refs(), n)
        return [Dataset([r]) for r in refs[:n]] + [
            Dataset([ray_tpu_torch.put([])])
            for _ in builtins.range(n - len(refs))
        ]

    # ---------------- aggregates ----------------

    def _column_values(self, on: Optional[str]) -> Iterator[Any]:
        for block in self.iter_native_blocks():
            vals = BlockAccessor.for_block(block).key_values(on)
            yield from vals

    def sum(self, on: Optional[str] = None):
        return sum(self._column_values(on))

    def min(self, on: Optional[str] = None):
        return min(self._column_values(on))

    def max(self, on: Optional[str] = None):
        return max(self._column_values(on))

    def mean(self, on: Optional[str] = None):
        total, n = 0.0, 0
        for v in self._column_values(on):
            total += v
            n += 1
        if not n:
            raise ValueError("mean() of an empty dataset")
        return total / n

    def std(self, on: Optional[str] = None, ddof: int = 1):
        import math

        vals = list(self._column_values(on))
        n = len(vals)
        if n <= ddof:
            raise ValueError("std() needs more rows than ddof")
        m = sum(vals) / n
        return math.sqrt(sum((v - m) ** 2 for v in vals) / (n - ddof))

    def schema(self) -> Optional[Dict[str, type]]:
        """Column name -> type from the first non-empty block (dict rows);
        non-dict rows report {'value': type}."""
        for block in self.iter_blocks():
            if block:
                row = block[0]
                if isinstance(row, dict):
                    return {k: type(v) for k, v in row.items()}
                return {"value": type(row)}
        return None

    # ---------------- sinks ----------------

    def to_pandas(self):
        import pandas as pd

        rows = self.take_all()
        if rows and not isinstance(rows[0], dict):
            rows = [{"value": r} for r in rows]
        return pd.DataFrame(rows)

    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data.io import write_dataset

        return write_dataset(self, path, "csv")

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data.io import write_dataset

        return write_dataset(self, path, "json")

    def write_tfrecords(self, path: str) -> List[str]:
        """Rows with a ``bytes`` field -> TFRecord files (spec-correct
        masked crc32c framing; readable by TensorFlow)."""
        from ray_tpu_torch.data.io import write_dataset

        return write_dataset(self, path, "tfrecords")

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data.io import write_dataset

        return write_dataset(self, path, "parquet")

    # ---------------- execution ----------------

    def _executor(self, **kw) -> StreamingExecutor:
        from ray_tpu_torch.data.plan import optimize

        return StreamingExecutor(
            optimize(self._stages), self._source_refs, **kw
        )

    def explain(self) -> str:
        """Logical + physical (fused) plan description — parity:
        reference logical-plan layer, _internal/logical/."""
        from ray_tpu_torch.data.plan import explain

        return explain(self)

    def iter_native_blocks(self, prefetch_blocks: int = 0,
                           **kw) -> Iterator:
        """Blocks in their stored form (row list or columnar dict).
        ``prefetch_blocks`` > 0 resolves upcoming blocks ahead of the
        consumer via the per-host prefetch agent (lag-bounded; see
        data/prefetch.py)."""
        if prefetch_blocks and prefetch_blocks > 0:
            from ray_tpu_torch.data.prefetch import BlockPrefetcher

            pf = BlockPrefetcher(
                self._executor(**kw).iter_output_refs(),
                max_ahead=prefetch_blocks,
            )
            try:
                yield from pf
            finally:
                pf.close()
            return
        for ref in self._executor(**kw).iter_output_refs():
            yield ray_tpu_torch.get(ref)

    def iter_blocks(self, **kw) -> Iterator[List]:
        """Blocks as ROW LISTS (legacy/compat view)."""
        for block in self.iter_native_blocks(**kw):
            yield BlockAccessor.for_block(block).to_rows()

    def iter_rows(self, **kw) -> Iterator[Any]:
        for block in self.iter_native_blocks(**kw):
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "rows",
                     prefetch_blocks: int = 0, **kw) -> Iterator:
        return batches_from_blocks(
            self.iter_native_blocks(prefetch_blocks=prefetch_blocks, **kw),
            batch_size, batch_format,
        )

    def iter_device_batches(self, batch_size: int = 256, *,
                            prefetch_batches: int = 2,
                            prefetch_blocks: int = 2,
                            sharding=None, device=None) -> Iterator:
        """Double-buffered batch feed onto the card — see
        DataIterator.iter_device_batches (same contract, single
        consumer; block prefetch ON by default)."""
        from ray_tpu_torch.data.iterator import device_batches

        return device_batches(
            lambda: self.iter_batches(
                batch_size, batch_format="numpy",
                prefetch_blocks=prefetch_blocks,
            ),
            prefetch_batches, device=device, sharding=sharding,
        )

    def take(self, n: int = 20) -> List:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(
            BlockAccessor.for_block(b).num_rows()
            for b in self.iter_native_blocks()
        )

    def materialize(self) -> "Dataset":
        """Execute the plan now; the result is a stage-free Dataset."""
        refs = list(self._executor().iter_output_refs())
        return Dataset(refs, [])

    def num_blocks(self) -> int:
        """Output block count of the (unexecuted) plan: map stages are 1:1,
        exchanges emit their partition count. May force a pending
        source_factory (limit/union) to learn its width."""
        n = self._num_source_blocks()
        for s in self._stages:
            if isinstance(s, ExchangeStage):
                n = s.nparts
        return n

    # ---------------- split ----------------

    def streaming_split(self, n: int,
                        locality_hints: Optional[List[str]] = None,
                        gang: Optional[str] = None,
                        ) -> List["DataIterator"]:
        """N per-consumer iterators fed round-robin from ONE streaming
        execution (reference dataset.py:1125 / stream_split_iterator.py:31).
        Blocks flow through a coordinator actor so consumers can live in
        different worker processes (e.g. TorchTrainer workers).

        ``locality_hints``: rank-ordered node ids (one per split) —
        split ``i``'s blocks are PRODUCED on ``hints[i]``, so consumer
        ``i``'s reads are same-host zero-copy maps instead of cross-node
        pulls (a consuming MeshGroup passes its members; see
        ``MeshGroup.split_dataset``). ``gang``: keeps the earlier,
        shard-agnostic stages on gang-labeled hosts."""
        from ray_tpu_torch.data.iterator import DataIterator, _SplitCoordinator

        import builtins

        if locality_hints is not None and len(locality_hints) != n:
            raise ValueError(
                f"locality_hints must have one node per split: got "
                f"{len(locality_hints)} hints for {n} splits"
            )
        coord_cls = ray_tpu_torch.remote(num_cpus=0.1)(_SplitCoordinator)
        coord = coord_cls.remote(self._source_refs, self._stages, n,
                                 locality_hints, gang)
        return [DataIterator(coord, i) for i in builtins.range(n)]

    def __repr__(self):
        from ray_tpu_torch.data.plan import optimize

        names = " -> ".join(
            s.name for s in optimize(self._stages)
        ) or "source"
        return f"Dataset({self._num_source_blocks()} blocks: {names})"


class GroupedData:
    """``ds.groupby(key)`` result (reference GroupedData, grouped_data.py):
    hash-partitioned exact aggregation — each key reduced exactly once,
    streaming behind the upstream pipeline."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _reduce(self, reducefn: Callable[[Any, List], Any]) -> Dataset:
        from ray_tpu_torch.data.shuffle import groupby_stage

        return self._ds._with_exchange(
            groupby_stage(self._ds._plan_width(), self._key, reducefn)
        )

    def count(self) -> Dataset:
        return self._reduce(lambda k, rows: {"key": k, "count": len(rows)})

    def _col_agg(self, name: str, on: str, agg) -> Dataset:
        def red(k, rows, _on=on, _agg=agg, _n=name):
            return {"key": k, f"{_n}({_on})": _agg([r[_on] for r in rows])}

        return self._reduce(red)

    def sum(self, on: str) -> Dataset:
        return self._col_agg("sum", on, sum)

    def min(self, on: str) -> Dataset:
        return self._col_agg("min", on, min)

    def max(self, on: str) -> Dataset:
        return self._col_agg("max", on, max)

    def mean(self, on: str) -> Dataset:
        return self._col_agg("mean", on, lambda vs: sum(vs) / len(vs))

    def map_groups(self, fn: Callable[[List], Any]) -> Dataset:
        """fn(group_rows) -> one output item per group."""
        return self._reduce(lambda k, rows, _f=fn: _f(rows))


# ---------------- sources (parity: read_api.py) ----------------

def from_items(items: List[Any], parallelism: int = 8) -> Dataset:
    import builtins

    items = list(items)
    nblocks = max(1, min(parallelism, len(items) or 1))
    size = -(-len(items) // nblocks) if items else 1
    refs = [
        ray_tpu_torch.put(items[i: i + size])
        for i in builtins.range(0, len(items), size)
    ]
    return Dataset(refs or [ray_tpu_torch.put([])])


def range(n: int, parallelism: int = 8) -> Dataset:  # noqa: A001 — parity
    """Columnar tensor blocks of int64 (reference ``ray.data.range``)."""
    import builtins

    import numpy as np

    per = -(-n // max(1, parallelism))
    descriptors = [
        (start, min(start + per, n))
        for start in builtins.range(0, n, per)
    ] if n else [(0, 0)]
    refs = [ray_tpu_torch.put([d]) for d in descriptors]

    def expand(block):
        (start, end), = block
        return {VALUE_COL: np.arange(start, end, dtype=np.int64)}

    return Dataset(refs, [Stage("range", expand)])


def _path_blocks(paths, parallelism: int) -> List:
    """Group files into ~parallelism path-list blocks (file granularity —
    single files are not byte-range split)."""
    import builtins

    if isinstance(paths, str):
        paths = [paths]
    nblocks = max(1, min(parallelism, len(paths) or 1))
    per = -(-len(paths) // nblocks)
    return [
        ray_tpu_torch.put(paths[i: i + per])
        for i in builtins.range(0, len(paths), per)
    ] or [ray_tpu_torch.put([])]


# read_text / read_binary_files live in data/io.py: the
# reference row shapes ({"text": line} / {"bytes", "path"}) plus
# directory expansion live there with the other file readers.
