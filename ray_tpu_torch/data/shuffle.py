"""All-to-all Data operations: exact shuffle, sort, repartition, groupby.

Parity: reference ``python/ray/data/_internal/planner/exchange/`` and
``push_based_shuffle.py`` / ``sort.py`` — the two-phase map-partition /
reduce-merge exchange. Rather than driver-side ``_materialized_refs``
barriers, these build :class:`~ray_tpu_torch.data.streaming.ExchangeStage`
operators that run INSIDE the streaming executor: prepare/partition tasks
chase the upstream pipeline block-by-block, merges launch in output order
under the downstream buffer cap, and partition refs are dropped as their
merge completes — so a dataset larger than the object store shuffles by
spilling partition outputs, never by pinning everything at once.

Blocks are row lists or columnar dicts (block.py); the columnar paths are
vectorized (``np.searchsorted`` range partition, ``argsort`` merges,
permutation shuffles) — no per-row Python on array data.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.streaming import ExchangeStage


def make_keyfn(key) -> Callable[[Any], Any]:
    """None -> identity; str -> row[key]; callable -> itself."""
    if key is None:
        return lambda r: r
    if isinstance(key, str):
        return lambda r: r[key]
    if callable(key):
        return key
    raise TypeError(f"sort/groupby key must be None, str or callable: {key!r}")


def _take_parts(acc: BlockAccessor, assignment: np.ndarray,
                nparts: int) -> List:
    return [acc.take(np.nonzero(assignment == p)[0]) for p in range(nparts)]


# ---------------- random shuffle ----------------


_shuffle_seq = 0


def _draw_shuffle_seed() -> int:
    """Unseeded-shuffle base seed: drawn from the chaos-seeded RNG (plus
    a process-local sequence) so a replayed workload shuffles — and
    therefore partitions, pulls and spills — identically under the same
    fault schedule (raylint R4's ``data/`` prong enforces this). Without
    a chaos plane it is OS-seeded, i.e. a plain random shuffle."""
    from ray_tpu_torch._private import chaos

    global _shuffle_seq
    _shuffle_seq += 1
    return chaos.replay_rng(
        f"data:shuffle:{_shuffle_seq}"
    ).randrange(1 << 30)


def shuffle_stage(nparts: int, seed: Optional[int]) -> ExchangeStage:
    base = seed if seed is not None else _draw_shuffle_seed()

    def make_partition(_metas):
        def partition(block, idx, _n=nparts, _s=base):
            acc = BlockAccessor.for_block(block)
            rng = np.random.default_rng(_s * 1000003 + idx)
            assignment = rng.integers(0, _n, size=acc.num_rows())
            return _take_parts(acc, assignment, _n)

        return partition

    def merge(p, *parts, _s=base):
        block = BlockAccessor.concat(parts)
        acc = BlockAccessor.for_block(block)
        perm = np.random.default_rng(_s * 7 + p).permutation(acc.num_rows())
        return acc.take(perm)

    return ExchangeStage("random_shuffle", nparts, make_partition, merge)


# ---------------- sort ----------------


def _sample_keys_body(key, k: int = 32):
    def sample(block, _key=key, _k=k):
        acc = BlockAccessor.for_block(block)
        vals = acc.key_values(_key)
        n = len(vals)
        if n <= _k:
            return list(vals)
        idx = np.random.default_rng(1299721 + n).integers(0, n, size=_k)
        return [vals[int(i)] for i in idx]

    return sample


def sort_stage(nparts: int, key, descending: bool) -> ExchangeStage:
    def make_partition(metas: Dict[int, List]):
        keys = sorted(k for s in metas.values() for k in s)
        if keys:
            boundaries = [
                keys[min(len(keys) - 1, (len(keys) * (i + 1)) // nparts)]
                for i in range(nparts - 1)
            ]
        else:
            boundaries = []

        def partition(block, _idx, _b=boundaries, _key=key, _n=nparts,
                      _desc=descending):
            acc = BlockAccessor.for_block(block)
            vals = acc.key_values(_key)
            if not _b:
                a = np.zeros(len(vals), dtype=np.intp)
            elif isinstance(vals, np.ndarray):
                a = np.searchsorted(np.asarray(_b), vals, side="right")
            else:
                import bisect

                a = np.asarray(
                    [bisect.bisect_right(_b, v) for v in vals],
                    dtype=np.intp,
                ) if len(vals) else np.zeros(0, dtype=np.intp)
            if _desc:  # part 0 holds the LARGEST keys
                a = (_n - 1) - a
            return _take_parts(acc, a, _n)

        return partition

    def merge(p, *parts, _key=key, _desc=descending):
        block = BlockAccessor.concat(parts)
        acc = BlockAccessor.for_block(block)
        vals = acc.key_values(_key)
        if isinstance(vals, np.ndarray):
            order = np.argsort(vals, kind="stable")
            if _desc:
                order = order[::-1]
            return acc.take(order)
        rows = acc.to_rows()
        rows.sort(key=make_keyfn(_key), reverse=_desc)
        return rows

    return ExchangeStage("sort", nparts, make_partition, merge,
                         prepare_fn=_sample_keys_body(key))


# ---------------- groupby ----------------


def _stable_hash(v) -> int:
    """Deterministic across processes (str/bytes hash() is randomized by
    PYTHONHASHSEED; map tasks run in different workers, so the partition of
    a key must not depend on process identity)."""
    import zlib

    if isinstance(v, str):
        return zlib.crc32(v.encode("utf-8", "surrogatepass"))
    if isinstance(v, (bytes, bytearray)):
        return zlib.crc32(bytes(v))
    if isinstance(v, tuple):
        h = 1469598103
        for item in v:
            h = (h * 1099511628211 ^ _stable_hash(item)) & ((1 << 64) - 1)
        return h
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, (int, float, bool)) or v is None:
        return hash(v)  # numeric hash is not randomized
    return zlib.crc32(repr(v).encode())


def groupby_stage(nparts: int, key,
                  reducefn: Callable[[Any, List], Any]) -> ExchangeStage:
    def make_partition(_metas):
        def partition(block, _idx, _key=key, _n=nparts):
            acc = BlockAccessor.for_block(block)
            vals = acc.key_values(_key)
            a = np.asarray(
                [(h ^ (h >> 16)) % _n
                 for h in (_stable_hash(v) for v in vals)],
                dtype=np.intp,
            ) if len(vals) else np.zeros(0, dtype=np.intp)
            return _take_parts(acc, a, _n)

        return partition

    def merge(_p, *parts, _key=key, _red=reducefn):
        """Group rows by key within this partition (hash partitioning
        guarantees a key lives in exactly one partition), reduce each."""
        keyfn = make_keyfn(_key)
        groups: dict = {}
        for part in parts:
            for row in BlockAccessor.for_block(part).iter_rows():
                k = keyfn(row)
                if isinstance(k, np.generic):
                    k = k.item()
                groups.setdefault(k, []).append(row)
        try:
            items = sorted(groups.items())
        except TypeError:  # unorderable key mix — keep insertion order
            items = list(groups.items())
        return [_red(k, rows) for k, rows in items]

    return ExchangeStage("groupby", nparts, make_partition, merge)


# ---------------- repartition ----------------


def _count_rows(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


def repartition_stage(nparts: int) -> ExchangeStage:
    def make_partition(metas: Dict[int, int]):
        idxs = sorted(metas)
        offsets = {}
        pos = 0
        for i in idxs:
            offsets[i] = pos
            pos += metas[i]
        total = pos
        per = -(-total // nparts) if total else 0

        def partition(block, idx, _off=offsets, _per=per, _total=total,
                      _n=nparts):
            acc = BlockAccessor.for_block(block)
            b0 = _off[idx]
            b1 = b0 + acc.num_rows()
            parts = []
            for p in range(_n):
                lo = p * _per
                hi = min((p + 1) * _per, _total)
                s, e = max(lo, b0), min(hi, b1)
                parts.append(
                    acc.slice(s - b0, e - b0) if s < e else acc.slice(0, 0)
                )
            return parts

        return partition

    def merge(_p, *parts):
        return BlockAccessor.concat(parts)

    return ExchangeStage("repartition", nparts, make_partition, merge,
                         prepare_fn=_count_rows)


# ---------------- materializing helpers (split()) ----------------


def repartition_blocks(refs: List, nparts: int) -> List:
    """Materialized exact rebalance into ``nparts`` near-equal row-count
    blocks (used by Dataset.split, which needs concrete per-split refs)."""
    import ray_tpu_torch

    if not refs:
        return refs
    count = ray_tpu_torch.remote(num_cpus=1)(_count_rows)
    lengths = ray_tpu_torch.get([count.remote(r) for r in refs])
    total = sum(lengths)
    per = -(-total // nparts) if total else 0
    offsets = [0]
    for ln in lengths:
        offsets.append(offsets[-1] + ln)

    def slice_concat(ranges, *blocks):
        picked = [
            BlockAccessor.for_block(b).slice(s, e)
            for (s, e), b in zip(ranges, blocks)
        ]
        return BlockAccessor.concat(picked)

    slicer = ray_tpu_torch.remote(num_cpus=1)(slice_concat)
    out = []
    for p in range(nparts):
        lo, hi = p * per, min((p + 1) * per, total)
        if lo >= hi and total:
            out.append(ray_tpu_torch.put([]))
            continue
        ranges, picked = [], []
        for i, r in enumerate(refs):
            b0, b1 = offsets[i], offsets[i + 1]
            s, e = max(lo, b0), min(hi, b1)
            if s < e:
                ranges.append((s - b0, e - b0))
                picked.append(r)
        out.append(slicer.remote(ranges, *picked))
    return out
