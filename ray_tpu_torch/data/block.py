"""Block formats + accessors for ray_tpu_torch.data.

Parity: reference ``python/ray/data/block.py`` (``BlockAccessor``) and
``_internal/arrow_block.py`` / ``numpy`` support — the reference's data
plane is columnar (Arrow/pandas) so batch assembly is array slicing, not
per-row Python. Here a block is one of:

- ``list``           — rows of arbitrary Python objects (the generic form)
- ``dict[str, np.ndarray]`` — a COLUMNAR block: equal-length column arrays.
  Stored once in shm via pickle5 out-of-band buffers (serialization.py), so
  a consumer's column arrays are zero-copy views over the object store, and
  batch slicing is ``arr[a:b]`` views — no per-row work on the ingest path.

A columnar block whose only column is ``VALUE_COL`` is a "tensor block":
rows are the bare ``arr[i]`` values (what ``from_numpy`` produces), not
single-key dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

VALUE_COL = "__value__"

Block = Any  # list | dict[str, np.ndarray]


def is_columnar(block: Block) -> bool:
    return isinstance(block, dict)


class BlockAccessor:
    """Uniform view over either block kind. ``for_block`` dispatches."""

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if isinstance(block, dict):
            return ColumnarBlockAccessor(block)
        if isinstance(block, list):
            return ListBlockAccessor(block)
        raise TypeError(f"not a block: {type(block).__name__}")

    @staticmethod
    def batch_to_block(batch) -> Block:
        """Normalize a UDF return value to a block: dict-of-arrays stays
        columnar (lists are coerced to arrays); any other sequence becomes
        a row-list block."""
        if isinstance(batch, dict):
            out = {}
            n = None
            for k, v in batch.items():
                arr = v if isinstance(v, np.ndarray) else np.asarray(v)
                if n is None:
                    n = len(arr)
                elif len(arr) != n:
                    raise ValueError(
                        f"ragged columnar batch: column {k!r} has "
                        f"{len(arr)} rows, expected {n}"
                    )
                out[k] = arr
            return out
        if isinstance(batch, np.ndarray):
            return {VALUE_COL: batch}
        return list(batch)

    @staticmethod
    def concat(blocks: Sequence[Block]) -> Block:
        """Merge same-shaped blocks; mixed kinds degrade to a row list.
        Block KIND survives emptiness: all-empty columnar inputs produce an
        empty columnar block with its columns/dtypes intact, so a
        downstream numpy-format UDF still sees the schema, not ``{}``."""
        blocks = list(blocks)
        nonempty = [
            b for b in blocks if BlockAccessor.for_block(b).num_rows()
        ]
        pool = nonempty or [b for b in blocks if is_columnar(b) and b]
        if not pool:
            return []
        if all(is_columnar(b) for b in pool) and all(
            set(b) == set(pool[0]) for b in pool
        ):
            return {
                k: np.concatenate([b[k] for b in pool])
                for k in pool[0]
            }
        out: List = []
        for b in nonempty:
            out.extend(BlockAccessor.for_block(b).to_rows())
        return out

    # -- interface --

    def num_rows(self) -> int:
        raise NotImplementedError

    def to_rows(self) -> List:
        raise NotImplementedError

    def iter_rows(self) -> Iterator:
        return iter(self.to_rows())

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def take(self, indices) -> Block:
        raise NotImplementedError

    def to_numpy_batch(self) -> Any:
        """Columnar form: dict of stacked arrays (or the bare array for
        tensor blocks / non-dict rows)."""
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def key_values(self, key) -> Sequence:
        """Vectorized key extraction where possible: a str key on a
        columnar block is just the column array."""
        raise NotImplementedError


class ListBlockAccessor(BlockAccessor):
    def __init__(self, block: List):
        self._b = block

    def num_rows(self) -> int:
        return len(self._b)

    def to_rows(self) -> List:
        return self._b

    def slice(self, start, end) -> Block:
        return self._b[start:end]

    def take(self, indices) -> Block:
        return [self._b[i] for i in indices]

    def to_numpy_batch(self):
        rows = self._b
        if not rows:
            return {}
        if not isinstance(rows[0], dict):
            return np.stack([np.asarray(r) for r in rows])
        keys = set(rows[0])
        for r in rows:
            if set(r) != keys:
                raise ValueError(
                    "inconsistent batch schema for numpy format: row keys "
                    f"{sorted(set(r))} vs {sorted(keys)}"
                )
        return {k: np.stack([np.asarray(r[k]) for r in rows])
                for k in rows[0]}

    def size_bytes(self) -> int:
        # rough: rows are arbitrary Python; estimate from a sample
        import sys

        if not self._b:
            return 0
        n = min(len(self._b), 8)
        per = sum(sys.getsizeof(r) for r in self._b[:n]) / n
        return int(per * len(self._b))

    def key_values(self, key) -> Sequence:
        if key is None:
            return self._b
        if isinstance(key, str):
            return [r[key] for r in self._b]
        return [key(r) for r in self._b]


class ColumnarBlockAccessor(BlockAccessor):
    def __init__(self, block: Dict[str, np.ndarray]):
        self._b = block

    @property
    def _is_tensor(self) -> bool:
        return set(self._b) == {VALUE_COL}

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def to_rows(self) -> List:
        if self._is_tensor:
            return list(self._b[VALUE_COL])
        n = self.num_rows()
        cols = list(self._b.items())
        return [{k: v[i] for k, v in cols} for i in range(n)]

    def slice(self, start, end) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}  # views

    def take(self, indices) -> Block:
        idx = np.asarray(indices, dtype=np.intp)
        return {k: v[idx] for k, v in self._b.items()}

    def to_numpy_batch(self):
        if self._is_tensor:
            return self._b[VALUE_COL]
        return self._b

    def size_bytes(self) -> int:
        return sum(v.nbytes for v in self._b.values())

    def key_values(self, key) -> Sequence:
        if isinstance(key, str):
            return self._b[key]  # the column array itself — zero copy
        if key is None and self._is_tensor:
            return self._b[VALUE_COL]
        rows = self.to_rows()
        if key is None:
            return rows
        return [key(r) for r in rows]


def rows_to_columnar(rows: List[dict]) -> Optional[Block]:
    """Try to build a columnar block from dict rows with uniform keys and
    stackable values; None if the rows don't fit the columnar shape."""
    if not rows or not isinstance(rows[0], dict):
        return None
    keys = list(rows[0])
    keyset = set(keys)
    for r in rows:
        if set(r) != keyset:
            return None
    try:
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    except Exception:
        return None
