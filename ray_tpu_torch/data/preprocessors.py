"""Preprocessors: fit statistics on a Dataset, transform datasets/batches.

Parity: reference ``python/ray/data/preprocessors/`` (Preprocessor base in
``preprocessor.py``; scalers ``scaler.py``; encoders ``encoder.py``;
``Concatenator``; ``Chain``). Fit aggregations run distributed through the
Dataset's own groupby/aggregate machinery; transform is a ``map_batches``
stage, so a fitted preprocessor composes into streaming pipelines and can
be shipped to Train workers (it pickles cleanly — state is plain dicts).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Preprocessor:
    """fit(ds) computes state; transform(ds) appends a map_batches stage;
    transform_batch(rows) applies to an in-memory batch (serving path)."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        self._check_fitted()
        # block fns are row-oriented: request the rows view so they work on
        # columnar blocks too
        return ds.map_batches(self._make_block_fn(), batch_format="rows",
                              name=type(self).__name__)

    def transform_batch(self, rows: List[Dict[str, Any]]) -> List[Dict]:
        self._check_fitted()
        return self._make_block_fn()(list(rows))

    def _check_fitted(self):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(
                f"{type(self).__name__} must be fit() before transform()"
            )

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds):  # stateless preprocessors override _needs_fit
        pass

    def _make_block_fn(self):
        raise NotImplementedError


def _column_stats(ds, cols: List[str]) -> Dict[str, Dict[str, float]]:
    """One pass: per-column count/sum/sumsq/min/max via map_batches +
    driver-side merge (cheap — one small dict per block)."""

    def stats(block, _cols=tuple(cols)):
        out = {}
        for c in _cols:
            vals = [r[c] for r in block]
            out[c] = {
                "n": len(vals),
                "sum": float(sum(vals)),
                "sumsq": float(sum(v * v for v in vals)),
                "min": float(min(vals)) if vals else float("inf"),
                "max": float(max(vals)) if vals else float("-inf"),
            }
        return [out]

    merged: Dict[str, Dict[str, float]] = {
        c: {"n": 0, "sum": 0.0, "sumsq": 0.0,
            "min": float("inf"), "max": float("-inf")}
        for c in cols
    }
    for block in ds.map_batches(stats, batch_format="rows",
                                name="fit_stats").iter_blocks():
        for part in block:
            for c, s in part.items():
                m = merged[c]
                m["n"] += s["n"]
                m["sum"] += s["sum"]
                m["sumsq"] += s["sumsq"]
                m["min"] = min(m["min"], s["min"])
                m["max"] = max(m["max"], s["max"])
    return merged


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (population std, reference parity)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Dict[str, float]] = {}

    def _fit(self, ds):
        raw = _column_stats(ds, self.columns)
        self.stats_ = {}
        for c, s in raw.items():
            mean = s["sum"] / s["n"] if s["n"] else 0.0
            var = max(0.0, s["sumsq"] / s["n"] - mean * mean) if s["n"] else 0.0
            self.stats_[c] = {"mean": mean, "std": var ** 0.5}

    def _make_block_fn(self):
        stats = self.stats_

        def fn(block, _s=stats):
            out = []
            for r in block:
                r = dict(r)
                for c, st in _s.items():
                    denom = st["std"] or 1.0
                    r[c] = (r[c] - st["mean"]) / denom
                out.append(r)
            return out

        return fn


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Dict[str, float]] = {}

    def _fit(self, ds):
        raw = _column_stats(ds, self.columns)
        self.stats_ = {
            c: {"min": s["min"], "max": s["max"]} for c, s in raw.items()
        }

    def _make_block_fn(self):
        stats = self.stats_

        def fn(block, _s=stats):
            out = []
            for r in block:
                r = dict(r)
                for c, st in _s.items():
                    span = st["max"] - st["min"]
                    r[c] = (r[c] - st["min"]) / span if span else 0.0
                out.append(r)
            return out

        return fn


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes (sorted-order assignment)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.mapping_: Dict[Any, int] = {}

    def _fit(self, ds):
        col = self.label_column

        def uniques(block, _c=col):
            return [sorted({r[_c] for r in block})]

        seen = set()
        for block in ds.map_batches(uniques, batch_format="rows",
                                    name="fit_labels").iter_blocks():
            for part in block:
                seen.update(part)
        self.mapping_ = {v: i for i, v in enumerate(sorted(seen))}

    def _make_block_fn(self):
        col, mapping = self.label_column, self.mapping_

        def fn(block, _c=col, _m=mapping):
            out = []
            for r in block:
                r = dict(r)
                r[_c] = _m[r[_c]]
                out.append(r)
            return out

        return fn


class OneHotEncoder(Preprocessor):
    """Categorical columns -> {col}_{value} 0/1 indicator columns."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.categories_: Dict[str, List[Any]] = {}

    def _fit(self, ds):
        cols = tuple(self.columns)

        def uniques(block, _cols=cols):
            return [{c: sorted({r[c] for r in block}) for c in _cols}]

        seen: Dict[str, set] = {c: set() for c in cols}
        for block in ds.map_batches(uniques, batch_format="rows",
                                    name="fit_onehot").iter_blocks():
            for part in block:
                for c, vals in part.items():
                    seen[c].update(vals)
        self.categories_ = {c: sorted(v) for c, v in seen.items()}

    def _make_block_fn(self):
        cats = self.categories_

        def fn(block, _cats=cats):
            out = []
            for r in block:
                r = dict(r)
                for c, values in _cats.items():
                    v = r.pop(c)
                    for val in values:
                        r[f"{c}_{val}"] = 1 if v == val else 0
                out.append(r)
            return out

        return fn


class Concatenator(Preprocessor):
    """Pack feature columns into one numpy vector column (the device-feed
    shape: rows become {'features': ndarray, <excluded cols>...})."""

    def __init__(self, columns: Optional[List[str]] = None,
                 output_column_name: str = "features",
                 exclude: Optional[List[str]] = None,
                 dtype: str = "float32"):
        self.columns = list(columns) if columns else None
        self.output_column_name = output_column_name
        self.exclude = set(exclude or [])
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _make_block_fn(self):
        cols, out_name = self.columns, self.output_column_name
        excl, dtype = self.exclude, self.dtype

        def fn(block, _c=cols, _o=out_name, _e=excl, _d=dtype):
            import numpy as np

            out = []
            # Inferred column order must be deterministic: a row's own dict
            # insertion order would silently misalign feature vectors, so the
            # inferred list is the sorted key union — content-based, hence
            # identical across blocks that carry the same columns (a column
            # entirely absent from one block still changes that block's
            # width; pass ``columns=`` explicitly for ragged datasets).
            # Rows missing a column get NaN, like the reference's
            # pandas-based Concatenator.
            take_all = _c
            if take_all is None:
                keys = set()
                for r in block:
                    keys.update(r)
                take_all = sorted(k for k in keys if k not in _e and k != _o)
            fill = float("nan")
            for r in block:
                packed = np.asarray(
                    [r.get(k, fill) for k in take_all], dtype=_d
                )
                rest = {k: v for k, v in r.items() if k not in take_all}
                rest[_o] = packed
                out.append(rest)
            return out

        return fn


class Chain(Preprocessor):
    """Sequential composition; fit() fits each stage on the progressively
    transformed dataset (reference chain.py semantics)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds) -> "Chain":
        for p in self.preprocessors:
            if p._needs_fit():
                p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        self._check_fitted()
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, rows):
        self._check_fitted()
        for p in self.preprocessors:
            rows = p.transform_batch(rows)
        return rows

    def _needs_fit(self) -> bool:
        return any(p._needs_fit() for p in self.preprocessors)
