"""Structured IO for ray_tpu_torch.data: csv / json(l) / parquet / numpy / pandas.

Parity: reference ``python/ray/data/read_api.py`` (read_parquet:542,
read_json:921, read_csv:1041, from_pandas/from_numpy/from_arrow:~1900) and
the ``Dataset.write_*`` sinks. Rows are plain dicts (one per record); the
columnar formats are converted at the block boundary — pyarrow for
parquet, stdlib csv/json otherwise. File reads happen inside tasks, never
on the driver; writes run one task per block and write one file per block
(the reference's layout).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import ray_tpu_torch


# ---------------- readers (task bodies) ----------------


def _load_csv(paths: List[str]) -> List[Dict[str, Any]]:
    import csv

    out: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                out.append(_coerce_numbers(row))
    return out


def _coerce_numbers(row: Dict[str, str]) -> Dict[str, Any]:
    """csv gives strings; restore int/float where round-trippable (the
    reference gets types from Arrow's csv inference — same outcome)."""
    conv: Dict[str, Any] = {}
    for k, v in row.items():
        if not isinstance(v, str):
            conv[k] = v
            continue
        try:
            conv[k] = int(v)
        except ValueError:
            try:
                conv[k] = float(v)
            except ValueError:
                conv[k] = v
    return conv


def _load_json(paths: List[str]) -> List[Any]:
    import json

    out: List[Any] = []
    for path in paths:
        with open(path) as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":  # a single JSON array
                out.extend(json.load(f))
            else:  # JSONL
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
    return out


def _load_parquet(paths: List[str], columns: Optional[List[str]]):
    """Columnar blocks straight from Arrow (zero per-row Python): each
    column becomes a numpy array (strings degrade to object arrays)."""
    import pyarrow.parquet as pq

    tables = [pq.read_table(path, columns=columns) for path in paths]
    if not tables:
        return []
    import pyarrow as pa

    table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    return _table_to_block(table)


# ---------------- read API ----------------


def _reader_dataset(paths, parallelism: int, name: str, load) :
    from ray_tpu_torch.data.dataset import Dataset, _path_blocks
    from ray_tpu_torch.data.streaming import Stage

    return Dataset(_path_blocks(_expand_dirs(paths), parallelism),
                   [Stage(name, load)])


def _expand_dirs(paths) -> List[str]:
    """A directory path expands to its (sorted) regular files."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if not f.startswith(".")
                and os.path.isfile(os.path.join(p, f))
            )
        else:
            out.append(p)
    return out


def read_csv(paths, parallelism: int = 8):
    return _reader_dataset(paths, parallelism, "read_csv", _load_csv)


def read_json(paths, parallelism: int = 8):
    """JSONL or JSON-array files -> rows."""
    return _reader_dataset(paths, parallelism, "read_json", _load_json)


def _load_text(paths: List[str]) -> List[Dict[str, str]]:
    out: List[Dict[str, str]] = []
    for path in paths:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                out.append({"text": line.rstrip("\n")})
    return out


def read_text(paths, parallelism: int = 8):
    """One row per line: {"text": line} (reference read_text,
    read_api.py:1514 — lines keyed under a single text column)."""
    return _reader_dataset(paths, parallelism, "read_text", _load_text)


def _load_binary(paths: List[str]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, "rb") as f:
            out.append({"bytes": f.read(), "path": path})
    return out


def read_binary_files(paths, parallelism: int = 8):
    """One row per file: {"bytes": ..., "path": ...} (reference
    read_binary_files, read_api.py:1676 — include_paths variant's
    shape, since the path costs nothing and the reference's flag only
    strips it)."""
    return _reader_dataset(
        paths, parallelism, "read_binary_files", _load_binary
    )


def read_parquet(paths, parallelism: int = 8,
                 columns: Optional[List[str]] = None):
    def load(block, _cols=columns):
        return _load_parquet(block, _cols)

    return _reader_dataset(paths, parallelism, "read_parquet", load)


def read_numpy(paths, parallelism: int = 8):
    """Each .npy file's rows (axis 0) become items (one columnar tensor
    block per task — zero-copy through the object store)."""
    def load(block):
        import numpy as np

        from ray_tpu_torch.data.block import VALUE_COL

        arrs = [np.load(path) for path in block]
        if not arrs:
            return []
        return {VALUE_COL: np.concatenate(arrs) if len(arrs) > 1
                else arrs[0]}

    return _reader_dataset(paths, parallelism, "read_numpy", load)


# ---------------- in-memory interop ----------------


def _df_to_block(df):
    return {str(c): df[c].to_numpy() for c in df.columns}


def from_pandas(dfs, parallelism: int = 8):
    """DataFrame(s) -> Dataset of columnar blocks (one per input frame;
    a single frame is row-split into ~parallelism blocks)."""
    from ray_tpu_torch.data.dataset import Dataset

    if not isinstance(dfs, (list, tuple)):
        n = len(dfs)
        nblocks = max(1, min(parallelism, n or 1))
        per = -(-n // nblocks) if n else 1
        dfs = [dfs.iloc[i: i + per] for i in range(0, n, per)] or [dfs]
    refs = [ray_tpu_torch.put(_df_to_block(df)) for df in dfs]
    return Dataset(refs or [ray_tpu_torch.put([])])


def from_numpy(arrays, parallelism: int = 8):
    """ndarray(s) -> Dataset of rows along axis 0, stored as columnar
    tensor blocks (zero-copy through the object store)."""
    from ray_tpu_torch.data.block import VALUE_COL
    from ray_tpu_torch.data.dataset import Dataset

    if not isinstance(arrays, (list, tuple)):
        n = len(arrays)
        nblocks = max(1, min(parallelism, n or 1))
        per = -(-n // nblocks) if n else 1
        arrays = [arrays[i: i + per] for i in range(0, n, per)] or [arrays]
    refs = [ray_tpu_torch.put({VALUE_COL: a}) for a in arrays]
    return Dataset(refs or [ray_tpu_torch.put([])])


def _column_to_numpy(col):
    """Arrow column -> numpy WITHOUT the blanket copy: a single-chunk
    primitive column with no nulls is already a contiguous aligned
    buffer, so ``zero_copy_only=True`` hands back a view over Arrow's
    memory (multi-chunk columns pay one unavoidable concat via
    ``combine_chunks`` first). Strings/nulls/nested types fall back to
    the copying path — Arrow raises rather than silently copying.

    CONTRACT: zero-copy blocks are READ-ONLY views (writeable=False,
    backed by immutable Arrow memory) — reference ray.data batch
    semantics. A transform mutating columns in place must copy first
    (``np.array(batch["x"])``)."""
    import numpy as np

    try:
        chunk = None
        if col.num_chunks == 1:
            chunk = col.chunk(0)
        elif col.num_chunks > 1:
            # one contiguous buffer (a single memcpy); newer pyarrow
            # returns a plain Array here, older a 1-chunk ChunkedArray
            chunk = col.combine_chunks()
            if hasattr(chunk, "num_chunks"):
                chunk = chunk.chunk(0) if chunk.num_chunks == 1 else None
        if chunk is not None:
            return chunk.to_numpy(zero_copy_only=True)
    except Exception:  # ArrowInvalid: needs a conversion copy
        pass
    return np.asarray(col.to_numpy(zero_copy_only=False))


def _table_to_block(table):
    return {
        name: _column_to_numpy(col)
        for name, col in zip(table.column_names, table.columns)
    }


def from_arrow(tables, parallelism: int = 8):
    """Arrow table(s) -> Dataset of columnar blocks."""
    from ray_tpu_torch.data.dataset import Dataset

    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    refs = [ray_tpu_torch.put(_table_to_block(t)) for t in tables]
    return Dataset(refs or [ray_tpu_torch.put([])])


# ---------------- writers (task bodies; one file per block) ----------------


def _write_block_csv(block, path: str) -> int:
    import csv

    from ray_tpu_torch.data.block import BlockAccessor

    block = BlockAccessor.for_block(block).to_rows()
    if not block:
        return 0
    # Fieldnames are the union of keys across the whole block (first-seen
    # order): rows with extra keys would otherwise raise in DictWriter and
    # rows with missing keys get blanks via restval.
    cols: List[str] = []
    seen = set()
    for row in block:
        for k in row:
            if k not in seen:
                seen.add(k)
                cols.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        w.writerows(block)
    return len(block)


def _json_default(o):
    import numpy as np

    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _write_block_json(block, path: str) -> int:
    import json

    from ray_tpu_torch.data.block import BlockAccessor

    block = BlockAccessor.for_block(block).to_rows()
    if not block:
        return 0
    with open(path, "w") as f:
        for row in block:
            f.write(json.dumps(row, default=_json_default) + "\n")
    return len(block)


def _write_block_parquet(block, path: str) -> int:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import BlockAccessor, is_columnar

    acc = BlockAccessor.for_block(block)
    if not acc.num_rows():
        return 0
    if is_columnar(block):  # column arrays go straight into Arrow
        table = pa.table({k: pa.array(v) for k, v in block.items()})
    else:
        table = pa.Table.from_pylist(block)
    pq.write_table(table, path)
    return acc.num_rows()


_WRITERS = {
    "csv": (_write_block_csv, "csv"),
    "json": (_write_block_json, "jsonl"),
    "parquet": (_write_block_parquet, "parquet"),
}


def write_dataset(ds, path: str, fmt: str) -> List[str]:
    """Execute ``ds`` and write one ``{i:06d}.{ext}`` file per block under
    ``path``. Returns the file list. Writes run as remote tasks (parallel,
    off-driver); empty blocks are skipped."""
    body, ext = _WRITERS[fmt]
    os.makedirs(path, exist_ok=True)
    task = ray_tpu_torch.remote(num_cpus=1)(body)
    pending, files = [], []
    for i, ref in enumerate(ds._executor().iter_output_refs()):
        fname = os.path.join(path, f"{i:06d}.{ext}")
        pending.append(task.remote(ref, fname))
        files.append(fname)
    counts = ray_tpu_torch.get(pending)  # propagate write errors
    # Empty blocks write nothing (writers return 0 without creating a file).
    return [f for f, n in zip(files, counts) if n > 0]


# ---------------- image / tfrecords / Hugging Face datasources ----------
# Parity: reference read_images (read_api.py:679), read_tfrecords (:1196)
# and from_huggingface (:2084). read_text/read_binary_files are in
# this module too.


def read_images(paths, parallelism: int = 8, *, size=None, mode=None,
                include_paths: bool = False):
    """Decode image files into rows {"image": HxWxC uint8 ndarray}
    (reference read_images: PIL decode, optional resize/convert)."""

    def load(block, _size=size, _mode=mode, _inc=include_paths):
        import numpy as np
        from PIL import Image

        out = []
        for path in block:
            img = Image.open(path)
            if _mode is not None:
                img = img.convert(_mode)
            if _size is not None:
                img = img.resize((_size[1], _size[0]))
            row = {"image": np.asarray(img)}
            if _inc:
                row["path"] = path
            out.append(row)
        return out

    return _reader_dataset(paths, parallelism, "read_images", load)


# -- TFRecord framing (no TensorFlow in this image): each record is
#    [u64 len][u32 masked-crc32c(len)][bytes][u32 masked-crc32c(bytes)].
#    CRCs are written spec-correct so real TF readers accept our files;
#    reads validate only the length CRC (cheap) unless verify=True.

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        import numpy as np

        poly = 0x82F63B78
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table[i] = c
        _CRC32C_TABLE = table
    import numpy as np

    crc = np.uint32(0xFFFFFFFF)
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(int(crc) ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _tfrecord_iter(path: str, verify: bool):
    import struct

    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            if len(hdr) < 8:
                raise ValueError(f"{path}: truncated tfrecord header")
            (length,) = struct.unpack("<Q", hdr)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(hdr) != len_crc:
                raise ValueError(f"{path}: tfrecord length crc mismatch")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated tfrecord payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(data) != data_crc:
                raise ValueError(f"{path}: tfrecord data crc mismatch")
            yield data


def read_tfrecords(paths, parallelism: int = 8, *, verify: bool = False):
    """Raw TFRecord payloads as rows {"bytes": record} (reference
    read_tfrecords; Example-proto decoding is the caller's schema
    decision — this image carries no TensorFlow/protobuf schema)."""

    def load(block, _verify=verify):
        out = []
        for path in block:
            for rec in _tfrecord_iter(path, _verify):
                out.append({"bytes": rec})
        return out

    return _reader_dataset(paths, parallelism, "read_tfrecords", load)


def _write_block_tfrecords(block, path: str) -> int:
    import struct

    from ray_tpu_torch.data.block import BlockAccessor

    rows = BlockAccessor.for_block(block).to_rows()
    if not rows:
        return 0
    with open(path, "wb") as f:
        for row in rows:
            data = row["bytes"] if isinstance(row, dict) else row
            if not isinstance(data, (bytes, bytearray)):
                raise TypeError(
                    "write_tfrecords needs rows with a 'bytes' field"
                )
            data = bytes(data)
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
    return len(rows)


def from_huggingface(dataset, parallelism: int = 8):
    """A (map-style) HuggingFace ``datasets.Dataset`` -> ray_tpu_torch Dataset
    (reference from_huggingface). Rows are pulled through the HF Arrow
    table in ~parallelism contiguous slices."""
    from ray_tpu_torch.data.dataset import Dataset

    n = len(dataset)
    nblocks = max(1, min(parallelism, n or 1))
    per = -(-n // nblocks) if n else 1
    refs = []
    for lo in range(0, n, per):
        refs.append(ray_tpu_torch.put(
            [dataset[i] for i in range(lo, min(lo + per, n))]
        ))
    return Dataset(refs or [ray_tpu_torch.put([])])


_WRITERS["tfrecords"] = (_write_block_tfrecords, "tfrecord")


def read_sql(sql: str, connection_factory, parallelism: int = 8):
    """DB-API query -> rows (reference read_sql, read_api.py:2022: a
    query string + a zero-arg connection factory, executed inside tasks).
    Parallelism comes from sharding the query by LIMIT/OFFSET windows —
    but ONLY when the query carries a top-level ORDER BY, since SQL row
    order is otherwise unspecified and parallel windows could duplicate
    or drop rows.  Unordered queries (and queries with their own
    LIMIT/OFFSET) run whole in a single task.

    Caveat: window sharding assumes the ORDER BY is a stable TOTAL order
    (unique key) over a snapshot-consistent table.  With duplicate sort
    keys, some engines break ties differently per execution, and writes
    between the COUNT probe and the shard queries shift windows — pass
    ``parallelism=1`` for strict correctness in those situations."""
    import ray_tpu_torch
    from ray_tpu_torch.data.dataset import Dataset
    from ray_tpu_torch.data.streaming import Stage

    def run_query(block):
        out = []
        for query in block:
            conn = connection_factory()
            try:
                cur = conn.cursor()
                cur.execute(query)
                cols = [d[0] for d in cur.description]
                out.extend(dict(zip(cols, row)) for row in cur.fetchall())
            finally:
                conn.close()
        return out

    lowered = sql.lower()
    # Shard only when ORDER BY is in the TOP-LEVEL tail (after the last
    # closing paren): an ORDER BY buried in a subquery doesn't order the
    # outer result, so windows over it would duplicate/drop rows.
    top_tail = lowered.rsplit(")", 1)[-1]
    if ("limit" in lowered or "offset" in lowered
            or "order by" not in top_tail):
        shards = [sql]
    else:
        # probe the row count once to build balanced windows (the count
        # subquery is aliased: PostgreSQL rejects an unaliased derived
        # table)
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT COUNT(*) FROM ({sql}) AS _rt_count")
            n = int(cur.fetchone()[0])
        finally:
            conn.close()
        nshards = max(1, min(parallelism, n or 1))
        per = -(-n // nshards) if n else 1
        shards = [
            f"{sql} LIMIT {per} OFFSET {off}"
            for off in range(0, max(n, 1), per)
        ]
    refs = [ray_tpu_torch.put([q]) for q in shards]
    return Dataset(refs, [Stage("read_sql", run_query)])
