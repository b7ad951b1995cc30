"""WebDataset-format reader: tar shards of key-grouped samples.

Parity: reference ``read_webdataset`` (``python/ray/data/read_api.py`` /
``datasource/webdataset_datasource.py``): each tar member name is
``<sample key>.<extension>``; consecutive members sharing a key form one
sample row ``{"__key__": key, "<ext>": bytes, ...}``. Standard decoders
are applied opt-in (the reference's ``decode`` semantics): text
extensions decode to str, json to objects, image extensions to HxWxC
arrays via PIL; everything else stays bytes.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Any, Dict, List, Optional

_TEXT_EXTS = {"txt", "text", "cls", "cls2", "index"}
_JSON_EXTS = {"json", "jsn"}
_IMAGE_EXTS = {"jpg", "jpeg", "png", "ppm", "pgm", "pbm", "bmp", "gif",
               "webp"}


def _split_key(name: str):
    base = os.path.basename(name)
    stem, _, ext = base.partition(".")
    return stem, ext.lower()


def _decode_member(ext: str, data: bytes) -> Any:
    if ext in _TEXT_EXTS:
        return data.decode("utf-8", errors="replace")
    if ext in _JSON_EXTS:
        return json.loads(data)
    if ext.split(".")[-1] in _IMAGE_EXTS:
        import numpy as np
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)))
    return data


def _iter_samples(path: str, decode: bool):
    with tarfile.open(path) as tar:
        current_key: Optional[str] = None
        sample: Dict[str, Any] = {}
        for member in tar:
            if not member.isfile():
                continue
            key, ext = _split_key(member.name)
            if current_key is not None and key != current_key:
                yield sample
                sample = {}
            current_key = key
            data = tar.extractfile(member).read()
            sample["__key__"] = key
            sample[ext] = _decode_member(ext, data) if decode else data
        if sample:
            yield sample


def read_webdataset(paths, parallelism: int = 8, *, decode: bool = True):
    """Tar shard(s) -> Dataset of sample rows (one row per key group)."""
    from ray_tpu_torch.data.io import _reader_dataset

    def load(block, _decode=decode):
        out: List[Dict[str, Any]] = []
        for path in block:
            out.extend(_iter_samples(path, _decode))
        return out

    return _reader_dataset(paths, parallelism, "read_webdataset", load)


def write_webdataset(ds, path: str) -> List[str]:
    """Rows with ``__key__`` + per-extension fields -> tar shards (one
    per block). str values write utf-8, dict/list write JSON, bytes
    write raw."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import BlockAccessor

    def write_block(block, shard_path: str) -> int:
        rows = BlockAccessor.for_block(block).to_rows()
        if not rows:
            return 0
        with tarfile.open(shard_path, "w") as tar:
            for i, row in enumerate(rows):
                key = str(row.get("__key__", f"{i:06d}"))
                for ext, value in row.items():
                    if ext == "__key__":
                        continue
                    if isinstance(value, (dict, list)):
                        data = json.dumps(value).encode()
                    elif isinstance(value, str):
                        data = value.encode()
                    else:
                        data = bytes(value)
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
        return len(rows)

    os.makedirs(path, exist_ok=True)
    task = ray_tpu_torch.remote(num_cpus=1)(write_block)
    pending, files = [], []
    for i, ref in enumerate(ds._executor().iter_output_refs()):
        fname = os.path.join(path, f"{i:06d}.tar")
        pending.append(task.remote(ref, fname))
        files.append(fname)
    counts = ray_tpu_torch.get(pending)
    return [f for f, n in zip(files, counts) if n > 0]
