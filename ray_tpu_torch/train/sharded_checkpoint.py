"""Sharded, async checkpoints of train states (PyTorch port of
``ray_tpu/train/sharded_checkpoint.py``), in the same on-disk format, so
that each package reads the other's checkpoints:

- every process writes only the pieces it holds. A DTensor leaf (a state
  over a mesh, ``parallel/mesh.py``) is written as the reference writes a
  sharded array: each process writes its local tensor with its global index
  box (``mesh.local_box``), and of the ranks that hold the same box (the
  replicas along the mesh axes on which the leaf is replicated) only the one
  at coordinate 0 of each such axis writes it, as only ``replica_id == 0``
  does in the reference. A leaf that is not a DTensor is whole on every
  process: process 0 writes it. Each piece is a step-scoped
  ``pieces_<step>/*.npy`` file, listed in a per-process
  ``index_<pid>.<step>.pkl``; a process that holds nothing to write writes
  its (empty) index and its marker;
- the snapshot is the consistency point. The port, unlike JAX, updates
  parameters in place, so ``save_sharded`` copies every CUDA tensor on the
  device, on the current (the step's) stream, before it returns: the next
  step, queued behind the copies, cannot change them. A background thread
  waits for the copies, moves them to the host in chunks through a pinned
  buffer and writes them; the train loop goes on meanwhile;
- process 0 waits for every process's ``shard_<pid>.<step>.ok`` marker,
  then writes ``aux.<step>.pkl``, ``manifest.json`` and the COMMIT marker; a
  checkpoint without a COMMIT that matches its manifest's step is torn and
  is refused;
- restore reassembles any requested box of a leaf from the stored pieces
  (slice intersection): a DTensor leaf of ``like`` is filled with its own
  rank's box, so a checkpoint restores onto any mesh shape and world size,
  and into one unsharded process.

Leaf keys are the strings ``jax.tree_util.keystr`` writes, by the port's own
copy of its rules: a dict key as ``['name']``, a list or tuple index as
``[i]``. A ``TrainState`` is flattened as
the reference's is: ``[<flat index 0>]`` (step), ``[<flat index 1>]...``
(params), and AdamW's step, ``exp_avg`` and ``exp_avg_sq`` per parameter as
optax's ``[<flat index 2>][1][0].count``, ``.mu[...]`` and ``.nu[...]``.

Process index and count come from ``torch.distributed`` when it is
initialized, else 0 and 1. ``upload_sharded_checkpoint`` and
``download_sharded_checkpoint`` copy a committed checkpoint directory to
and from external storage (``_private/external_storage.py``: a ``file://``
path or a bucket URI).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.mesh import local_box
from ray_tpu_torch.parallel.train_step import TrainState

MANIFEST_FILE = "manifest.json"

# Key prefixes of the reference's TrainState and of optax's AdamW moments
# in ``default_optimizer``'s chain (clip, then adamw: scale_by_adam first).
_STEP_KEY = "[<flat index 0>]"
_PARAMS_KEY = "[<flat index 1>]"
_ADAM_KEY = "[<flat index 2>][1][0]"


def _commit_file(path: str) -> str:
    return os.path.join(path, "COMMIT")


def _index_spec(index, shape) -> List[Tuple[int, int]]:
    """Normalize a box (tuple of slices, or [(start, stop), ...]) to
    [(start, stop), ...]."""
    out = []
    for sl, dim in zip(index, shape):
        if not isinstance(sl, slice):
            out.append((int(sl[0]), int(sl[1])))
            continue
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return out


def is_committed(path: str, step: Optional[int] = None) -> bool:
    try:
        with open(_commit_file(path)) as f:
            committed = int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return False
    return step is None or committed == step


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        return int(json.load(f)["step"])


def _process() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# -- leaf keys ---------------------------------------------------------------


def _keyed_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf of a tree of dicts, lists and tuples;
    None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _keyed_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _scalar_dtype() -> torch.dtype:
    """The dtype of torch's optimizer step counts."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _adam_state(opt: torch.optim.Optimizer, p: torch.Tensor,
                create: bool) -> Optional[Dict]:
    """AdamW's state of ``p``: None before its first step, unless
    ``create``, which makes it as the optimizer's first step would (a step
    count on the card when the group is capturable, zero moments)."""
    st = opt.state.get(p)
    if st or not create:
        return st or None
    group = next(g for g in opt.param_groups
                 if any(q is p for q in g["params"]))
    on_device = group.get("capturable") or group.get("fused")
    st = opt.state[p]
    st["step"] = torch.zeros((), dtype=_scalar_dtype(),
                             device=p.device if on_device else "cpu")
    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    st["exp_avg_sq"] = torch.zeros_like(p,
                                        memory_format=torch.preserve_format)
    return st


def _train_state_leaves(state: TrainState) -> List[Tuple[str, Any]]:
    """The reference's leaves of a port ``TrainState``: step, params, and
    AdamW's count and moments (zeros before the first step)."""
    params = _keyed_leaves(state.params)
    out = [(_STEP_KEY, state.step)]
    out += [(_PARAMS_KEY + k, p) for k, p in params]
    sts = [_adam_state(state.opt_state, p, create=False) for _, p in params]
    count = next((st["step"] for st in sts if st), None)
    out.append((_ADAM_KEY + ".count",
                np.zeros((), np.int32) if count is None
                else count.to(torch.int32)))
    for name, field in ((".mu", "exp_avg"), (".nu", "exp_avg_sq")):
        out += [(_ADAM_KEY + name + k,
                 st[field] if st else np.zeros(tuple(p.shape), np.float32))
                for (k, p), st in zip(params, sts)]
    return out


def _leaves(state) -> List[Tuple[str, Any]]:
    if isinstance(state, TrainState):
        return _train_state_leaves(state)
    return _keyed_leaves(state)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        try:
            return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        except TypeError:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor: numpy "
                            "has no such dtype") from None
    return str(leaf.dtype)


# -- save --------------------------------------------------------------------


class ShardedSaveHandle:
    """Returned by save_sharded: ``wait()`` blocks until the checkpoint is
    globally committed (this process's write is durable, and process 0 has
    seen every process's step-scoped marker and written COMMIT). With
    ``timeout=None`` the save's finalize budget bounds the wait, so a dead
    peer surfaces as a TimeoutError. ``seconds`` is the background write's
    time (snapshot copies to the host, files and, on process 0, the
    barrier), set when it ends."""

    def __init__(self, path: str, step: int, thread: threading.Thread,
                 finalize_timeout_s: float):
        self.path = path
        self.step = step
        self._thread = thread
        self._finalize_timeout_s = finalize_timeout_s
        self._error: Optional[BaseException] = None
        self.seconds: Optional[float] = None

    def wait(self, timeout: Optional[float] = None):
        budget = (2.0 * self._finalize_timeout_s if timeout is None
                  else timeout)
        deadline = time.monotonic() + budget
        self._thread.join(budget)
        if self._thread.is_alive():
            raise TimeoutError(f"sharded save to {self.path} still running")
        if self._error is not None:
            raise self._error
        while not is_committed(self.path, self.step):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"sharded save to {self.path} (step {self.step}) not "
                    f"committed in time: did a peer process die?"
                )
            time.sleep(0.05)

    def done(self) -> bool:
        return (not self._thread.is_alive()
                and is_committed(self.path, self.step))


def _snapshot(leaf):
    """A copy of an array leaf (a DTensor's local tensor) that the caller's
    later work cannot change: tensors are cloned on their device (on CUDA,
    queued on the current stream), numpy arrays copied."""
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf)


def _own_piece(leaf: DTensor):
    """The global box of this rank's local tensor of ``leaf``, or None when
    a replica at a lower mesh coordinate writes that box (the rank is not
    at coordinate 0 of every axis on which ``leaf`` is replicated)."""
    mesh = leaf.device_mesh
    coord = mesh.get_coordinate()
    for placement, c in zip(leaf.placements, coord):
        if placement.is_partial():
            raise ValueError(f"cannot checkpoint a {placement} DTensor: it "
                             "holds no value until reduced")
        if placement.is_replicate() and c != 0:
            return None
    return local_box(mesh, leaf.shape, leaf.placements)


# Bytes per host copy of a CUDA snapshot: the background write moves each
# leaf through a pinned staging buffer of this size, so no single driver
# call of the writer lasts long (a synchronous copy of a whole 400 MB leaf
# into pageable memory can hold back the train loop's next graph launch).
_STAGE_BYTES = 64 << 20


def _to_numpy(snap, stages: Dict) -> np.ndarray:
    """A snapshot's values on the host. A CUDA snapshot is copied in
    ``_STAGE_BYTES`` chunks through a pinned buffer, on a stream of the
    writer's own (one buffer and stream per device, in ``stages``)."""
    if not isinstance(snap, torch.Tensor):
        return snap
    if snap.device.type != "cuda":
        return snap.numpy()
    out = np.empty(tuple(snap.shape),
                   torch.empty(0, dtype=snap.dtype).numpy().dtype)
    src = snap.contiguous().reshape(-1).view(torch.uint8)
    dst = torch.from_numpy(out.reshape(-1).view(np.uint8))
    if snap.device not in stages:
        stages[snap.device] = (
            torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=True),
            torch.cuda.Stream(snap.device))
    stage, stream = stages[snap.device]
    with torch.cuda.stream(stream):
        for lo in range(0, src.numel(), _STAGE_BYTES):
            n = min(_STAGE_BYTES, src.numel() - lo)
            stage[:n].copy_(src[lo:lo + n], non_blocking=True)
            stream.synchronize()
            dst[lo:lo + n].copy_(stage[:n])
    return out


def save_sharded(state, path: str, *, step: int = 0,
                 finalize_timeout_s: float = 300.0,
                 wait: bool = False) -> ShardedSaveHandle:
    """Save a train state (a port ``TrainState``, or a tree of dicts, lists
    and tuples of tensors, numpy arrays and Python values).

    Every participating process calls this with the same state and ``step``
    (one (path, step) pair = one save). The snapshot is taken before it
    returns (on CUDA: copies queued on the current stream, see the module
    docstring); the write, and process 0's barrier and commit, run on a
    background thread. ``wait=True`` blocks until the checkpoint is
    globally committed."""
    pid, nproc = _process()
    pieces_dir = os.path.join(path, f"pieces_{step}")
    os.makedirs(pieces_dir, exist_ok=True)

    my_pieces: List = []  # [leaf key, index, snapshot]
    meta: Dict[str, Dict] = {}
    aux: Dict[str, Any] = {}  # non-array leaves (Python scalars, etc.)
    events = []
    for key, leaf in _leaves(state):
        if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            meta[key] = {"shape": list(leaf.shape),
                         "dtype": _dtype_name(leaf)}
            if isinstance(leaf, DTensor):
                box = _own_piece(leaf)
            else:  # whole on every process: process 0 writes it
                box = [(0, d) for d in leaf.shape] if pid == 0 else None
            if box is not None:
                my_pieces.append([key, box, _snapshot(leaf)])
        elif pid == 0:
            aux[key] = leaf
            meta[key] = {"aux": True}
    for dev in {p[2].device for p in my_pieces
                if isinstance(p[2], torch.Tensor)
                and p[2].device.type == "cuda"}:
        events.append(torch.cuda.current_stream(dev).record_event())

    def write():
        t0 = time.perf_counter()
        try:
            for ev in events:
                ev.synchronize()
            stages: Dict = {}
            index: Dict[str, List] = {}
            for k, piece in enumerate(my_pieces):
                key, idx, snap = piece
                piece[2] = None  # free the device copy once it is written
                tag = hashlib.md5(key.encode()).hexdigest()[:10]
                fname = f"{tag}_{pid}_{k}.npy"
                np.save(os.path.join(pieces_dir, fname),
                        _to_numpy(snap, stages), allow_pickle=False)
                index.setdefault(key, []).append([idx, fname])
            with open(os.path.join(path, f"index_{pid}.{step}.pkl"),
                      "wb") as f:
                pickle.dump(index, f, protocol=5)
            with open(os.path.join(path, f"shard_{pid}.{step}.ok"),
                      "w") as f:
                f.write("ok")
            if pid != 0:
                return
            # process 0: barrier on every process's marker, then commit
            deadline = time.monotonic() + finalize_timeout_s
            want = {f"shard_{i}.{step}.ok" for i in range(nproc)}
            while True:
                have = {m for m in want
                        if os.path.exists(os.path.join(path, m))}
                if have == want:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"sharded save: missing markers {want - have}"
                    )
                time.sleep(0.05)
            with open(os.path.join(path, f"aux.{step}.pkl"), "wb") as f:
                pickle.dump(aux, f, protocol=5)
            manifest = {"step": step, "process_count": nproc,
                        "leaves": meta}
            with open(os.path.join(path, MANIFEST_FILE), "w") as f:
                json.dump(manifest, f)
            with open(_commit_file(path), "w") as f:
                f.write(str(step))
        except BaseException as e:  # surfaced via handle.wait()
            handle._error = e
        finally:
            handle.seconds = time.perf_counter() - t0

    thread = threading.Thread(target=write, daemon=True,
                              name=f"ckpt-save-{pid}")
    handle = ShardedSaveHandle(path, step, thread, finalize_timeout_s)
    thread.start()
    if wait:
        handle.wait()
    return handle


# -- restore -----------------------------------------------------------------


class _PieceStore:
    """Lazy, memory-mapped view over every process's stored pieces: only
    the per-process index files load eagerly; piece arrays are
    ``np.load(mmap_mode="r")``, so a restore touches only the bytes its
    slice intersections copy."""

    def __init__(self, path: str, step: int, process_count: int):
        self.path = path
        self.step = step
        self.index: Dict[str, List] = {}
        for pid in range(process_count):
            fp = os.path.join(path, f"index_{pid}.{step}.pkl")
            with open(fp, "rb") as f:
                for key, entries in pickle.load(f).items():
                    self.index.setdefault(key, []).extend(entries)

    def pieces(self, key: str):
        pieces_dir = os.path.join(self.path, f"pieces_{self.step}")
        for idx, fname in self.index.get(key, []):
            arr = np.load(os.path.join(pieces_dir, fname), mmap_mode="r")
            yield idx, arr


def _assemble(pieces, index: List[Tuple[int, int]], shape, dtype):
    """Fill the [start, stop) sub-box of the global array from whatever
    stored pieces overlap it (resharding = slice intersection)."""
    sub_shape = tuple(stop - start for start, stop in index)
    out = np.empty(sub_shape, dtype=dtype)
    covered = 0
    for piece_index, arr in pieces:
        dst_sl, src_sl = [], []
        empty = False
        for (want_a, want_b), (have_a, have_b) in zip(index, piece_index):
            lo, hi = max(want_a, have_a), min(want_b, have_b)
            if lo >= hi:
                empty = True
                break
            dst_sl.append(slice(lo - want_a, hi - want_a))
            src_sl.append(slice(lo - have_a, hi - have_a))
        if empty:
            continue
        out[tuple(dst_sl)] = arr[tuple(src_sl)]
        covered += int(np.prod([s.stop - s.start for s in dst_sl]))
    want_total = int(np.prod(sub_shape)) if sub_shape else 1
    if covered < want_total:
        raise ValueError(
            f"checkpoint pieces cover {covered}/{want_total} elements of "
            f"requested index {index}: incompatible restore layout"
        )
    return out


class _Checkpoint:
    """A committed checkpoint opened for reading."""

    def __init__(self, path: str):
        if not is_committed(path):
            raise FileNotFoundError(
                f"no committed sharded checkpoint at {path} (torn save?)"
            )
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        self.step = int(manifest["step"])
        if not is_committed(path, self.step):
            raise FileNotFoundError(
                f"checkpoint at {path}: COMMIT does not match manifest step "
                f"{self.step} (mixed saves?)"
            )
        self.leaves = manifest["leaves"]
        self.store = _PieceStore(path, self.step,
                                 int(manifest["process_count"]))
        self.aux: Dict[str, Any] = {}
        aux_path = os.path.join(path, f"aux.{self.step}.pkl")
        if os.path.exists(aux_path):
            with open(aux_path, "rb") as f:
                self.aux = pickle.load(f)

    def read(self, key: str, box=None):
        """The leaf's value: its aux value, or numpy (the ``box`` of it
        when given)."""
        m = self.leaves.get(key)
        if m is None:
            raise KeyError(f"checkpoint has no leaf {key}")
        if m.get("aux"):
            return self.aux[key]
        shape = tuple(m["shape"])
        index = ([(0, d) for d in shape] if box is None
                 else _index_spec(box, shape))
        return _assemble(self.store.pieces(key), index, shape,
                         np.dtype(m["dtype"]))


def _fill(ckpt: _Checkpoint, key: str, t: torch.Tensor) -> None:
    """Copies the leaf ``key`` into ``t`` in place: a DTensor's local
    tensor takes its own rank's box, a tensor the whole leaf."""
    if isinstance(t, DTensor):
        box = local_box(t.device_mesh, t.shape, t.placements)
        t = t.to_local()
    else:
        box = None
    t.copy_(torch.from_numpy(ckpt.read(key, box)))


def _restore_train_state(ckpt: _Checkpoint, state: TrainState) -> None:
    """Fills a live port ``TrainState`` in place from the reference's keys:
    the same tensors keep their memory (a captured step keeps reading
    them); AdamW's state is made first if it has none yet."""
    params = _keyed_leaves(state.params)
    with torch.no_grad():
        state.step.copy_(torch.from_numpy(ckpt.read(_STEP_KEY)))
        count = float(ckpt.read(_ADAM_KEY + ".count"))
        for k, p in params:
            _fill(ckpt, _PARAMS_KEY + k, p)
            st = _adam_state(state.opt_state, p, create=True)
            st["step"].fill_(count)
            _fill(ckpt, _ADAM_KEY + ".mu" + k, st["exp_avg"])
            _fill(ckpt, _ADAM_KEY + ".nu" + k, st["exp_avg_sq"])


def _rebuild(ckpt: _Checkpoint, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by the checkpoint's value: a tensor
    on that leaf's device (a DTensor of its layout, its own box read), numpy,
    or the aux value."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(ckpt, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(ckpt, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if isinstance(tree, DTensor):
        box = local_box(tree.device_mesh, tree.shape, tree.placements)
        local = torch.from_numpy(ckpt.read(prefix, box)).to(tree.device)
        return DTensor.from_local(local, tree.device_mesh, tree.placements,
                                  shape=tree.shape, stride=tree.stride())
    value = ckpt.read(prefix)
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(value).to(tree.device)
    return value


def load_sharded(path: str, *, like=None, slices=None):
    """Load a sharded checkpoint (the port's or the JAX package's).

    With ``like=None``: {leaf key: numpy array (or aux value)}; ``slices``
    may map a leaf key to the box to read of it (a tuple of slices, or
    [(start, stop), ...] per dim), reassembled from the stored pieces by
    slice intersection. With ``like`` a port ``TrainState``: that state,
    filled in place (a state over a mesh: each rank reads its own boxes).
    With ``like`` any other tree of tensors: a tree of the same structure,
    each tensor on its leaf's device (DTensors laid out as theirs)."""
    ckpt = _Checkpoint(path)
    if like is None:
        slices = slices or {}
        return {key: ckpt.read(key, slices.get(key)) for key in ckpt.leaves}
    if isinstance(like, TrainState):
        _restore_train_state(ckpt, like)
        return like
    return _rebuild(ckpt, like)


def upload_sharded_checkpoint(path: str, uri: str, *, step: int = 0) -> str:
    """Push a committed sharded checkpoint to external storage (reference
    tune/syncer.py upload path; the bucket is the durable copy — a node's
    disk dies with the node). Call from ONE process after
    ``save_sharded(..., wait=True)``; returns the remote URI."""
    from ray_tpu_torch._private.external_storage import storage_from_uri

    if not is_committed(path, step):
        raise RuntimeError(
            f"checkpoint at {path} step {step} is not committed"
        )
    storage = storage_from_uri(uri)
    name = os.path.basename(path.rstrip(os.sep))
    return storage.upload_dir(path, name)


def download_sharded_checkpoint(uri: str, path: str) -> str:
    """Fetch a sharded checkpoint from external storage into ``path`` for
    ``load_sharded`` (any mesh shape — cross-shape restore is the
    loader's job)."""
    from ray_tpu_torch._private.external_storage import storage_from_uri

    storage = storage_from_uri(uri.rsplit("/", 1)[0])
    name = uri.rstrip("/").rsplit("/", 1)[1]
    storage.download_dir(name, path)
    return path
