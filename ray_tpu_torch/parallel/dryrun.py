"""A multi-device dry run of the train step (PyTorch port of
``__graft_entry__.dryrun_multichip``, ``__graft_entry__.py:165-237``: parts
1, 2, 2b, 2c and 3).

``dryrun_multidevice(n)`` runs in each of the ``n`` processes of an
initialized process group of world size ``n`` (one device each). Part 1
builds a dp x sp x tp mesh by the reference's rule (``_factor_axes``),
with ring attention when the rule gives sp = 2 (the long-context layout)
and flash attention run per shard otherwise, makes a ``tiny`` sharded train
state from one seed and takes a few train steps over the mesh. For an even
n of at least 4: part 2 trains ``tiny`` as a GPipe pipeline over dp = n / 2
x pp = 2 (2 microbatches); part 2b, when 8 divides n, as a 1F1B pipeline
over dp = n / 4 x pp = 2 x tp = 2 (tp inside each stage); part 2c, when 4
divides n, a 4-layer ``tiny`` as a 1F1B pipeline over pp = 4 at 8
microbatches (more than pp, where 1F1B's interleaving differs from GPipe),
and asserts the bounded-activation property: 1F1B's peak activation bytes
(``_pipeline_peak_bytes``) at most 1.05 times GPipe's on the same step.
Part 3 trains ``tiny`` with 4 experts (top-2) over dp = n / (2 tp), ep = 2,
tp (tp = 2 when 4 divides n): expert parallelism, the expert all-to-alls
over ep. Each part's loss must be finite and fall.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models.transformer import TransformerConfig, tree_leaves
from ray_tpu_torch.parallel.mesh import MeshConfig, axis_size, build_mesh
from ray_tpu_torch.parallel.pipeline import make_pipeline_train_step
from ray_tpu_torch.parallel.train_step import (
    default_optimizer,
    make_sharded_state,
    make_train_step,
)


def _factor_axes(n: int) -> Dict[str, int]:
    """Split n devices over (dp, pp, ep, sp, tp), favouring tp then sp then
    dp (the reference's rule, ``__graft_entry__.py:27-34``)."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    rem //= sp
    dp = rem
    return dict(dp=dp, pp=1, ep=1, sp=sp, tp=tp)


STEPS, SEQ = 3, 128


def _batch(cfg: TransformerConfig, batch_size: int, seq: int = SEQ) -> Dict:
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (batch_size, seq + 1))
    return {"tokens": torch.from_numpy(ids[:, :-1]),
            "targets": torch.from_numpy(ids[:, 1:]),
            "mask": torch.ones((batch_size, seq))}


def _make_step(axes: Dict[str, int], cfg: TransformerConfig,
               device_type: Optional[str], microbatches: Optional[int],
               schedule: str):
    """A ``cfg`` state from seed 0 over a mesh of ``axes`` and its train
    step: pipelined over ``microbatches`` when given."""
    mesh = build_mesh(MeshConfig(**axes), device_type)
    opt = default_optimizer()
    state, state_sh = make_sharded_state(cfg, opt, seed=0, mesh=mesh)
    if microbatches:
        step = make_pipeline_train_step(cfg, opt, microbatches, mesh=mesh,
                                        state_shardings=state_sh,
                                        schedule=schedule)
    else:
        step = make_train_step(cfg, opt, mesh=mesh, state_shardings=state_sh)
    return mesh, state, step


def _run_one(axes: Dict[str, int], cfg: TransformerConfig, batch_size: int,
             device_type: Optional[str], microbatches: Optional[int] = None,
             schedule: str = "gpipe") -> Dict:
    """STEPS train steps of a ``cfg`` state from seed 0 over a mesh of
    ``axes`` (pipelined over ``microbatches`` under ``schedule`` when
    given); the mesh's axis sizes and the losses."""
    mesh, state, step = _make_step(axes, cfg, device_type, microbatches,
                                   schedule)
    batch = _batch(cfg, batch_size)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    shape = {a: axis_size(mesh, a) for a in ("dp", "pp", "ep", "sp", "tp")}
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"dryrun_multidevice: mesh {shape}: losses "
                           f"{losses} are not finite and falling")
    return {"mesh": shape, "losses": losses}


class _SavedBytes:
    """The bytes of the storages that autograd holds saved for a backward
    (``torch.autograd.graph.saved_tensors_hooks``), now and at most at
    once; a storage saved several times counts once, and the ``exclude``d
    storages (the state's) not at all."""

    def __init__(self, exclude):
        self.exclude, self.refs, self.now, self.peak = set(exclude), {}, 0, 0

    def pack(self, t: torch.Tensor):
        if isinstance(t, DTensor):  # its memory is its local tensor's
            with torch.no_grad():
                storage = t.to_local().untyped_storage()
        else:
            storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr in self.exclude:
            return t
        if ptr not in self.refs:
            self.refs[ptr] = [0, storage.nbytes()]
            self.now += storage.nbytes()
            self.peak = max(self.peak, self.now)
        self.refs[ptr][0] += 1
        held = _Held(t)
        weakref.finalize(held, self._release, ptr)
        return held

    def _release(self, ptr: int) -> None:
        entry = self.refs[ptr]
        entry[0] -= 1
        if entry[0] == 0:
            self.now -= entry[1]
            del self.refs[ptr]

    @staticmethod
    def unpack(held):
        return held.t if isinstance(held, _Held) else held


class _Held:
    def __init__(self, t: torch.Tensor):
        self.t = t


def _pipeline_peak_bytes(axes: Dict[str, int], cfg: TransformerConfig,
                         microbatches: int, schedule: str,
                         device_type: Optional[str], seq: int = SEQ) -> int:
    """The activation footprint of one pipelined train step, the port's
    stand-in for XLA's compiled ``temp_size_in_bytes``
    (``__graft_entry__.py:81-108``), on a batch of 8 rows of ``seq`` tokens
    per dp rank.

    On CUDA: the caching allocator's peak above what is allocated before
    one eager step (a first eager step has made the optimizer's moments),
    which is everything the step makes and frees. On the CPU there is no
    such peak to read: the figure is the most bytes autograd holds saved at
    once during one eager step (``_SavedBytes``, the state's own storages
    left out), which is what GPipe's schedule grows with M and what 1F1B
    bounds; tensors the step holds outside autograd (1F1B's ring and grad
    accumulators) are not counted there."""
    mesh, state, step = _make_step(axes, cfg, device_type, microbatches,
                                   schedule)
    batch = _batch(cfg, 8 * axes["dp"], seq)
    if mesh.device_type == "cuda":
        step.eager(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step.eager(state, batch)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base
    meter = _SavedBytes(t.to_local().untyped_storage().data_ptr()
                        for t in tree_leaves(state.params))
    with torch.autograd.graph.saved_tensors_hooks(meter.pack, meter.unpack):
        step.eager(state, batch)
    return meter.peak


def dryrun_multidevice(n: int, device_type: Optional[str] = None) -> Dict:
    """Runs the dry run on this rank (every rank calls it alike). Returns
    part 1's mesh axis sizes and losses, and those of the parts that run:
    2 under ``"pipeline"``, 2b under ``"pipeline_tp"``, 2c under
    ``"pipeline_deep"`` (with ``"peak_bytes"`` per schedule) and 3 under
    ``"moe"``; raises if a loss is not finite, the last is not below the
    first, or 1F1B's peak exceeds 1.05 times GPipe's."""
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"dryrun_multidevice({n}) runs in each process of an initialized "
            f"process group of world size {n}: call "
            "torch.distributed.init_process_group first")
    if device_type in (None, "cuda") and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    rank0 = dist.get_rank() == 0
    # 1) dp/sp/tp with ring attention (the long-context layout)
    axes = _factor_axes(n)
    cfg = TransformerConfig.tiny(max_seq_len=SEQ, n_layers=2,
                                 attn_impl="ring" if axes["sp"] > 1
                                 else "flash")
    out = _run_one(axes, cfg, max(4, 2 * axes["dp"]), device_type)
    if rank0:
        print(f"dryrun_multidevice ok: mesh={out['mesh']} "
              f"loss={out['losses'][-1]:.4f}", flush=True)
    if n % 2 == 0 and n >= 4:
        # 2) pipeline parallelism: GPipe over pp = 2 stages
        pp_axes = dict(dp=n // 2, pp=2, ep=1, sp=1, tp=1)
        tiny = TransformerConfig.tiny(max_seq_len=SEQ, n_layers=2)
        out["pipeline"] = _run_one(pp_axes, tiny, 2 * (n // 2) * 2,
                                   device_type, microbatches=2)
        if rank0:
            print(f"dryrun_multidevice ok (pipeline): "
                  f"mesh={out['pipeline']['mesh']} "
                  f"loss={out['pipeline']['losses'][-1]:.4f}", flush=True)
        if n % 8 == 0:
            # 2b) dp x pp x tp on the 1F1B schedule: tp inside each stage
            combo = dict(dp=n // 4, pp=2, ep=1, sp=1, tp=2)
            out["pipeline_tp"] = _run_one(combo, tiny, 2 * combo["dp"] * 2,
                                          device_type, microbatches=2,
                                          schedule="1f1b")
            if rank0:
                print(f"dryrun_multidevice ok (dp x pp x tp, 1f1b): "
                      f"mesh={out['pipeline_tp']['mesh']} "
                      f"loss={out['pipeline_tp']['losses'][-1]:.4f}",
                      flush=True)
        if n % 4 == 0:
            # 2c) a deep pipeline, pp = 4 at 8 microbatches (more than pp,
            # where 1F1B's interleaving differs from GPipe's), with the
            # bounded-activation check: 1F1B's peak must not grow with M as
            # GPipe's does
            pp4 = dict(dp=n // 4, pp=4, ep=1, sp=1, tp=1)
            cfg4 = TransformerConfig.tiny(max_seq_len=SEQ, n_layers=4)
            deep = _run_one(pp4, cfg4, 8 * pp4["dp"], device_type,
                            microbatches=8, schedule="1f1b")
            deep["peak_bytes"] = {
                sched: _pipeline_peak_bytes(pp4, cfg4, 8, sched, device_type)
                for sched in ("1f1b", "gpipe")}
            mem_1f1b, mem_gpipe = (deep["peak_bytes"]["1f1b"],
                                   deep["peak_bytes"]["gpipe"])
            if mem_1f1b > 1.05 * mem_gpipe:
                raise RuntimeError(
                    f"1F1B peak {mem_1f1b} vs GPipe {mem_gpipe}: the "
                    "bounded-activation schedule regressed")
            out["pipeline_deep"] = deep
            if rank0:
                print(f"dryrun_multidevice ok (pp=4, M=8, 1f1b): "
                      f"mesh={deep['mesh']} loss={deep['losses'][-1]:.4f}; "
                      f"1f1b peak {mem_1f1b / 1e6:.2f}MB <= gpipe "
                      f"{mem_gpipe / 1e6:.2f}MB at M=8", flush=True)
        # 3) expert parallelism: the MoE FFN, experts split over ep = 2
        tp = 2 if n % 4 == 0 else 1
        ep_axes = dict(dp=n // (2 * tp), pp=1, ep=2, sp=1, tp=tp)
        moe_cfg = dataclasses.replace(
            TransformerConfig.tiny(max_seq_len=SEQ, n_layers=2),
            moe_experts=4, moe_top_k=2)
        out["moe"] = _run_one(ep_axes, moe_cfg,
                              max(4, 2 * ep_axes["dp"] * 2), device_type)
        if rank0:
            print(f"dryrun_multidevice ok (moe/ep): "
                  f"mesh={out['moe']['mesh']} "
                  f"loss={out['moe']['losses'][-1]:.4f}", flush=True)
    return out
