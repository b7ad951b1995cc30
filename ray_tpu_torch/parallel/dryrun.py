"""A multi-device dry run of the train step (PyTorch port of parts 1 and 3
of ``__graft_entry__.dryrun_multichip``, ``__graft_entry__.py:175-181`` and
``:228-237``).

``dryrun_multidevice(n)`` runs in each of the ``n`` processes of an
initialized process group of world size ``n`` (one device each). Part 1
builds a dp x sp x tp mesh by the reference's rule (``_factor_axes``),
with ring attention when the rule gives sp = 2 (the long-context layout)
and flash attention run per shard otherwise, makes a ``tiny`` sharded train
state from one seed and takes a few train steps over the mesh. Part 3, for
an even n of at least 4, trains ``tiny`` with 4 experts (top-2) over
dp = n / (2 tp), ep = 2, tp (tp = 2 when 4 divides n): expert parallelism,
the expert all-to-alls over ep. Each part's loss must be finite and fall.
The pipeline parts (2, 2b, 2c) wait for the port of the pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel.mesh import MeshConfig, axis_size, build_mesh
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


def _run_one(axes: Dict[str, int], cfg: TransformerConfig, batch_size: int,
             device_type: Optional[str]) -> Dict:
    """STEPS train steps of a ``cfg`` state from seed 0 over a mesh of
    ``axes``; the mesh's axis sizes and the losses."""
    mesh = build_mesh(MeshConfig(**axes), device_type)
    opt = default_optimizer()
    state, state_sh = make_sharded_state(cfg, opt, seed=0, mesh=mesh)
    step = make_train_step(cfg, opt, mesh=mesh, state_shardings=state_sh)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (batch_size, SEQ + 1))
    batch = {"tokens": torch.from_numpy(ids[:, :-1]),
             "targets": torch.from_numpy(ids[:, 1:]),
             "mask": torch.ones((batch_size, SEQ))}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    shape = {a: axis_size(mesh, a) for a in ("dp", "pp", "ep", "sp", "tp")}
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"dryrun_multidevice: mesh {shape}: losses "
                           f"{losses} are not finite and falling")
    return {"mesh": shape, "losses": losses}


def dryrun_multidevice(n: int, device_type: Optional[str] = None) -> Dict:
    """Runs the dry run on this rank (every rank calls it alike). Returns
    part 1's mesh axis sizes and losses, and part 3's under ``"moe"`` when
    it runs; raises if a loss is not finite or the last is not below the
    first."""
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
