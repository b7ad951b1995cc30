"""A multi-device dry run of the train step (PyTorch port of part 1 of
``__graft_entry__.dryrun_multichip``, ``__graft_entry__.py:175-181``).

``dryrun_multidevice(n)`` runs in each of the ``n`` processes of an
initialized process group of world size ``n`` (one device each): it builds
a dp x tp mesh by the reference's rule (``_factor_axes``), makes a ``tiny``
sharded train state from one seed, and takes a few train steps over the
mesh, with flash attention run per shard. The loss must be finite and
fall. The reference's rule also splits a sequence axis, which its ring
attention serves; the port has no ring attention yet, so that axis folds
into dp. The pipeline, MoE and ep parts of the reference's dry run wait for
the port of those layers.
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


def dryrun_multidevice(n: int, device_type: Optional[str] = None) -> Dict:
    """Runs the dry run on this rank (every rank calls it alike). Returns
    the mesh's axis sizes and the losses; raises if a loss is not finite
    or the last is not below the first."""
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"dryrun_multidevice({n}) runs in each process of an initialized "
            f"process group of world size {n}: call "
            "torch.distributed.init_process_group first")
    if device_type in (None, "cuda") and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    axes = _factor_axes(n)
    axes = dict(axes, dp=axes["dp"] * axes["sp"], sp=1)  # no ring attention
    mesh = build_mesh(MeshConfig(**axes), device_type)
    cfg = dataclasses.replace(TransformerConfig.tiny(max_seq_len=SEQ),
                              attn_impl="flash")
    opt = default_optimizer()
    state, state_sh = make_sharded_state(cfg, opt, seed=0, mesh=mesh)
    step = make_train_step(cfg, opt, mesh=mesh, state_shardings=state_sh)
    batch_size = max(4, 2 * axes["dp"])
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (batch_size, SEQ + 1))
    batch = {"tokens": torch.from_numpy(ids[:, :-1]),
             "targets": torch.from_numpy(ids[:, 1:]),
             "mask": torch.ones((batch_size, SEQ))}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"dryrun_multidevice: losses {losses} are not "
                           "finite and falling")
    shape = {a: axis_size(mesh, a) for a in ("dp", "pp", "ep", "sp", "tp")}
    if dist.get_rank() == 0:
        print(f"dryrun_multidevice ok: mesh={shape} loss={losses[-1]:.4f}",
              flush=True)
    return {"mesh": shape, "losses": losses}
