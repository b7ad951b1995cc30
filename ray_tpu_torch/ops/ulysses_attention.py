"""Ulysses sequence parallelism: head-split attention between two
all-to-alls (PyTorch port of ``ray_tpu/ops/ulysses_attention.py``).

With the sequence split over ``sp``, an all-to-all re-lays each of q, k
and v from [B, S/sp, H, D] to [B, S, H/sp, D], so every rank attends over
the whole sequence for its share of the heads with a local attention (the
dense ``causal_attention``, or the hand-written flash kernels), and the
inverse all-to-all restores the sequence split. When the kv heads do not
divide over sp they are first repeated up to the q heads. The all-to-alls
are the autograd-aware functional collective, so the backward re-lays the
gradients the other way.

Over ``mesh`` the batch lies over (dp, ep) and the heads over tp, through
``local_map``; with no sp axis on the mesh (one rank on it) the
all-to-alls are left out and the local attention sees the whole sequence.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.ops.attention import (
    attention_per_shard,
    causal_attention,
    repeat_kv,
)


def _all_to_all(x: torch.Tensor, split: int, concat: int, sp: int,
                group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)`` over the sp group: ``x``'s dim ``split`` cut into sp
    pieces, piece j sent to rank j, and the pieces received concatenated
    along dim ``concat`` in rank order."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
    )

    shape = list(x.shape)
    pieces = x.unflatten(split, (sp, shape[split] // sp)).movedim(split, 0)
    got = all_to_all_single_autograd(pieces.contiguous(), None, None, group)
    # got[j] is rank j's piece: put the source axis just before `concat`
    return got.movedim(0, concat).flatten(concat, concat + 1)


def _ulysses_body(q, k, v, *, sp: int, group, local_attn):
    """One rank's part on its local blocks [B, S/sp, H, D]."""
    if k.shape[2] % sp:
        # too few kv heads to split: repeat them up to the q head count
        n_rep = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if sp > 1:
        q, k, v = (_all_to_all(t, 2, 1, sp, group) for t in (q, k, v))
    o = local_attn(q, k, v)  # the whole sequence on H/sp heads
    if sp > 1:
        # a tensor of its own, not a view of the collective's lazy result
        # (an AsyncCollectiveTensor): as a DTensor's local tensor, such a
        # view dropped the gradient where a later local_map consumed it
        o = _all_to_all(o, 1, 2, sp, group).clone()
    return o


def ulysses_attention(
    q: torch.Tensor,  # [B, S, H, D] DTensors, the sequence over axis_name
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    dp_axis=("dp", "ep"),
    tp_axis: str = "tp",
    attn_impl: str = "dense",  # the local attention: dense | flash
) -> torch.Tensor:
    """Causal attention with Ulysses sequence parallelism over ``mesh``, on
    each rank's [B/dp, S/sp, H/tp, D] block (``attention_per_shard``,
    through ``local_map``); the output is a DTensor of that layout."""
    from ray_tpu_torch.parallel.mesh import axis_size

    sp = axis_size(mesh, axis_name)
    if q.shape[1] % sp:
        raise ValueError(f"seq len {q.shape[1]} not divisible by sp={sp}")
    tp = axis_size(mesh, tp_axis)
    heads_per_dev = q.shape[2] // tp
    if heads_per_dev % sp:
        raise ValueError(
            f"heads-per-device ({heads_per_dev}) must be divisible by "
            f"sp={sp} for Ulysses (use ring attention otherwise)"
        )
    if attn_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        local_attn = flash_attention
    elif attn_impl == "dense":
        local_attn = causal_attention
    else:
        raise ValueError(f"unknown local attn_impl {attn_impl!r}")
    group = mesh.get_group(axis_name) if sp > 1 else None
    body = functools.partial(_ulysses_body, sp=sp, group=group,
                             local_attn=local_attn)
    return attention_per_shard(body, q, k, v, mesh=mesh, dp_axis=dp_axis,
                               tp_axis=tp_axis, seq_axis=axis_name)
