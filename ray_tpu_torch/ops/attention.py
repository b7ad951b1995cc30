"""Dense causal multi-head attention (reference implementation).

Port of ``ray_tpu/ops/attention.py``. The oracle for every attention test of
the port, and the ``attn_impl="dense"`` path of the transformer. Scores are
taken in fp32 from the input dtype, as JAX's ``preferred_element_type``.
Over a mesh an attention runs per shard (``attention_per_shard``): batch
rows and heads attend independently.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] (grouped-query attention)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d
    )


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, H, D] against k/v [B, Sk, Hkv, D]; ``mask`` broadcasts
    against the fp32 scores [B, H, Sq, Sk] (True = attend; NEG_INF
    elsewhere). p is rounded to q's dtype before the product with v."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_offset: Union[int, torch.Tensor] = 0,
    causal: bool = True,
) -> torch.Tensor:
    """Standard softmax attention with a causal mask on global positions.

    q_offset/kv_offset give the global position of element 0 of each block so
    the same function serves full sequences and blockwise shards.
    """
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_update(
    scores: torch.Tensor,  # [B, H, Sq, Skblk] fp32, already masked
    v_blk: torch.Tensor,  # [B, Skblk, H, D]
    acc: torch.Tensor,  # [B, Sq, H, D] fp32 running numerator
    m: torch.Tensor,  # [B, H, Sq] running row max
    l: torch.Tensor,  # [B, H, Sq] running denominator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One flash-attention accumulation step (online softmax)."""
    m_blk = scores.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    acc_new = acc * correction.permute(0, 2, 1)[..., None] + pv
    return acc_new, m_new, l_new


def blockwise_finalize(acc: torch.Tensor, l: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """acc [B, Sq, H, D], l [B, H, Sq] -> normalized output in `dtype`."""
    denom = torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]
    return (acc / denom).to(dtype)


def attention_per_shard(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *, mesh, dp_axis=("dp", "ep"),
                        tp_axis: str = "tp",
                        seq_axis=None) -> torch.Tensor:
    """``fn(q, k, v)`` on each rank's [B/dp, S, H/tp, D] shard of the
    DTensors q, k, v on ``mesh``, through ``local_map``: batch over
    ``dp_axis``, heads over ``tp_axis``, the sequence whole, or split over
    ``seq_axis`` when given (for an attention whose ``fn`` talks to the
    other sequence shards); inputs that lie otherwise are redistributed
    first, as ``shard_map`` reshards. The output is a DTensor of that
    layout. The kv heads must divide over tp."""
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import (
        AxisRules,
        axis_size,
        logical_to_placements,
    )

    tp = axis_size(mesh, tp_axis)
    if k.shape[2] % tp:
        raise ValueError(
            f"kv heads ({k.shape[2]}) must divide over tp={tp} for the "
            "attention to run per shard; use more kv heads or a smaller tp "
            "axis"
        )
    rules = AxisRules((("batch", dp_axis), ("seq", seq_axis),
                       ("heads", tp_axis)))
    spec = logical_to_placements(mesh, rules, ("batch", "seq", "heads", None))
    return local_map(fn, out_placements=(spec,),
                     in_placements=(spec, spec, spec), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)
