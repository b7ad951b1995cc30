"""Ring attention: exact causal attention with the sequence split over the
``sp`` mesh axis (PyTorch port of ``ray_tpu/ops/ring_attention.py``).

Each sp rank holds a contiguous block of q, k and v. The K/V blocks travel
the ring, each hop to rank (i + 1) mod sp, while every rank accumulates its
q block's attention with the online-softmax update (``blockwise_update`` /
``blockwise_finalize`` of ``ops/attention.py``): scores in fp32, masked by
global positions, GQA through ``repeat_kv``. The full S x S scores never
exist. A hop is an all-to-all over the sp group with one non-empty split
(the autograd-aware functional collective), so its backward sends the
gradients the other way round the ring.

As in the reference, every rank computes every block it holds, and the
mask makes a block wholly in the future a no-op (exp(NEG_INF - m) is 0):
skipping it would leave the blocks a rank received unused on some ranks,
whose backward would then never make the reverse hop that their peers
wait for. The reference's last hop brings nothing that is used and is not
made.

Over ``mesh`` the batch lies over (dp, ep) and the heads over tp, through
``local_map``. A mesh without an sp axis (one rank on it) gives the
one-block case: causal attention on the whole sequence.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.ops.attention import (
    NEG_INF,
    attention_per_shard,
    blockwise_finalize,
    blockwise_update,
    repeat_kv,
)


def _hop(x: torch.Tensor, sp: int, me: int, group) -> torch.Tensor:
    """This rank's block to rank me + 1 (mod sp); returns rank me - 1's."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
    )

    n = x.shape[0]
    send = [n if r == (me + 1) % sp else 0 for r in range(sp)]
    recv = [n if r == (me - 1) % sp else 0 for r in range(sp)]
    return all_to_all_single_autograd(x.contiguous(), recv, send, group)


def _ring_body(q, k, v, *, sp: int, me: int, group):
    """One rank's part on its local blocks [B, S/sp, H, D]."""
    b, sl, h, d = q.shape
    n_rep = h // k.shape[2]
    scale = d ** -0.5
    q32 = q.float()
    q_pos = me * sl + torch.arange(sl, device=q.device)
    acc = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    for t in range(sp):
        # at step t this rank holds the kv block first held by me - t
        kv_idx = (me - t) % sp
        k_rep = repeat_kv(k, n_rep).float()
        v_rep = repeat_kv(v, n_rep)
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_rep) * scale
        k_pos = kv_idx * sl + torch.arange(sl, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
        acc, m, l = blockwise_update(scores, v_rep, acc, m, l)
        if t + 1 < sp:
            k, v = _hop(k, sp, me, group), _hop(v, sp, me, group)
    return blockwise_finalize(acc, l, q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D] DTensors, the sequence over axis_name
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    dp_axis=("dp", "ep"),
    tp_axis: str = "tp",
) -> torch.Tensor:
    """Causal attention with sequence parallelism over ``mesh``: each rank
    runs the ring on its [B/dp, S/sp, H/tp, D] block
    (``attention_per_shard``, through ``local_map``); the output is a
    DTensor of that layout."""
    from ray_tpu_torch.parallel.mesh import axis_size

    sp = axis_size(mesh, axis_name)
    if q.shape[1] % sp:
        raise ValueError(f"seq len {q.shape[1]} not divisible by sp={sp}")
    me = mesh.get_local_rank(axis_name) if sp > 1 else 0
    group = mesh.get_group(axis_name) if sp > 1 else None
    body = functools.partial(_ring_body, sp=sp, me=me, group=group)
    return attention_per_shard(body, q, k, v, mesh=mesh, dp_axis=dp_axis,
                               tp_axis=tp_axis, seq_axis=axis_name)
