"""Mixture-of-experts FFN: GShard top-k routing with per-expert capacity,
and expert parallelism over a mesh (PyTorch port of ``ray_tpu/ops/moe.py``).

The contract is the reference's (``_top_k_mask`` :24, ``moe_ffn`` :41): a
softmax router in fp32; top-k by repeated argmax (the first index wins a
tie); the kept gates renormalised with a 1e-9 floor; per-expert capacity
C = max(1, ceil(top_k N capacity_factor / E)); positions in an expert's
buffer in GShard's slot order (every slot-0 pick before any slot-1 pick);
picks past capacity dropped (combine weight 0); the expert FFN in
``x.dtype`` with tanh GELU; the Switch load-balancing aux
E * sum_e frac_e * mean_prob_e over slot 0.

Where the reference dispatches and combines by one-hot einsums over
[G, N, E, C] tensors, ``moe_ffn`` moves tokens by index: each kept pick is
copied into its (expert, group, slot) row of the [E, G, C, D] buffer, and
each token gathers back the weighted sum of its <= k rows (in fp32, rounded
to ``x.dtype`` once, as the einsum's accumulation rounds). Every shape is
fixed by (G, N, E, C), with no host read, so a CUDA graph can capture it.
The one-hot form stays as the plain version, ``moe_ffn_reference``, which
the tests hold it against.

Over a mesh (``mesh=``) the FFN runs per shard through ``local_map``:
tokens [G, N, D] with G over (dp, ep) and N over sp, experts with E over ep
and the hidden width F over tp (``mlp``), so the ``wo`` product is a
partial sum over tp, reduced outside. The dispatched buffer goes to the
experts' ranks and back by two all-to-alls over the ``ep`` group (where the
reference's ``with_sharding_constraint`` re-layouts, :97, :101, :103, make
XLA insert them). Two things need the other shards:

- positions with the sequence split over sp: the reference's cumsum runs
  over the whole sequence (:75), so each rank starts its picks after the
  lower sp ranks' picks of the same (group, expert) and, for slot s > 0,
  after every rank's picks of the earlier slots (one all-gather of the
  per-shard counts per layer). The same picks are dropped as in the
  reference;
- the aux loss: frac and mean_prob are means over the global (G, N), so
  each is summed per shard, reduced over the token axes, and only then
  multiplied (the mean of per-shard aux values is another number).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _top_k_mask(probs: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [G, N, E] -> (gates [G, N, E] zeroed outside the top k and
    renormalised, masks [k, G, N, E] one-hot per choice slot)."""
    masks = []
    remaining = probs
    for _ in range(k):
        idx = remaining.argmax(dim=-1)  # the first index wins a tie
        m = (idx[..., None] == torch.arange(
            probs.shape[-1], device=probs.device)).to(probs.dtype)
        masks.append(m)
        remaining = remaining * (1.0 - m)
    mask = torch.stack(masks)  # [k, G, N, E]
    gates = probs * mask.sum(0)
    denom = torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates / denom, mask


def capacity(n: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Rows per expert per group for N tokens a group (``moe.py:61``)."""
    return max(1, math.ceil(top_k * n * capacity_factor / n_experts))


def _router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("gnd,de->gne", x.float(), router_w.float())
    return torch.softmax(logits, dim=-1)


@dataclasses.dataclass
class Routing:
    """Where each token's picks go. ``k`` slots, G groups, N tokens."""

    probs: torch.Tensor  # [G, N, E] fp32 router probabilities
    masks: torch.Tensor  # [k, G, N, E] one-hot pick per slot
    expert: torch.Tensor  # [k, G, N] the expert picked
    position: torch.Tensor  # [k, G, N] its row in the expert's buffer
    keep: torch.Tensor  # [k, G, N] False past capacity
    weight: torch.Tensor  # [k, G, N] fp32 renormalised gate, 0 if dropped

    def dropped(self) -> torch.Tensor:
        """How many picks went past capacity (a device scalar)."""
        return (~self.keep).sum()


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int, cap: int,
          counts_fn=None) -> Routing:
    """Routes tokens x [G, N, D] to buffers of ``cap`` rows per expert and
    group. ``counts_fn(counts [k, G, E]) -> (before [k, G, E], total [k, G,
    E])`` gives, from this shard's picks per slot, the picks of the same
    slot that come before this shard's in the sequence and every shard's
    picks (default: one shard, none before)."""
    probs = _router_probs(x, router_w)
    gates, masks = _top_k_mask(probs, top_k)
    counts = masks.sum(dim=2)  # [k, G, E]
    if counts_fn is None:
        before, total = torch.zeros_like(counts), counts
    else:
        before, total = counts_fn(counts)
    # slot s starts after this shard's predecessors' slot-s picks and after
    # every pick of the slots before it (GShard's slot order)
    start = before + total.cumsum(0) - total  # [k, G, E]
    pos = masks.cumsum(dim=2) - masks + start[:, :, None, :]
    expert = masks.argmax(dim=-1)
    position = pos.gather(-1, expert[..., None])[..., 0].long()
    keep = position < cap
    weight = gates[None].expand_as(masks).gather(-1, expert[..., None])[..., 0]
    return Routing(probs, masks, expert, position, keep,
                   torch.where(keep, weight, torch.zeros_like(weight)))


def _rows(routing: Routing, n_experts: int, cap: int) -> torch.Tensor:
    """[k, G, N] flat row of each pick in the [E, G, C] buffer; dropped
    picks go to one spare row past the end (E G C)."""
    k, g, n = routing.expert.shape
    group = torch.arange(g, device=routing.expert.device)[None, :, None]
    rows = (routing.expert * g + group) * cap + routing.position
    return torch.where(routing.keep, rows,
                       torch.full_like(rows, n_experts * g * cap))


def dispatch(x: torch.Tensor, rows: torch.Tensor, n_experts: int,
             cap: int) -> torch.Tensor:
    """x [G, N, D] -> the expert buffer [E, G, C, D] in x.dtype: each kept
    pick copied into its row (no two picks share a row), the rest zeros."""
    k = rows.shape[0]
    g, _, d = x.shape
    src = x[None].expand(k, *x.shape).reshape(-1, d)
    buf = x.new_zeros(n_experts * g * cap + 1, d)
    buf = buf.index_copy(0, rows.reshape(-1), src)
    return buf[:-1].view(n_experts, g, cap, d)


def combine(expert_out: torch.Tensor, rows: torch.Tensor,
            weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """expert_out [E, G, C, D] -> [G, N, D]: each token's picked rows
    weighted by their gates (rounded to ``dtype``, as the reference's
    combine tensor is), summed in fp32 and rounded once."""
    d = expert_out.shape[-1]
    flat = torch.cat([expert_out.reshape(-1, d),
                      expert_out.new_zeros(1, d)])
    picked = flat[rows]  # [k, G, N, D]
    w = weight.to(dtype).float()[..., None]
    return (w * picked.float()).sum(0).to(dtype)


def experts(buf: torch.Tensor, wi, wo, dtype: torch.dtype) -> torch.Tensor:
    """The expert FFN on buffers [E, G, C, D] with wi [E, D, F], wo
    [E, F, D] (int8 ``QTensor`` weights dequantize through ``.to``)."""
    h = torch.einsum("egcd,edf->egcf", buf, wi.to(dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.einsum("egcf,efd->egcd", h, wo.to(dtype))


def _aux_sums(routing: Routing) -> torch.Tensor:
    """[2, E]: slot-0 picks and router probabilities summed over the
    tokens (the Switch aux's frac and mean_prob, times the token count)."""
    return torch.stack([routing.masks[0].sum(dim=(0, 1)),
                        routing.probs.sum(dim=(0, 1))])


def _aux(sums: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """E * sum_e frac_e * mean_prob_e from ``_aux_sums`` over n tokens."""
    frac_prob = sums / n_tokens
    return (frac_prob[0] * frac_prob[1]).sum() * sums.shape[-1]


def moe_ffn(
    x: torch.Tensor,  # [G, N, D] tokens
    router_w: torch.Tensor,  # [D, E]
    wi,  # [E, D, F]
    wo,  # [E, F, D]
    *,
    top_k: int = 2,
    capacity_factor: float = 2.0,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [G, N, D] in x.dtype, aux_loss fp32 scalar). Over
    ``mesh`` the inputs are DTensors on it, and so are the outputs (see
    the module docstring)."""
    if mesh is not None:
        return _moe_ffn_sharded(x, router_w, wi, wo, top_k=top_k,
                                capacity_factor=capacity_factor, mesh=mesh)
    g, n, _ = x.shape
    e = router_w.shape[-1]
    cap = capacity(n, e, top_k, capacity_factor)
    routing = route(x, router_w, top_k, cap)
    rows = _rows(routing, e, cap)
    out = experts(dispatch(x, rows, e, cap), wi, wo, x.dtype)
    return (combine(out, rows, routing.weight, x.dtype),
            _aux(_aux_sums(routing), g * n))


def one_hot_routing(x, router_w, top_k: int, cap: int):
    """The reference's one-hot dispatch and combine tensors [G, N, E, C]
    (fp32), line for line, with the router's probs and the top-k masks."""
    g, n, _ = x.shape
    e = router_w.shape[-1]
    probs = _router_probs(x, router_w)
    gates, masks = _top_k_mask(probs, top_k)
    dispatch_t = x.new_zeros((g, n, e, cap), dtype=torch.float32)
    combine_t = torch.zeros_like(dispatch_t)
    prev_count = torch.zeros((g, 1, e), dtype=torch.float32, device=x.device)
    for s in range(masks.shape[0]):
        m = masks[s]
        pos = m.cumsum(dim=1) - m + prev_count
        keep = m * (pos < cap)
        pos_idx = (pos * m).sum(-1).long()
        # jax.nn.one_hot: an index past capacity gives a row of zeros
        pos_oh = (pos_idx[..., None] == torch.arange(cap, device=x.device)
                  ).float()
        disp_s = keep[..., None] * pos_oh[:, :, None, :]
        dispatch_t = dispatch_t + disp_s
        combine_t = combine_t + disp_s * (gates * m).sum(-1)[..., None, None]
        prev_count = prev_count + m.sum(1, keepdim=True)
    return dispatch_t, combine_t, probs, masks


def moe_ffn_reference(x, router_w, wi, wo, *, top_k: int = 2,
                      capacity_factor: float = 2.0):
    """The plain version: the reference's one-hot dispatch and combine
    tensors and einsums, line for line (one device)."""
    e = router_w.shape[-1]
    cap = capacity(x.shape[1], e, top_k, capacity_factor)
    dispatch_t, combine_t, probs, masks = one_hot_routing(x, router_w,
                                                          top_k, cap)
    expert_in = torch.einsum("gnec,gnd->egcd", dispatch_t.to(x.dtype), x)
    expert_out = experts(expert_in, wi, wo, x.dtype)
    out = torch.einsum("gnec,egcd->gnd", combine_t.to(x.dtype), expert_out)
    frac = masks[0].mean(dim=(0, 1))
    aux = (frac * probs.mean(dim=(0, 1))).sum() * e
    return out, aux


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

def _to_experts(buf: torch.Tensor, ep: int, group) -> torch.Tensor:
    """[E, G, C, D] -> [E/ep, ep G, C, D] on the experts' rank: rows of
    expert block j go to ep rank j; each rank receives its experts' rows
    from every ep rank, the source rank major within each expert."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
    )

    e, g, c, d = buf.shape
    got = all_to_all_single_autograd(buf.contiguous(), None, None, group)
    got = got.view(ep, e // ep, g, c, d).transpose(0, 1)
    return got.reshape(e // ep, ep * g, c, d)


def _from_experts(out: torch.Tensor, ep: int, group) -> torch.Tensor:
    """The inverse of ``_to_experts``: [E/ep, ep G, C, D] -> [E, G, C, D]
    back on the tokens' ranks."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
    )

    el, eg, c, d = out.shape
    g = eg // ep
    send = out.view(el, ep, g, c, d).transpose(0, 1).contiguous()
    got = all_to_all_single_autograd(send.view(ep * el, g, c, d), None,
                                     None, group)
    return got.view(ep * el, g, c, d)


def _sp_counts_fn(mesh, sp: int):
    """``route``'s ``counts_fn`` with the sequence split over sp: the
    counts of every sp rank (one all-gather), summed below this rank and in
    all."""
    import torch.distributed as dist

    if sp == 1:
        return None
    group = mesh.get_group("sp")
    me = mesh.get_local_rank("sp")

    def counts_fn(counts):
        every = counts.new_empty((sp * counts.shape[0],) + counts.shape[1:])
        dist.all_gather_into_tensor(every, counts.contiguous(), group=group)
        every = every.view((sp,) + tuple(counts.shape))
        return every[:me].sum(0), every.sum(0)

    return counts_fn


def _moe_ffn_sharded(x, router_w, wi, wo, *, top_k, capacity_factor, mesh):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import (
        AxisRules,
        axis_size,
        logical_to_placements,
    )

    names = tuple(mesh.mesh_dim_names)
    g_all, n_all, _ = x.shape
    e = router_w.shape[-1]
    dp, ep, sp = (axis_size(mesh, a) for a in ("dp", "ep", "sp"))
    if e % ep:
        raise ValueError(f"{e} experts do not divide over ep={ep}")
    if g_all % (dp * ep) or n_all % sp:
        raise ValueError(
            f"tokens [{g_all}, {n_all}] do not split evenly over dp x ep = "
            f"{dp * ep} groups and sp={sp} sequence shards")
    cap = capacity(n_all, e, top_k, capacity_factor)
    rules = AxisRules((("batch", ("dp", "ep")), ("seq", "sp"),
                       ("experts", "ep"), ("mlp", "tp")))
    tokens = logical_to_placements(mesh, rules, ("batch", "seq", None))
    w_in = logical_to_placements(mesh, rules, ("experts", None, "mlp"))
    w_out = logical_to_placements(mesh, rules, ("experts", "mlp", None))
    whole = (Replicate(),) * len(names)

    def partial_on(placements, axes):
        return tuple(Partial() if a in axes else p
                     for a, p in zip(names, placements))

    # Everything the local function returns is a partial sum over tp: the
    # output, since each tp rank holds one slice of F, and the aux
    # statistics (this rank's token sums, divided by tp; partial over the
    # token axes as well). So are the local gradients of x and of the
    # router (over every axis); those of the expert weights are partial
    # over the token axes that do not split them (dp, sp).
    tp = axis_size(mesh, "tp")
    outs = (partial_on(tokens, ("tp",)),
            partial_on(whole, ("dp", "ep", "sp", "tp")))
    grads = (partial_on(tokens, ("tp",)), partial_on(whole, names),
             partial_on(w_in, ("dp", "sp")), partial_on(w_out, ("dp", "sp")))
    counts_fn = _sp_counts_fn(mesh, sp)
    ep_group = mesh.get_group("ep") if ep > 1 else None

    def local(xl, rw, wil, wol):
        routing = route(xl, rw, top_k, cap, counts_fn)
        rows = _rows(routing, e, cap)
        buf = dispatch(xl, rows, e, cap)
        if ep > 1:
            buf = _to_experts(buf, ep, ep_group)
        out = experts(buf, wil, wol, xl.dtype)
        if ep > 1:
            out = _from_experts(out, ep, ep_group)
        return (combine(out, rows, routing.weight, xl.dtype),
                _aux_sums(routing) / tp)

    out, sums = local_map(
        local, out_placements=outs,
        in_placements=(tokens, whole, w_in, w_out), in_grad_placements=grads,
        device_mesh=mesh, redistribute_inputs=True)(x, router_w, wi, wo)
    return out, _aux(sums.redistribute(mesh, whole), g_all * n_all)
