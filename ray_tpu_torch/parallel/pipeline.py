"""Pipeline parallelism over the ``pp`` mesh axis: GPipe and 1F1B (PyTorch
port of ``ray_tpu/parallel/pipeline.py``).

The transformer's layer stack lies split over pp (the ``layers -> pp``
rule: each rank holds L/pp contiguous layers, its stage). Every rank runs
the same schedule on its own stage; activation blocks move between
neighbouring stages by a ring shift over the pp group (``ppermute``: a
``batch_isend_irecv``, one hop), and sums over stages are all-reduces over
that group.

Two schedules, as in the reference:

- **GPipe** (``pipeline_loss_fn``): all-forward, then all-backward, the
  backward taken by autograd through the schedule. Simple, but the
  activations autograd holds grow with the microbatch count M.
- **1F1B** (``pipeline_grads_1f1b``): each tick runs one forward and one
  backward microbatch per stage; the backward recomputes the stage forward
  from a ring buffer of stage inputs (``torch.autograd.grad`` at the
  backward tick, the counterpart of ``jax.vjp``), so what a stage holds in
  flight is the ring (2·pp blocks), not M. Scoring is vocab-parallel: each
  rank projects its own block of the head's columns, with a global
  logsumexp.

The reference's ``shard_map`` is manual over (dp, pp) and leaves tp to
GSPMD inside each stage. Here each rank works on its own local tensors over
(dp, pp), and tp stays with DTensor: a stage's weights and activations are
DTensors on the tp sub-mesh (``mesh["tp"]``), and ``apply_layer`` runs over
them as it does on the non-pipelined path (``_product_per_shard``,
``attention_per_shard``). 1F1B's scoring runs on local tensors, its vocab
split over pp and tp alike. sp and ep must be 1; the stages use dense
attention.

The schedule is uniform, as the reference's: every rank computes every slot
of every tick, masked ones included, and joins every collective in the same
order. Under GPipe the masked values enter the autograd graph through
``torch.where`` (not a Python branch), so that every rank's backward makes
every reverse hop: a hop that one rank's graph lacked would leave its
neighbours waiting.

Gradients leave both schedules as DTensors on the full mesh that the train
step reduces into the parameters' placements (``_reduced_grad``): a partial
sum over dp (each rank scored its own rows of the batch), the layer stack
``Shard(0)`` over pp (each stage's own layers), 1F1B's head ``Shard(1)``
over pp (each stage's own columns), and every other leaf a partial sum over
pp (each stage contributes its part: the embedding on the first, the final
norm and head on the last).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _embedding,
    _rms_norm,
    _target_log_probs,
    apply_layer,
    lm_head,
    param_logical_axes,
    remat_wrap,
    tree_leaves,
    tree_map,
    unbind_layers,
)
from ray_tpu_torch.ops.attention import attention_per_shard, causal_attention
from ray_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    AxisRules,
    axis_size,
    local_box,
    shardings_for,
)
from ray_tpu_torch.parallel.train_step import (
    ClippedAdamW,
    TrainStep,
    _tree_zip,
    batch_sharding,
    make_train_step,
)

_MANUAL_AXES = ("dp", "pp")


# ---------------------------------------------------------------------------
# The pp verbs
# ---------------------------------------------------------------------------

class _Axis:
    """One mesh axis seen from this rank: its process group, the global
    ranks along it (in coordinate order) and this rank's coordinate. An axis
    the mesh left out holds one rank, and its collectives are identities."""

    def __init__(self, mesh, name: str):
        if name in mesh.mesh_dim_names:
            self.group = mesh.get_group(name)
            self.ranks = dist.get_process_group_ranks(self.group)
            self.index = self.ranks.index(dist.get_rank())
        else:
            self.group, self.ranks, self.index = None, [dist.get_rank()], 0
        self.size = len(self.ranks)

    def shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """The ring shift by ``step``: this rank sends ``x`` to coordinate
        index + step and receives the block of index - step."""
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        n = self.size
        ops = [dist.P2POp(dist.isend, x, self.ranks[(self.index + step) % n],
                          self.group),
               dist.P2POp(dist.irecv, out,
                          self.ranks[(self.index - step) % n], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.size == 1:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Coordinate ``src``'s ``x`` on every rank of the axis."""
        if self.size == 1:
            return x
        out = x.contiguous().clone()
        dist.broadcast(out, self.ranks[src], group=self.group)
        return out


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` by a ring shift; its backward is the reverse
    shift."""

    @staticmethod
    def forward(ctx, x, axis: _Axis, step: int):
        ctx.axis, ctx.step = axis, step
        return axis.shift(x, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g, -ctx.step), None, None


def ppermute(x: torch.Tensor, axis: _Axis, step: int) -> torch.Tensor:
    return x if axis.size == 1 else _PPermute.apply(x, axis, step)


class _PSum(torch.autograd.Function):
    """``lax.psum`` with its transpose: the backward all-reduces the
    cotangents too, so a value replicated over the axis and seeded on every
    rank collects the seeds of all of them (hence 1F1B's seed of one over
    the axis size)."""

    @staticmethod
    def forward(ctx, x, axis: _Axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


def _psum(x: torch.Tensor, axes) -> torch.Tensor:
    for axis in axes:
        if axis.size > 1:
            x = _PSum.apply(x, axis)
    return x


def _pmax_sg(x: torch.Tensor, axes) -> torch.Tensor:
    """``_pmax_pp_sg``: the maximum over ``axes`` with no gradient (the
    logsumexp's shift is inert)."""
    x = x.detach()
    for axis in axes:
        x = axis.all_reduce(x, dist.ReduceOp.MAX)
    return x


def _sum_over_stages(x: torch.Tensor, mesh) -> DTensor:
    """``psum(x, ("dp", "pp"))`` as a replicated DTensor on ``mesh``: x is
    this rank's part (a partial sum over dp and pp, whole over tp). The
    gradient reaches each rank's part as the replicated value's own, as the
    reference's psum inside ``shard_map`` does."""
    parts = [Partial() if name in _MANUAL_AXES else Replicate()
             for name in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, parts, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


class _FromOwner(torch.autograd.Function):
    """The block that coordinate ``owner`` of ``axis`` holds, on every rank
    of the axis (a broadcast; ``x`` is the owner's block, and elsewhere a
    block of its shape whose values are ignored). Every rank then computes
    with it alike, so the owner's gradient is already the whole one: the
    backward hands it to the owner and nothing to the others."""

    @staticmethod
    def forward(ctx, x, axis: _Axis, owner: int):
        ctx.mine = axis.index == owner
        out = x.detach().clone() if ctx.mine else torch.empty_like(x)
        dist.broadcast(out, axis.ranks[owner], group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else None), None, None


def layers_whole(stacked: Dict, n_layers: int, mesh) -> List[Callable]:
    """The non-pipelined model over a mesh with pp > 1, as the reference's
    GSPMD runs it: the stack stays split over pp, and each layer's weights
    are made whole over pp just before that layer runs. Returns, per layer,
    a function of no arguments that gives that layer's parameter tree as
    DTensors on ``mesh``, whole over pp and laid out as the stack is on
    every other axis (call it inside the remat region, so that only one
    layer's weights are whole at a time). The owner's slice of the stack
    gets the layer's gradient."""
    pp = axis_size(mesh, "pp")
    if n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={n_layers} "
                         "(equal stages)")
    axis, per = _Axis(mesh, "pp"), n_layers // pp
    pp_dim = mesh.mesh_dim_names.index("pp")

    def split(x: DTensor):
        pl = list(x.placements)
        if pl[pp_dim] != Shard(0) or any(
                isinstance(p, Shard) and p.dim == 0
                for i, p in enumerate(pl) if i != pp_dim):
            raise ValueError(f"the layer stack must lie Shard(0) over pp "
                             f"alone, not {tuple(pl)}")
        layer_pl = [Replicate() if i == pp_dim else
                    Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for i, p in enumerate(pl)]
        return (x.to_local().unbind(0), layer_pl, x.shape[1:],
                x.stride()[1:])

    parts = tree_map(split, stacked)  # a tuple is a leaf

    def whole(i: int) -> Dict:
        owner = i // per

        def one(part):
            slices, layer_pl, shape, stride = part
            block = _FromOwner.apply(slices[i % per], axis, owner)
            return DTensor.from_local(block, mesh, layer_pl, run_check=False,
                                      shape=shape, stride=stride)

        return tree_map(one, parts)

    return [functools.partial(whole, i) for i in range(n_layers)]


# ---------------------------------------------------------------------------
# A stage
# ---------------------------------------------------------------------------

def _stage_placements(config: TransformerConfig, mesh, rules: AxisRules,
                      vocab_parallel_head: bool = False) -> Dict:
    """Each parameter's placements as a stage takes it (the counterpart of
    ``_pipeline_specs``): the rules' placements, whole over dp (the
    pipeline is manual over dp and pp, where the rules split only the batch
    and the layer stack), and under 1F1B the head's vocabulary split over
    pp as well, each stage its own block of columns (``:104-108``)."""
    names = mesh.mesh_dim_names

    def fix(placements, key):
        out = [Replicate() if n == "dp" else p
               for n, p in zip(names, placements)]
        if key == "lm_head" and vocab_parallel_head and "pp" in names:
            out[names.index("pp")] = Shard(1)
        return tuple(out)

    specs = shardings_for(mesh, rules, param_logical_axes(config))
    return {k: (tree_map(lambda pl: fix(pl, k), v) if isinstance(v, dict)
                else fix(v, k)) for k, v in specs.items()}


def _grad_placements(target, mesh, whole_on_tp: bool) -> Tuple:
    """Where a stage's gradient of a parameter taken as ``target`` lies: a
    shard over dp or pp stays a shard, a whole placement there becomes a
    partial sum (each rank's own part); over tp it lies as the parameter
    does when the stage's DTensors made it whole (``whole_on_tp``), else a
    whole placement is a partial sum too."""
    out = []
    for name, p in zip(mesh.mesh_dim_names, target):
        if isinstance(p, Shard) or (name == "tp" and whole_on_tp):
            out.append(p)
        else:
            out.append(Partial())
    return tuple(out)


class _Stage:
    """This rank's place in the pipeline: its stage p of pp, the pp and tp
    axes, and the tp sub-mesh that its stage's DTensors live on (None
    without a tp axis, when the stage runs on plain tensors)."""

    def __init__(self, mesh, config: TransformerConfig):
        self.mesh, self.c = mesh, config
        self.pp_axis, self.tp_axis = _Axis(mesh, "pp"), _Axis(mesh, "tp")
        self.p, self.pp = self.pp_axis.index, self.pp_axis.size
        self.tp_mesh = mesh["tp"] if "tp" in mesh.mesh_dim_names else None
        self.attn = (causal_attention if self.tp_mesh is None else
                     functools.partial(attention_per_shard, causal_attention,
                                       mesh=self.tp_mesh))

    def on_tp(self, x: torch.Tensor, placement=Replicate()):
        """A local tensor as a stage computes with it: a DTensor on the tp
        sub-mesh lying as ``placement`` says, or itself without tp."""
        if self.tp_mesh is None:
            return x
        return DTensor.from_local(x, self.tp_mesh, [placement],
                                  run_check=False)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's value, whole over tp, as a local tensor."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.tp_mesh, [Replicate()]).to_local()

    def param_view(self, local: torch.Tensor, target) -> torch.Tensor:
        tp = self.mesh.mesh_dim_names.index("tp") if self.tp_mesh else None
        return local if tp is None else self.on_tp(local, target[tp])

    def ingest(self, embed, tokens: torch.Tensor) -> torch.Tensor:
        """Stage 0's input: the embedding of ``tokens`` [mb, S]."""
        if self.tp_mesh is None:
            return embed[tokens].to(self.c.dtype)
        x = _embedding(embed, self.on_tp(tokens), self.tp_mesh)
        return self.local(x.to(self.c.dtype))

    def run_layers(self, layer: Callable, layers: List[Dict],
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stage's layers on ``x`` [mb, S, d]; (output, summed aux)."""
        x, aux = self.on_tp(x), None
        for lp in layers:
            x, a = layer(x, lp)
            aux = a if aux is None else aux + a
        return self.local(x), self.local(aux)


def _layer_fn(st: _Stage, c: TransformerConfig, positions) -> Callable:
    return remat_wrap(lambda x, lp: apply_layer(x, lp, c, positions, st.attn,
                                                st.tp_mesh), c)


def _local_batch(batch: Dict, mesh, rules: AxisRules):
    """This rank's rows of tokens, targets and mask (ones when absent): the
    batch split over dp, whole over pp and tp. A batch of whole tensors
    (the same on every rank) is cut to this rank's box."""
    _, placements = batch_sharding(mesh, rules)

    def local(v):
        if not isinstance(v, DTensor):
            v = distribute_tensor(v, mesh, placements, src_data_rank=None)
        elif tuple(v.placements) != tuple(placements):
            v = v.redistribute(mesh, placements)
        return v.to_local()

    tokens, targets = local(batch["tokens"]), local(batch["targets"])
    mask = batch.get("mask")
    mask = (torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device) if mask is None else local(mask))
    return tokens, targets, mask


def _flags(device) -> Dict[bool, torch.Tensor]:
    """Boolean scalars for ``torch.where``, made once (a fill, which a CUDA
    graph capture allows)."""
    return {b: torch.full((), b, dtype=torch.bool, device=device)
            for b in (False, True)}


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def pipeline_loss_fn(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    config: TransformerConfig,
    mesh,
    num_microbatches: int,
    rules: AxisRules = DEFAULT_RULES,
) -> DTensor:
    """Drop-in replacement for ``models.transformer.loss_fn`` over a mesh
    that runs the layer stack as a pp-stage pipeline (GPipe: every
    microbatch forward, then autograd's backward through the schedule).
    ``params`` lie as ``make_sharded_state(..., mesh=mesh, rules=rules)``
    lays them out; the batch as ``batch_sharding`` splits it, or whole.
    Returns the mean loss as a replicated DTensor."""
    c = config
    pp = axis_size(mesh, "pp")
    for ax in ("sp", "ep"):
        if axis_size(mesh, ax) != 1:
            raise ValueError(
                f"pipeline_loss_fn requires {ax}=1 (got "
                f"{axis_size(mesh, ax)}); sp/ep compose via the GSPMD "
                "(non-pipelined) path")
    if c.n_layers % pp:
        raise ValueError(
            f"pp={pp} must divide n_layers={c.n_layers} (equal stages)")
    if c.attn_impl != "dense":
        raise ValueError("pipeline stages use dense attention (sp=1)")
    M = num_microbatches
    tokens, targets, mask = _local_batch(batch, mesh, rules)
    b, S = tokens.shape
    if b % M:
        raise ValueError(f"local batch {b} not divisible by {M} microbatches")
    mb, d, dev = b // M, c.d_model, tokens.device
    st = _Stage(mesh, c)
    p = st.p

    def view(x: DTensor, target):
        if tuple(x.placements) != target:
            x = x.redistribute(mesh, target)
        grads = _grad_placements(target, mesh, whole_on_tp=True)
        return st.param_view(x.to_local(grad_placements=grads), target)

    prm = _tree_zip(view, params, _stage_placements(c, mesh, rules))
    layers = unbind_layers(prm, c.n_layers // pp)
    layer = _layer_fn(st, c, torch.arange(S, device=dev))
    toks = tokens.reshape(M, mb, S)
    flag = _flags(dev)

    state = torch.zeros((mb, S, d), dtype=c.dtype, device=dev)
    outs = [torch.zeros((mb, S, d), dtype=c.dtype, device=dev)] * M
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(M + pp - 1):
        mb_idx = t - p  # the microbatch this stage handles at tick t
        active = 0 <= mb_idx < M
        # stage 0 ingests microbatch t from the embedding
        x_in = torch.where(flag[p == 0], st.ingest(prm["embed"],
                                                   toks[min(t, M - 1)]),
                           state)
        x_out, aux = st.run_layers(layer, layers, x_in)
        # the last stage stashes its finished microbatch; scoring runs once
        # after the schedule
        idx = min(max(mb_idx, 0), M - 1)
        outs[idx] = torch.where(flag[active and p == pp - 1], x_out,
                                outs[idx])
        aux_sum = aux_sum + torch.where(flag[active], aux, 0.0)
        state = ppermute(x_out, st.pp_axis, 1)  # one stage forward

    # Score every microbatch in one projection: only the last stage's
    # buffer holds outputs, the other stages' parts are masked.
    x = st.on_tp(torch.stack(outs).reshape(b, S, d))
    logits = lm_head(prm, x, c)
    if st.tp_mesh is None:
        ll = _target_log_probs(logits, targets)
    else:
        whole = (Replicate(),)
        ll = local_map(_target_log_probs, out_placements=(whole,),
                       in_placements=(whole, whole), device_mesh=st.tp_mesh,
                       redistribute_inputs=True)(
            logits, st.on_tp(targets)).to_local()
    is_last = float(p == pp - 1)
    loss_sum = _sum_over_stages(-(ll * mask).sum() * is_last, mesh)
    count = _sum_over_stages(mask.sum() * is_last, mesh)
    ce = loss_sum / torch.clamp(count, min=1.0)
    if c.moe_experts:
        aux = _sum_over_stages(aux_sum, mesh)
        den = c.n_layers * M * axis_size(mesh, "dp")
        ce = ce + c.moe_aux_weight * aux / den
    return ce


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def pipeline_grads_1f1b(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    config: TransformerConfig,
    mesh,
    num_microbatches: int,
    rules: AxisRules = DEFAULT_RULES,
) -> Tuple[DTensor, Dict]:
    """Interleaved (1F1B-style) pipeline: returns ``(loss, grads)`` with a
    hand-written backward. Each tick runs one forward and one backward
    microbatch per stage; the backward recomputes the stage forward from a
    ring buffer of stage inputs, so a stage holds the ring (2·pp blocks of
    [mb, S, d]) in flight whatever M is.

    Schedule (stage p at tick t, M + 2·pp - 2 ticks):
      forward microbatch  f = t - p
      score microbatch    s = t - (pp - 1), the same on every stage
      backward microbatch b = t - (2·(pp - 1) - p)
    so the last stage backs up a microbatch in the tick that forwards it,
    and its gradient ripples to stage 0 over pp - 1 reverse hops.

    Scoring is vocab-parallel: the last stage's output for a microbatch is
    broadcast over pp, and each rank projects only its own block of the
    head's columns (over pp, and within that over tp) with a global
    logsumexp cross-entropy. The grads are accumulated in fp32 and returned
    as DTensors (module docstring); the loss as a replicated DTensor."""
    c = config
    pp = axis_size(mesh, "pp")
    for ax in ("sp", "ep"):
        if axis_size(mesh, ax) != 1:
            raise ValueError(f"1F1B pipeline requires {ax}=1")
    if c.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={c.n_layers}")
    if c.vocab_size % pp:
        raise ValueError(
            f"pp={pp} must divide vocab_size={c.vocab_size} "
            "(vocab-parallel scoring)")
    if c.attn_impl != "dense":
        raise ValueError("pipeline stages use dense attention (sp=1)")
    if c.moe_experts:
        raise ValueError("1F1B pipeline does not support MoE aux losses")
    if c.tie_embeddings:
        raise ValueError(
            "1F1B vocab-parallel scoring needs an untied lm_head "
            "(the embedding must stay whole for stage-0 ingestion); "
            "use the GPipe schedule for tied-embedding models")
    M = num_microbatches
    W = 2 * pp  # ring slots: an input lives at most 2·(pp - 1) ticks
    tokens, targets, mask = _local_batch(batch, mesh, rules)
    b, S = tokens.shape
    if b % M:
        raise ValueError(f"local batch {b} not divisible by {M} microbatches")
    mb, d, dev = b // M, c.d_model, tokens.device
    st = _Stage(mesh, c)
    p, is_last = st.p, st.p == pp - 1
    vocab_axes = (st.tp_axis, st.pp_axis)
    toks = tokens.reshape(M, mb, S)
    tgts = targets.reshape(M, mb, S)
    msks = mask.reshape(M, mb, S)

    # Each parameter as this rank's leaf (the autograd.grad inputs), and as
    # the stage computes with it.
    targets_pl = _stage_placements(c, mesh, rules, vocab_parallel_head=True)

    def leaf(x: DTensor, target):
        if tuple(x.placements) != target:
            x = x.redistribute(mesh, target)
        return x.to_local().detach().requires_grad_(True)

    with torch.no_grad():
        leaves = _tree_zip(leaf, params, targets_pl)
    embed = st.param_view(leaves["embed"], targets_pl["embed"])
    stacked = _tree_zip(st.param_view, leaves["layers"], targets_pl["layers"])
    stage_inputs = [leaves["embed"], *tree_leaves(leaves["layers"])]
    final, head = leaves["final_ln"]["scale"], leaves["lm_head"]
    lo, hi = local_box(mesh, params["lm_head"].shape,
                       targets_pl["lm_head"])[1]  # this rank's columns
    layer = _layer_fn(st, c, torch.arange(S, device=dev))
    flag = _flags(dev)

    def stage_fn(x_act, idx):
        """One stage's forward for microbatch ``idx``: ingestion on stage
        0 and the local layers. No scoring here (``score_fn``)."""
        x_in = torch.where(flag[p == 0], st.ingest(embed, toks[idx]), x_act)
        return st.run_layers(layer, unbind_layers({"layers": stacked},
                                                  c.n_layers // pp), x_in)[0]

    def score_fn(x_fin, idx):
        """Vocab-parallel cross-entropy of microbatch ``idx`` on x_fin (the
        last stage's output, on every rank): this rank's columns of the
        head, and the logsumexp and target pieces summed over the vocab's
        axes. Returns the global (replicated) loss sum and count."""
        xl = _rms_norm(x_fin, final)
        logits = torch.einsum("msd,dv->msv", xl,
                              head.to(c.dtype)).float()
        gmax = _pmax_sg(logits.amax(-1), vocab_axes)  # [mb, S]
        denom = _psum(torch.exp(logits - gmax[..., None]).sum(-1),
                      vocab_axes)
        loc = tgts[idx].long() - lo
        inrange = (loc >= 0) & (loc < hi - lo)
        pick = logits.gather(-1, loc.clamp(0, hi - lo - 1)[..., None])[..., 0]
        tgt_logit = _psum(torch.where(inrange, pick, 0.0), vocab_axes)
        ll = tgt_logit - (gmax + torch.log(denom))
        mk = msks[idx]
        return -(ll * mk).sum(), mk.sum()

    zeros = torch.zeros((mb, S, d), dtype=c.dtype, device=dev)
    act_in, g_in, ring = zeros, zeros, [zeros] * W
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=dev), leaves)
    acc_stage = [acc["embed"], *tree_leaves(acc["layers"])]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.float32, device=dev)
    # psum's transpose sums the replicated cotangents over the vocab's axes,
    # so a unit seed on every rank would inflate the score grads by their
    # size
    seed_on = 1.0 / (st.pp_axis.size * st.tp_axis.size)
    for t in range(M + 2 * pp - 2):
        # ---- forward slot ----
        f = t - p
        fidx = min(max(f, 0), M - 1)
        with torch.no_grad():
            x_out = stage_fn(act_in, fidx)
        if 0 <= f < M:
            ring[fidx % W] = act_in
        # ---- score slot, the same microbatch on every stage: the one whose
        # last-stage output was just made, which is also the last stage's
        # backward microbatch in this tick ----
        s = t - (pp - 1)
        s_act = 0 <= s < M
        xf = st.pp_axis.broadcast(x_out, pp - 1).detach().requires_grad_()
        with torch.enable_grad():
            lsum, cnt = score_fn(xf, min(max(s, 0), M - 1))
            seed = torch.full((), seed_on if s_act else 0.0, device=dev)
            g_final, g_head, dxf = torch.autograd.grad(
                lsum, (final, head, xf), seed)
        if s_act and is_last:  # the loss is replicated: kept on one stage
            loss_sum = loss_sum + lsum.detach()
            count = count + cnt
        acc["final_ln"]["scale"] += g_final
        acc["lm_head"] += g_head
        # dL/dx_final: every rank's columns contribute
        for axis in vocab_axes:
            dxf = axis.all_reduce(dxf.float())
        dxf = dxf.to(c.dtype)
        # ---- backward slot ----
        bmb = t - (2 * (pp - 1) - p)
        bidx = min(max(bmb, 0), M - 1)
        rx = ring[bidx % W].detach().requires_grad_(True)
        with torch.enable_grad():
            out = stage_fn(rx, bidx)
            cot = ((dxf if is_last else g_in) if 0 <= bmb < M
                   else torch.zeros_like(dxf))
            *g_stage, gx = torch.autograd.grad(out, (*stage_inputs, rx), cot)
        for a, g in zip(acc_stage, g_stage):
            a += g
        # ---- rotate: activations forward, grads backward ----
        act_in = st.pp_axis.shift(x_out, 1)
        g_in = st.pp_axis.shift(gx.to(c.dtype), -1)

    total = _sum_over_stages(loss_sum, mesh)
    n = torch.clamp(_sum_over_stages(count, mesh), min=1.0)
    n_local = n.to_local()

    def finalize(a, pair, from_score):
        x, target = pair
        g = (a / n_local).to(x.dtype)
        pl = _grad_placements(target, mesh, whole_on_tp=not from_score)
        return DTensor.from_local(g, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    grads = {key: _tree_zip(
        functools.partial(finalize, from_score=key in ("final_ln", "lm_head")),
        acc[key], _tree_zip(lambda x, t: (x, t), params[key], targets_pl[key]))
        for key in params}
    return total / n, grads


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def make_pipeline_train_step(
    config: TransformerConfig,
    optimizer: ClippedAdamW,
    num_microbatches: int,
    *,
    mesh,
    state_shardings=None,
    rules: AxisRules = DEFAULT_RULES,
    schedule: str = "gpipe",
) -> TrainStep:
    """Pipelined twin of ``train_step.make_train_step`` over ``mesh``, the
    same step contract: ``schedule="gpipe"`` differentiates the forward
    schedule by autograd (``loss=``); ``schedule="1f1b"`` uses the
    interleaved hand-written backward (``grads_fn=``; bounded activation
    memory, see ``pipeline_grads_1f1b``). On CUDA the step runs as one
    captured program, as every step of ``make_train_step`` does."""
    if schedule == "gpipe":
        return make_train_step(
            config, optimizer,
            loss=functools.partial(pipeline_loss_fn,
                                   num_microbatches=num_microbatches,
                                   rules=rules),
            mesh=mesh, state_shardings=state_shardings, rules=rules)
    if schedule != "1f1b":
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    return make_train_step(
        config, optimizer,
        grads_fn=lambda params, batch: pipeline_grads_1f1b(
            params, batch, config, mesh, num_microbatches, rules),
        mesh=mesh, state_shardings=state_shardings, rules=rules)
