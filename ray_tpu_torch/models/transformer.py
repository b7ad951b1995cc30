"""Flagship decoder-only transformer LM (PyTorch port).

Port of ``ray_tpu/models/transformer.py``: the same configuration presets and
the same parameter tree (dict keys, stacked ``[L, ...]`` shapes), so weights
move between the two packages as numpy arrays (``models/convert.py``). The
model is plain functions on tensors over that tree:

- a Python loop over the stacked L axis in place of ``lax.scan``;
- the GPT-J parallel block, rotary embeddings, RMSNorm, optional GQA;
- attention pluggable: ``dense`` (``ops/attention.py``), ``flash`` (the
  hand-written CUDA kernels of ``ops/flash_attention.py``, forward and
  backward), and over a mesh with the sequence split over sp, ``ring``
  (``ops/ring_attention.py``) or ``ulysses`` (``ops/ulysses_attention.py``,
  dense per rank, as the reference's model runs it);
- an optional mixture-of-experts FFN (``moe_experts`` > 0,
  ``ops/moe.py``), whose Switch aux loss ``loss_fn`` adds;
- ``remat_wrap``: each layer under ``torch.utils.checkpoint`` with the
  reference's policies ("full", "dots", "dots_attn").

Gradients flow through ``forward`` and ``loss_fn`` by autograd.

Under a mesh (``parallel/mesh.py``) the same functions run over DTensors:
the parameters carry the placements of ``param_logical_axes`` and the batch
is split over the batch axes, and DTensor's sharding propagation places
every op, as GSPMD places the reference's. Four things differ from the
one-device path: the embedding is gathered per shard, vocab-parallel
(``_embedding``; DTensor's own rule for ``F.embedding`` gives a masked
partial sum whose backward torch 2.11 cannot redistribute), the rotary
tables are replicated DTensors (DTensor refuses plain tensors beside
DTensors), the loss's log-softmax and target gather run per shard
(over DTensors, gather's backward would copy the [B, S, V] fp32 zeros), and
so do the weight products (``_product_per_shard``: over DTensors an einsum
flattens the token dims, which torch 2.11 refuses with the sequence split).
Attention runs per shard (``flash_attention_sharded``, or the dense
attention through ``attention_per_shard``; ring and Ulysses keep the
sequence split over sp, and each shard's rotary tables are its own global
positions' slice of the replicated ones), and so does the MoE FFN, with its
expert all-to-alls over ep. Over a mesh with pp > 1 the layer stack lies
split over pp, and each layer's weights are made whole over pp just before
the layer runs (``parallel/pipeline.py`` ``layers_whole``), as the
reference's GSPMD gathers them; the pipeline schedules themselves are
``parallel/pipeline.py``'s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention_per_shard, causal_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None => MHA
    d_head: int = 64
    d_ff: int = 2048
    rotary_dim: int = 32
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "dense"  # dense | ring | ulysses | flash
    # Mixture-of-experts FFN (0 = dense MLP); experts lie over the ep axis.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    remat: bool = False
    remat_policy: str = "dots"
    tie_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def param_count(self) -> int:
        d, f, h, kv, dh = (
            self.d_model,
            self.d_ff,
            self.n_heads,
            self.kv_heads,
            self.d_head,
        )
        if self.moe_experts:
            ffn = d * self.moe_experts + 2 * self.moe_experts * d * f
        else:
            ffn = 2 * d * f
        per_layer = d * dh * (h + 2 * kv) + h * dh * d + ffn + d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        return self.vocab_size * d + self.n_layers * per_layer + d + head

    # ---- canonical sizes (the same as the JAX package's) ----
    @staticmethod
    def gptj_6b() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=50432, d_model=4096, n_layers=28, n_heads=16,
            d_head=256, d_ff=16384, rotary_dim=64, max_seq_len=2048,
        )

    @staticmethod
    def small_1b() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
            d_head=128, d_ff=8192, rotary_dim=64, max_seq_len=2048,
        )

    @staticmethod
    def bench_400m() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=32000, d_model=1024, n_layers=24, n_heads=8,
            d_head=128, d_ff=4096, rotary_dim=64, max_seq_len=2048,
            attn_impl="flash", remat=True, remat_policy="dots",
        )

    @staticmethod
    def serve_7b() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            d_head=128, d_ff=16384, rotary_dim=128, max_seq_len=2048,
            attn_impl="dense", remat=False,
        )

    @staticmethod
    def tiny(**kw) -> "TransformerConfig":
        base = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            d_head=16, d_ff=128, rotary_dim=8, max_seq_len=128,
        )
        base.update(kw)
        return TransformerConfig(**base)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """Applies ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List:
    """The leaves of a tree of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for val in tree.values() for leaf in tree_leaves(val)]
    return [tree]


def layer_params(params: Dict, i: int) -> Dict:
    """ONE layer's params (no leading L dim) from the stacked tree."""
    return tree_map(lambda x: x[i], params["layers"])


def unbind_layers(params: Dict, n_layers: int) -> List[Dict]:
    """Every layer's params, from one ``unbind`` per stacked leaf: its
    backward stacks the L layer grads once, where ``x[i]`` per layer would
    materialize a full-size zero grad for each layer."""
    per_leaf = tree_map(lambda x: x.unbind(0), params["layers"])
    return [tree_map(lambda xs: xs[i], per_leaf) for i in range(n_layers)]


def init_params(config: TransformerConfig, seed: int,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX package's tree and shapes (the values
    differ: parity goes through weight transfer)."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = c.param_dtype

    def normal(shape, std):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * std).to(pd)

    def dense_init(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    L = c.n_layers
    layers = {
        "ln1": {"scale": torch.ones((L, c.d_model), dtype=pd, device=dev)},
        "attn": {
            "wq": dense_init((L, c.d_model, c.n_heads, c.d_head), c.d_model),
            "wk": dense_init((L, c.d_model, c.kv_heads, c.d_head), c.d_model),
            "wv": dense_init((L, c.d_model, c.kv_heads, c.d_head), c.d_model),
            "wo": dense_init((L, c.n_heads, c.d_head, c.d_model),
                             c.n_heads * c.d_head),
        },
    }
    if c.moe_experts:
        E = c.moe_experts
        layers["moe"] = {
            "router": dense_init((L, c.d_model, E), c.d_model),
            "wi": dense_init((L, E, c.d_model, c.d_ff), c.d_model),
            "wo": dense_init((L, E, c.d_ff, c.d_model), c.d_ff),
        }
    else:
        layers["mlp"] = {
            "wi": dense_init((L, c.d_model, c.d_ff), c.d_model),
            "wo": dense_init((L, c.d_ff, c.d_model), c.d_ff),
        }
    params = {
        "embed": normal((c.vocab_size, c.d_model), 0.02),
        "layers": layers,
        "final_ln": {"scale": torch.ones((c.d_model,), dtype=pd, device=dev)},
    }
    if not c.tie_embeddings:
        params["lm_head"] = dense_init((c.d_model, c.vocab_size), c.d_model)
    return params


def param_logical_axes(config: TransformerConfig) -> Dict:
    """Same-structure tree of logical axis-name tuples (None = no sharding)."""
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {
            "ln1": {"scale": ("layers", "embed")},
            "attn": {
                "wq": ("layers", "embed", "heads", "head_dim"),
                "wk": ("layers", "embed", "kv_heads", "head_dim"),
                "wv": ("layers", "embed", "kv_heads", "head_dim"),
                "wo": ("layers", "heads", "head_dim", "embed"),
            },
        },
        "final_ln": {"scale": ("embed",)},
    }
    if config.moe_experts:
        axes["layers"]["moe"] = {
            "router": ("layers", "embed", "experts"),
            "wi": ("layers", "experts", "embed", "mlp"),
            "wo": ("layers", "experts", "mlp", "embed"),
        }
    else:
        axes["layers"]["mlp"] = {
            "wi": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed"),
        }
    if not config.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rotary(q, k, rotary_dim, positions):
    """Apply rotary embeddings to the first `rotary_dim` dims of q/k.

    q/k: [B, S, H, D]; positions: [S] global token positions, or [B, S]
    per-sequence positions (continuous-batching decode, where slots sit at
    different depths).
    """
    d2 = rotary_dim // 2
    inv_freq = 1.0 / (
        10000.0 ** (torch.arange(0, d2, device=q.device) / d2)
    )
    freqs = positions[..., None].float() * inv_freq  # [S,d2] or [B,S,d2]
    if positions.dim() == 1:
        cos = torch.cos(freqs)[None, :, None, :]
        sin = torch.sin(freqs)[None, :, None, :]
    else:
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]
    cos, sin = _like(q, cos), _like(q, sin)

    def rot(x):
        xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
        x1, x2 = xr[..., :d2], xr[..., d2:]
        xr = torch.cat(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
        ).to(x.dtype)
        return torch.cat([xr, xp], dim=-1)

    return rot(q), rot(k)


def _embedding(table, tokens, mesh):
    """``table[tokens]`` over a mesh, vocab-parallel, as a DTensor that lies
    as ``tokens`` do. Each rank indexes its own rows of the table (made
    whole over every axis but the vocabulary's), ids outside them give
    zeros, and the partial sums are reduced over the vocabulary's axes.
    The table's gradient is a partial sum over the axes that split the
    tokens, which the train step reduces. A table whole on every axis is
    indexed as on one device."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ray_tpu_torch.parallel.mesh import local_box

    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    if any(v and not p.is_replicate()
           for v, p in zip(vocab, tokens.placements)):
        raise ValueError("the tokens may not be split over the vocabulary's "
                         "mesh axes")
    rows = [Shard(0) if v else Replicate() for v in vocab]
    grads = [Shard(0) if v else Replicate() if p.is_replicate() else Partial()
             for v, p in zip(vocab, tokens.placements)]
    out = [Partial() if v else p for v, p in zip(vocab, tokens.placements)]
    lo, hi = local_box(mesh, table.shape, rows)[0]

    def lookup(ids, tab):
        if not any(vocab):
            return tab[ids]
        inside = (ids >= lo) & (ids < hi)
        got = tab[torch.where(inside, ids - lo, 0)]
        return got * inside[..., None].to(got.dtype)

    x = local_map(lookup, out_placements=(out,),
                  in_placements=(tuple(tokens.placements), rows),
                  in_grad_placements=(tuple(tokens.placements), grads),
                  device_mesh=mesh,
                  redistribute_inputs=True)(tokens, table)
    return x.redistribute(mesh, tokens.placements)


def _like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, the same on every rank, as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor; else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def select_attn_fn(config: TransformerConfig, mesh=None):
    c = config
    if c.attn_impl == "ring":
        if mesh is None:
            raise ValueError("ring attention needs a mesh")
        from ray_tpu_torch.ops.ring_attention import ring_attention

        return functools.partial(ring_attention, mesh=mesh)
    if c.attn_impl == "ulysses":
        if mesh is None:
            raise ValueError("ulysses attention needs a mesh")
        from ray_tpu_torch.ops.ulysses_attention import ulysses_attention

        return functools.partial(ulysses_attention, mesh=mesh)
    if c.attn_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import (
            flash_attention,
            flash_attention_sharded,
        )

        # The kernels see plain tensors: under a mesh they run per shard
        # (batch over dp, heads over tp), as the reference's shard_map does.
        if mesh is not None:
            return functools.partial(flash_attention_sharded, mesh=mesh)
        return flash_attention
    if c.attn_impl == "dense":
        if mesh is not None:
            return functools.partial(attention_per_shard, causal_attention,
                                     mesh=mesh)
        return causal_attention
    raise ValueError(f"unknown attn_impl {c.attn_impl!r}")


def _weight_product(spec: str, x: torch.Tensor, w, dtype,
                    contract: int = 1) -> torch.Tensor:
    """One of a layer's weight einsums, x's last ``contract`` dims against
    w's first. A tensor weight is cast to the compute dtype and goes
    through ``einsum`` (training, autograd and remat see exactly that); an
    int8 ``QTensor`` (``models/quant.py``) goes through its kernel product,
    ``QTensor.matmul``. Over a mesh the einsum runs per shard
    (``_product_per_shard``)."""
    if isinstance(x, DTensor):
        return _product_per_shard(spec, x, w, dtype, contract)
    if isinstance(w, torch.Tensor):
        return torch.einsum(spec, x, w.to(dtype))
    return w.matmul(x, contract)


def _product_per_shard(spec: str, x, w, dtype, contract: int):
    """``einsum(spec, x, w)`` of DTensors on each rank's shard, through
    ``local_map``. Over DTensors the einsum flattens x's token dims into
    one, which torch 2.11 refuses when the sequence dim is split (over sp);
    per shard nothing is flattened across ranks. Mesh axis by mesh axis:
    where x's token dims are split, w is gathered and the output is split
    alike (w's gradient a partial sum); where w splits a contracted dim (tp
    over heads or F), x is split alike and the output is a partial sum;
    where w splits an output dim, x is whole and x's gradient a partial
    sum; elsewhere everything is whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    n_tok = x.ndim - contract
    xs, ws, outs, x_grads, w_grads = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < n_tok:
            row = (xp, Replicate(), xp, xp, Partial())
        elif isinstance(wp, Shard) and wp.dim < contract:
            split = Shard(n_tok + wp.dim)
            row = (split, wp, Partial(), split, wp)
        elif isinstance(wp, Shard):
            row = (Replicate(), wp, Shard(wp.dim - contract + n_tok),
                   Partial(), wp)
        else:
            row = (Replicate(),) * 5
        for acc, placement in zip((xs, ws, outs, x_grads, w_grads), row):
            acc.append(placement)
    return local_map(
        lambda xl, wl: torch.einsum(spec, xl, wl.to(dtype)),
        out_placements=(tuple(outs),),
        in_placements=(tuple(xs), tuple(ws)),
        in_grad_placements=(tuple(x_grads), tuple(w_grads)),
        device_mesh=x.device_mesh, redistribute_inputs=True)(x, w)


def apply_layer(
    x: torch.Tensor,  # [B, S, D]
    lp: Dict,  # ONE layer's params (no leading L dim)
    config: TransformerConfig,
    positions: torch.Tensor,
    attn_fn,
    mesh=None,
):
    """GPT-J parallel block: y = x + attn(ln(x)) + ffn(ln(x)).

    Shared by the forward below and the KV-cached generation path
    (models/generation.py). ``attn_fn(q, k, v)`` returns the attention
    output [B, S, H, D]. The FFN is the MoE FFN (``ops/moe.py``, over
    ``mesh`` when given) when ``moe_experts`` is set, else the dense MLP.
    Returns (y, aux_loss): the MoE's Switch aux, or 0."""
    c = config
    h = _rms_norm(x, lp["ln1"]["scale"])
    q = _weight_product("bsd,dhk->bshk", h, lp["attn"]["wq"], c.dtype)
    k = _weight_product("bsd,dhk->bshk", h, lp["attn"]["wk"], c.dtype)
    v = _weight_product("bsd,dhk->bshk", h, lp["attn"]["wv"], c.dtype)
    q, k = _rotary(q, k, c.rotary_dim, positions)
    attn_out = attn_fn(q, k, v)
    if c.remat and c.remat_policy == "dots_attn":
        # The policy saves it by this name; no other policy needs the copy.
        attn_out = checkpoint_name(attn_out, "attn_out")
    a = _weight_product("bshk,hkd->bsd", attn_out, lp["attn"]["wo"],
                        c.dtype, contract=2)
    if c.moe_experts:
        from ray_tpu_torch.ops.moe import moe_ffn

        m, aux = moe_ffn(h, lp["moe"]["router"], lp["moe"]["wi"],
                         lp["moe"]["wo"], top_k=c.moe_top_k,
                         capacity_factor=c.moe_capacity_factor, mesh=mesh)
        return x + a + m, aux
    m = _weight_product("bsd,df->bsf", h, lp["mlp"]["wi"], c.dtype)
    m = F.gelu(m, approximate="tanh")  # jax.nn.gelu's default
    m = _weight_product("bsf,fd->bsd", m, lp["mlp"]["wo"], c.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + a + m, aux


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """The counterpart of ``jax.ad_checkpoint.checkpoint_name``: a copy of
    ``x`` that a selective-checkpoint policy can recognise by ``name``. An op
    of its own, since a policy sees ops, not values (a custom op may not
    return its input, hence the copy)."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

_aten = torch.ops.aten


def _saves_dots(op, args) -> bool:
    """The counterpart of ``dots_with_no_batch_dims_saveable``: a matrix
    product without batch dims. The einsums of a layer's projections lower
    to ``mm`` or to ``bmm`` over a batch of 1; the attention einsums (batch
    and heads) to ``bmm`` over B * H."""
    if op in (_aten.mm.default, _aten.addmm.default):
        return True
    return op is _aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    if _saves_dots(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_attn_policy(ctx, op, *args, **kwargs):
    if _saves_dots(op, args) or (
            op is torch.ops.ray_tpu_torch.checkpoint_name.default
            and args[1] == "attn_out"):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(layer_fn: Callable, config: TransformerConfig) -> Callable:
    """``layer_fn`` under ``torch.utils.checkpoint`` as ``remat_policy``
    says: "full" saves nothing; "dots" saves matrix products without batch
    dims (elementwise work is recomputed); "dots_attn" also saves the
    attention output. As in the reference, the flash custom-vjp's residuals
    (o, lse) are saved by none of them, so the forward kernel runs again in
    the backward under every policy.

    The RNG state is not saved for the recompute (``preserve_rng_state=
    False``): the model draws no random numbers (no dropout), so the values
    are the same, and a CUDA graph capture of the step may not read the
    generator's state."""
    if not config.remat:
        return layer_fn
    if config.remat_policy == "full":
        context_fn = None
    elif config.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    elif config.remat_policy == "dots_attn":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_attn_policy)
    else:
        raise ValueError(f"unknown remat_policy {config.remat_policy!r}")
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def wrapped(*args):
        if not torch.is_grad_enabled():  # nothing to save for a backward
            return layer_fn(*args)
        return checkpoint(layer_fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped


def lm_head(params: Dict, x: torch.Tensor, config: TransformerConfig):
    """Final norm and vocabulary projection: x [..., D] -> logits [..., V]."""
    x = _rms_norm(x, params["final_ln"]["scale"])
    head = (params["embed"].T if config.tie_embeddings
            else params["lm_head"])
    return _weight_product("...d,dv->...v", x, head, config.dtype)


def forward(
    params: Dict,
    tokens: torch.Tensor,  # [B, S] integer
    config: TransformerConfig,
    mesh=None,
    return_aux: bool = False,
):
    """Returns logits [B, S, vocab] (and the MoE aux loss if return_aux).

    Under ``mesh`` the params and ``tokens`` are DTensors on it (see the
    module docstring) and so are the logits."""
    c = config
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    attn_fn = select_attn_fn(c, mesh)
    if mesh is not None and "pp" in mesh.mesh_dim_names:
        # The stack lies split over pp: each layer's weights are made whole
        # over pp inside the layer's remat region (``layers_whole``).
        from ray_tpu_torch.parallel.pipeline import layers_whole

        per_layer = layers_whole(params["layers"], c.n_layers, mesh)
        layer = remat_wrap(lambda x, whole: apply_layer(
            x, whole(), c, positions, attn_fn, mesh), c)
    else:
        per_layer = unbind_layers(params, c.n_layers)
        layer = remat_wrap(
            lambda x, lp: apply_layer(x, lp, c, positions, attn_fn, mesh), c)
    if mesh is None:
        x = params["embed"][tokens].to(c.dtype)  # [B, S, D]
    else:
        x = _embedding(params["embed"], tokens, mesh).to(c.dtype)
    aux = None  # a DTensor over a mesh with MoE: no plain zeros beside it
    for lp in per_layer:
        x, a = layer(x, lp)
        aux = a if aux is None else aux + a
    logits = lm_head(params, x, c)
    return (logits, aux) if return_aux else logits


def _target_log_probs(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """log_softmax(logits) at the targets, in fp32: [B, S, V], [B, S] ->
    [B, S]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None].long())[..., 0]


def loss_fn(
    params: Dict,
    batch: Dict[str, torch.Tensor],  # tokens [B,S], targets [B,S], mask [B,S]
    config: TransformerConfig,
    mesh=None,
) -> torch.Tensor:
    logits, aux = forward(params, batch["tokens"], config, mesh,
                          return_aux=True)
    targets = batch["targets"]
    if mesh is None:
        ll = _target_log_probs(logits, targets)
    else:
        # Per shard, the vocabulary whole (gathered first where it is split):
        # as plain tensors, gather's backward scatters in place, where over
        # DTensors it copies the [B, S, V] fp32 zeros first (~1.4 ms a step).
        rows = tuple(targets.placements)
        ll = local_map(_target_log_probs, out_placements=(rows,),
                       in_placements=(rows, rows), device_mesh=mesh,
                       redistribute_inputs=True)(logits, targets)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(ll)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if config.moe_experts:
        ce = ce + config.moe_aux_weight * aux / config.n_layers
    return ce
