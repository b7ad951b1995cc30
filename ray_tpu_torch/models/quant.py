"""Int8 weight quantization for serving (weight-only, symmetric
per-output-channel).

Port of ``ray_tpu/models/quant.py``. Weights live on the card as int8 plus
fp32 scales, half the bytes of bf16 at rest; a layer's weight is
dequantized where the model code casts it (``q.to(dtype) * s.to(dtype)``,
the reference's order and rounding).

Design: :class:`QTensor` is one leaf of the parameter tree (the port's tree
helpers treat every non-dict as a leaf) with the surface the model code
touches:

- ``.to(dtype)`` dequantizes: every weight use in ``apply_layer`` and
  ``lm_head`` is already ``w.to(config.dtype)``, so the forward path needs
  no change, as ``.astype`` needs none in the reference;
- ``.to(device)`` moves ``q`` and ``s`` and keeps the QTensor (what
  ``LLMEngine`` and ``params_from_numpy`` do to every leaf); any other
  argument raises, so no call dequantizes by accident;
- ``x[i]`` (``layer_params``) and ``x.unbind(0)`` (``unbind_layers``) slice
  ``q`` and ``s`` together, as ``lax.scan`` slices the pytree's children.

The reference dequantizes inside the consuming matmul's XLA fusion, so its
decode streams the int8 bytes only. Here the dequant is plain tensor ops
before the matmul, which write and read back a bf16 copy of each weight
(no Pallas kernel of the reference's does the dequant; a hand-written
int8 matmul is future work).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import init_params


class QTensor:
    """Symmetric int8 weight ``q`` and a float32 scale ``s`` whose shape
    broadcasts against it."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    # -- the drop-in surface the model code uses --
    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def to(self, arg: Union[torch.dtype, str, torch.device]):
        """A dtype dequantizes; a device moves ``q`` and ``s``."""
        if isinstance(arg, torch.dtype):
            return self.q.to(arg) * self.s.to(arg)
        if isinstance(arg, (str, torch.device)):
            dev = torch.device(arg)
            return QTensor(self.q.to(dev), self.s.to(dev))
        raise TypeError(
            f"QTensor.to takes a dtype (dequantize) or a device (move); got "
            f"{arg!r}"
        )

    @property
    def T(self) -> torch.Tensor:  # tied-embedding head path
        return self.to(torch.bfloat16).T

    def _s_at(self, i: int) -> torch.Tensor:
        # A scale with a leading dim of 1 broadcasts along axis 0.
        return self.s[i if self.s.shape[0] != 1 else 0]

    def __getitem__(self, i: int) -> "QTensor":
        if not isinstance(i, int):
            raise TypeError(f"QTensor takes one integer index; got {i!r}")
        return QTensor(self.q[i], self._s_at(i))

    def unbind(self, dim: int = 0):
        if dim != 0:
            raise ValueError("QTensor unbinds along its leading dim only")
        return tuple(QTensor(q, self._s_at(i))
                     for i, q in enumerate(self.q.unbind(0)))

    def __repr__(self):
        return (f"QTensor(int8 {tuple(self.q.shape)}, scale "
                f"{tuple(self.s.shape)})")


def quantize_tensor(w: torch.Tensor, reduce_axes: Tuple[int, ...]) -> QTensor:
    """Symmetric per-channel quantization: scales keep every axis NOT in
    ``reduce_axes`` (the contracted axes of the consuming matmul)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=reduce_axes, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QTensor(q, s)


# Per-weight contracted axes (leading axis 0 is the stacked layer dim):
#   wq/wk/wv [L, d, h, k]: contract d      -> scales per (h, k)
#   wo       [L, h, k, d]: contract (h, k) -> scales per d
#   mlp wi   [L, d, f]:    contract d      -> scales per f
#   mlp wo   [L, f, d]:    contract f      -> scales per d
#   moe wi   [L, E, d, f]: contract d      -> scales per (E, f)
#   moe wo   [L, E, f, d]: contract f      -> scales per (E, d)
_LAYER_RULES = {
    ("attn", "wq"): (1,),
    ("attn", "wk"): (1,),
    ("attn", "wv"): (1,),
    ("attn", "wo"): (1, 2),
    ("mlp", "wi"): (1,),
    ("mlp", "wo"): (1,),
    ("moe", "wi"): (2,),
    ("moe", "wo"): (2,),
}


def quantize_layer_params(layers: Dict) -> Dict:
    """Quantize one stacked layer tree (norm scales and the MoE router
    stay high-precision: tiny, accuracy-critical)."""
    out = {}
    for group, sub in layers.items():
        out[group] = {}
        for name, w in sub.items():
            axes = _LAYER_RULES.get((group, name))
            out[group][name] = (
                quantize_tensor(w, axes) if axes is not None else w
            )
    return out


def quantize_params_int8(params: Dict) -> Dict:
    """Quantize a full param tree's layer weights. Embedding and lm_head
    stay high-precision (gather/logit accuracy, and together they are <5%
    of a 7B-class model's bytes)."""
    out = dict(params)
    out["layers"] = quantize_layer_params(params["layers"])
    return out


def _fold_seed(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``; the random streams differ, so parity with the
    reference goes through weight conversion)."""
    return (int(seed) * 1_000_003 + int(data)) % (1 << 63)


def layer_seed(seed: int, layer: int) -> int:
    """The seed of layer ``layer``'s weights in ``init_params_by_layer``
    (and so ``init_params_int8``): a one-layer ``init_params`` from it gives
    that layer before ``layer_fn``."""
    return _fold_seed(seed, 1000 + layer)


def _empty_like_stacked(leaf, n: int):
    """An empty [n, ...] buffer for a one-layer [1, ...] leaf."""
    if isinstance(leaf, QTensor):
        return QTensor(_empty_like_stacked(leaf.q, n),
                       _empty_like_stacked(leaf.s, n))
    return torch.empty((n, *leaf.shape[1:]), dtype=leaf.dtype,
                       device=leaf.device)


def _fill(dst, li: int, src) -> None:
    if isinstance(dst, QTensor):
        _fill(dst.q, li, src.q)
        _fill(dst.s, li, src.s)
    elif isinstance(dst, dict):
        for key in dst:
            _fill(dst[key], li, src[key])
    else:
        dst[li:li + 1].copy_(src)


@torch.no_grad()
def init_params_by_layer(config, seed: int, layer_fn: Callable,
                         device: DeviceLike = None) -> Dict:
    """A model initialized one layer at a time: layer ``li`` is a one-layer
    ``init_params`` from ``layer_seed(seed, li)`` (at the config's
    ``param_dtype``) passed through ``layer_fn``, so only one layer exists
    at the init's precision at any time. The stacked leaves are allocated on
    the device once and filled layer by layer (a final concatenation would
    hold two copies at once). Embedding, final norm and lm_head come from
    one more seed derived from ``seed``, as ``init_params`` makes them."""
    c = config
    dev = resolve_device(device)
    one = dataclasses.replace(c, n_layers=1)
    layers = None
    for li in range(c.n_layers):
        layer = layer_fn(
            init_params(one, layer_seed(seed, li), device=dev)["layers"])
        if layers is None:
            layers = {g: {n: _empty_like_stacked(w, c.n_layers)
                          for n, w in sub.items()}
                      for g, sub in layer.items()}
        _fill(layers, li, layer)
        del layer
    params = {
        name: w
        for name, w in init_params(dataclasses.replace(c, n_layers=0),
                                   _fold_seed(seed, 7), device=dev).items()
        if name != "layers"
    }
    params["layers"] = layers
    return params


def init_params_int8(config, seed: int, device: DeviceLike = None) -> Dict:
    """Initialize a model DIRECTLY into int8 layer weights, one layer at a
    time: a 7B-class model at fp32 (~27 GB) or bf16 (~13 GB) never exists
    whole, only one layer of it. ``device=None`` means CUDA."""
    return init_params_by_layer(config, seed, quantize_layer_params, device)
