"""Moves parameters between the JAX package and the port.

The two packages share one parameter tree (dict keys and stacked ``[L, ...]``
shapes; RLlib's towers are lists of ``{"w", "b"}`` layers), so weights cross
as numpy arrays: ``jax.tree.map(np.asarray, params)`` on the JAX side,
``params_from_numpy`` here; ``params_to_numpy`` is the way back. Both walk
dicts, lists and tuples.

Int8-quantized leaves cross bit-exact as their int8 ``q`` and fp32 ``s``.
On the JAX side ``jax.tree.map(np.asarray, qparams)`` keeps each QTensor,
with numpy children; the port cannot import that class, so
``params_from_numpy`` takes any leaf with numpy ``q`` and ``s`` attributes
for a quantized weight and makes the port's :class:`QTensor` of it.
``params_to_numpy`` gives each back as a :class:`NumpyQTensor` (numpy ``q``
and ``s``), from which the JAX QTensor is rebuilt.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.quant import QTensor


@dataclasses.dataclass
class NumpyQTensor:
    """A quantized weight on the host: int8 ``q`` and fp32 ``s``."""

    q: np.ndarray
    s: np.ndarray


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy the tensor may own
    # JAX's bf16 arrays arrive as ml_dtypes.bfloat16, which torch.from_numpy
    # refuses: cross as the same 16 bits (matched by the dtype's name, so
    # ml_dtypes itself need not be installed here).
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16
        )
    return torch.from_numpy(a)


def _tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_tree_map(fn, val) for val in tree)
    return fn(tree)


def _is_quantized(leaf) -> bool:
    return (isinstance(getattr(leaf, "q", None), np.ndarray)
            and isinstance(getattr(leaf, "s", None), np.ndarray))


def _leaf_from_numpy(leaf, dev: torch.device):
    if _is_quantized(leaf):
        return QTensor(_to_tensor(leaf.q), _to_tensor(leaf.s)).to(dev)
    return _to_tensor(leaf).to(dev)


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """A tree of numpy arrays (the JAX package's parameters) -> the same tree
    of tensors on ``device`` (CUDA by default), dtypes kept; a quantized
    leaf (numpy ``q`` and ``s``) becomes a QTensor."""
    dev = resolve_device(device)
    return _tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16 of its own
        t = t.float()
    return t.numpy().copy()


def _leaf_to_numpy(leaf):
    if isinstance(leaf, QTensor):
        return NumpyQTensor(_to_numpy(leaf.q), _to_numpy(leaf.s))
    return _to_numpy(leaf)


def params_to_numpy(tree: Dict) -> Dict:
    """A tree of tensors -> the same tree of numpy arrays on the host
    (dtypes kept, except bf16, which comes back as the float32 of the same
    values); a QTensor comes back as a NumpyQTensor."""
    return _tree_map(_leaf_to_numpy, tree)
