"""Moves parameters between the JAX package and the port.

The two packages share one parameter tree (dict keys and stacked ``[L, ...]``
shapes), so weights cross as numpy arrays: ``jax.tree.map(np.asarray,
params)`` on the JAX side, ``params_from_numpy`` here; ``params_to_numpy``
is the way back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import tree_map


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


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """A tree of numpy arrays (the JAX package's parameters) -> the same tree
    of tensors on ``device`` (CUDA by default), dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16 of its own
        t = t.float()
    return t.numpy().copy()


def params_to_numpy(tree: Dict) -> Dict:
    """A tree of tensors -> the same tree of numpy arrays on the host
    (dtypes kept, except bf16, which comes back as the float32 of the same
    values)."""
    return tree_map(_to_numpy, tree)
