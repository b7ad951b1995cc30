"""Policy/value networks for the RLlib port: plain functions on a tree of
tensors (PyTorch port of ``ray_tpu/rllib/models.py``).

Parity role: reference ``rllib/core/rl_module/rl_module.py:229`` (the
policy+value module abstraction) specialized to an MLP actor-critic. The
parameter tree is the JAX package's: ``{"pi": tower, "vf": tower}`` or
``{"q": tower}``, a tower a list of ``{"w": [in, out], "b": [out]}``
layers so that ``x @ w + b`` matches, and weights cross between the
packages as numpy through ``models/convert.py``. JAX's random streams do
not port: init draws from a ``torch.Generator`` on the CPU at the
reference's scales, so one seed gives the same weights on every device.

Also here: the tree helpers the learners share (dicts and lists of
tensors) and one optimizer step on a loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

GeneratorLike = Union[int, torch.Generator]


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, val) for val in tree]
    return fn(tree)


def tree_leaves(tree) -> List:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [leaf for val in tree.values() for leaf in tree_leaves(val)]
    if isinstance(tree, list):
        return [leaf for val in tree for leaf in tree_leaves(val)]
    return [tree]


def generator(seed: GeneratorLike) -> torch.Generator:
    """A CPU generator seeded with ``seed`` (or ``seed`` itself)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def _tensor(a) -> torch.Tensor:
    """A host array as a tensor; a read-only one (an object store's
    pages) is copied, a writable one is shared."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A dict of host arrays -> tensors on ``device`` (one copy each)."""
    return {k: _tensor(v).to(device) for k, v in batch.items()}


def host_tree(tree):
    """A copy of a tree of tensors or arrays as numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy()
                    if isinstance(t, torch.Tensor) else np.array(t), tree)


def trainable(tree, device: torch.device):
    """A fresh copy of ``tree`` on ``device`` whose leaves take gradients."""
    return tree_map(
        lambda t: (t.detach() if isinstance(t, torch.Tensor) else _tensor(t))
        .to(device).clone().requires_grad_(True), tree)


def adam(tree, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart over every leaf of ``tree`` (the same
    betas, 0.9 and 0.999, and eps, 1e-8)."""
    return torch.optim.Adam(tree_leaves(tree), lr=lr)


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]) -> List:
    """``loss``'s gradient for each of ``params``; zeros for a parameter the
    loss does not reach (JAX gives every leaf a gradient, so Adam steps it:
    its moments decay, and it moves once they are not zero)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def sgd_step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One optimizer step on ``loss``'s gradients (``grads_of``)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p, g in zip(params, grads_of(loss, params)):
        p.grad = g
    opt.step()


def _mlp_params(gen: torch.Generator, dims, head_dim, head_scale):
    layers = []
    for i in range(len(dims) - 1):
        layers.append({
            "w": torch.randn(dims[i], dims[i + 1], generator=gen)
            * (2.0 / dims[i]) ** 0.5,
            "b": torch.zeros(dims[i + 1]),
        })
    layers.append({
        "w": torch.randn(dims[-1], head_dim, generator=gen) * head_scale,
        "b": torch.zeros(head_dim),
    })
    return layers


def _mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def _on(tree, device: DeviceLike):
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)


def init_actor_critic(rng: GeneratorLike, obs_dim: int, num_actions: int,
                      hidden: Sequence[int] = (64, 64),
                      device: DeviceLike = None) -> Dict:
    """Separate actor and critic towers (reference PPO default,
    vf_share_layers=False — a shared trunk lets the large value-loss
    gradients distort the policy), on ``device`` (CUDA by default)."""
    gen = generator(rng)
    dims = [obs_dim, *hidden]
    return _on({
        "pi": _mlp_params(gen, dims, num_actions, 0.01),
        "vf": _mlp_params(gen, dims, 1, 1.0),
    }, device)


def apply_actor_critic(params: Dict, obs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    logits = _mlp_apply(params["pi"], obs)
    value = _mlp_apply(params["vf"], obs)[..., 0]
    return logits, value


def init_q_network(rng: GeneratorLike, obs_dim: int, num_actions: int,
                   hidden: Sequence[int] = (64, 64),
                   device: DeviceLike = None) -> Dict:
    """Q-network for DQN (reference rllib/algorithms/dqn catalog MLP)."""
    return _on({"q": _mlp_params(generator(rng), [obs_dim, *hidden],
                                 num_actions, 0.01)}, device)


def apply_q_network(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    """obs [B, obs_dim] -> Q-values [B, A]."""
    return _mlp_apply(params["q"], obs)
