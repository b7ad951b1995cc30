"""Train state and train step on one device (PyTorch port).

Port of ``ray_tpu/parallel/train_step.py`` without the mesh: ``TrainState``,
``make_sharded_state`` (:56), ``make_train_step`` (:99) and
``default_optimizer`` (:142). The step takes the loss's gradients by
autograd, clips them by their global norm, and applies AdamW, all on the
card and without a host sync: its metrics stay device tensors.

Where JAX donates the state to the jitted step (``donate_argnums``), the port
updates parameters and optimizer state in place: ``step`` returns the state
it was given. Sharding over a mesh (DP/FSDP/TP) waits for the port's
``parallel/mesh.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
    tree_leaves,
    tree_map,
)


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int32 scalar on the device
    params: Dict
    opt_state: torch.optim.Optimizer


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.95,
    eps=1e-8, weight_decay))``: the grads are scaled by min(1, 1 / ||g||)
    (no epsilon), then AdamW with optax's bias corrections, eps outside the
    sqrt, fp32 moments, and decoupled weight decay on every leaf:
    p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""

    lr: float = 3e-4
    weight_decay: float = 0.01
    B1: ClassVar[float] = 0.9
    B2: ClassVar[float] = 0.95
    EPS: ClassVar[float] = 1e-8
    MAX_NORM: ClassVar[float] = 1.0

    def init(self, params: Dict) -> torch.optim.AdamW:
        # torch's AdamW multiplies p by (1 - lr wd) and then subtracts
        # lr m_hat / (sqrt(v_hat) + eps): the same update as optax's.
        return torch.optim.AdamW(
            tree_leaves(params), lr=self.lr, betas=(self.B1, self.B2),
            eps=self.EPS, weight_decay=self.weight_decay, foreach=True)

    def clip_(self, grads) -> torch.Tensor:
        """Scales ``grads`` in place as ``clip_by_global_norm`` does and
        returns their global norm before clipping."""
        norm = global_norm(grads)
        scale = torch.where(norm < self.MAX_NORM, torch.ones_like(norm),
                            self.MAX_NORM / norm)
        torch._foreach_mul_(grads, scale)
        return norm


def default_optimizer(lr: float = 3e-4,
                      weight_decay: float = 0.01) -> ClippedAdamW:
    return ClippedAdamW(lr=lr, weight_decay=weight_decay)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_sharded_state(
    config: TransformerConfig,
    optimizer: ClippedAdamW,
    seed: int,
    device: Union[DeviceLike, Sequence[DeviceLike]] = None,
    params: Optional[Dict] = None,
) -> Tuple[TrainState, None]:
    """Returns (state, None): params from ``init_params(config, seed)`` or,
    when given, ``params`` (such as the JAX package's, converted by
    ``params_from_numpy``; they are then updated in place), on ``device``
    (CUDA by default), and the optimizer's state. The second value stands
    for the JAX version's state shardings, which one device does not have.
    """
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                f"a train state over {len(device)} devices needs a mesh, "
                "which is not ported yet; pass one device"
            )
        device = device[0]
    dev = resolve_device(device)
    if params is None:
        params = init_params(config, seed, dev)
    params = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                      params)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                       params=params, opt_state=optimizer.init(params))
    return state, None


def make_train_step(
    config: TransformerConfig,
    optimizer: ClippedAdamW,
    loss: Callable = loss_fn,
    grads_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict]]:
    """(state, batch) -> (state, metrics), updating the state in place.

    ``loss(params, batch, config)`` is differentiated by autograd unless
    ``grads_fn(params, batch) -> (loss, grads)`` is given (a schedule with a
    hand-written backward). ``metrics`` = {loss, grad_norm (of the raw
    grads, before clipping), step}, all device tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        if grads_fn is not None:
            loss_val, grads = grads_fn(state.params, batch)
            for p, g in zip(leaves, tree_leaves(grads)):
                p.grad = g
        else:
            loss_val = loss(state.params, batch, config)
            loss_val.backward()
        grad_norm = optimizer.clip_([p.grad for p in leaves])
        state.opt_state.step()
        for p in leaves:
            p.grad = None  # next step's backward starts from no grads
        state.step = state.step + 1
        return state, {"loss": loss_val.detach(), "grad_norm": grad_norm,
                       "step": state.step}

    return step
