"""Train state and train step on one device (PyTorch port).

Port of ``ray_tpu/parallel/train_step.py`` without the mesh: ``TrainState``,
``make_sharded_state`` (:56), ``make_train_step`` (:99) and
``default_optimizer`` (:142). The step takes the loss's gradients by
autograd, clips them by their global norm, and applies AdamW, all on the
card and without a host sync: its metrics stay device tensors.

Where JAX donates the state to a jitted step (``donate_argnums``, :133-139),
the port updates parameters, optimizer state and ``step`` in place, and on
CUDA runs the whole step as one captured program: the first call with a
batch of new shapes is a real step run eagerly (the warm-up), the next one
captures a CUDA graph of the step and replays it, and every later call
copies its batch into the graph's static buffers and replays. Sharding over
a mesh (DP/FSDP/TP) waits for the port's ``parallel/mesh.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch import graphs
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
        # lr m_hat / (sqrt(v_hat) + eps): the same update as optax's. On
        # CUDA it is capturable: its step count and bias corrections live on
        # the card, so a CUDA graph of the step can hold them.
        leaves = tree_leaves(params)
        return torch.optim.AdamW(
            leaves, lr=self.lr, betas=(self.B1, self.B2), eps=self.EPS,
            weight_decay=self.weight_decay, foreach=True,
            capturable=all(p.device.type == "cuda" for p in leaves))

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
) -> "TrainStep":
    """(state, batch) -> (state, metrics), updating the state in place.

    ``loss(params, batch, config)`` is differentiated by autograd unless
    ``grads_fn(params, batch) -> (loss, grads)`` is given (a schedule with a
    hand-written backward). ``metrics`` = {loss, grad_norm (of the raw
    grads, before clipping), step}: device tensors of their own at every
    call. On CUDA the step runs as one captured program (``TrainStep``); on
    the CPU it runs eagerly."""

    def body(state: TrainState, batch: Dict[str, torch.Tensor]):
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
        state.step.add_(1)
        return loss_val.detach(), grad_norm

    return TrainStep(body)


@dataclasses.dataclass
class _Program:
    """One captured step: its graph, the static batch buffers it reads, the
    static loss and grad norm it writes, and the hand-written kernels'
    launches it holds (``graphs.Captured.launches``)."""

    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]
    loss: torch.Tensor
    grad_norm: torch.Tensor
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class TrainStep:
    """The step ``make_train_step`` returns: ``step(state, batch)`` runs
    exactly one step on ``state`` and returns (state, metrics).

    A step serves one ``TrainState``, the one of its first call, and raises
    for any other: on CUDA its programs hold that state's memory. On the CPU
    every call runs the step eagerly. On CUDA, per batch signature (keys,
    shapes and dtypes): the first call runs the step eagerly on a side
    stream (the warm-up: it builds the kernels and the optimizer's state);
    the second captures a CUDA graph of the step (capture runs nothing) and
    replays it once; every later call copies the batch into that graph's
    static buffers and replays it. All graphs share one memory pool, which
    holds the step's activations and grads (never more than one step runs
    at a time). A failed capture raises; nothing falls back to the eager
    step. ``eager`` runs one step eagerly whatever the device (what the
    warm-up runs), to hold a captured step against it."""

    def __init__(self, body: Callable):
        self._body = body
        self._state: Optional[TrainState] = None
        self._bound: Tuple = ()
        self._warm: set = set()
        self._programs: Dict[Tuple, _Program] = {}
        self._pool = None
        self._side = None
        self.captures = 0  # graphs captured
        self.replays = 0  # graph replays, the capturing call's included

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        self._bind(state)
        if state.step.device.type == "cuda":
            loss_val, grad_norm = self._on_cuda(state, batch)
        else:
            loss_val, grad_norm = self._body(state, batch)
        return state, _metrics(loss_val, grad_norm, state.step)

    def eager(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One step run eagerly on the current stream, as the warm-up runs
        it (on any state: no program is involved)."""
        loss_val, grad_norm = self._body(state, batch)
        return state, _metrics(loss_val, grad_norm, state.step)

    def _bind(self, state: TrainState) -> None:
        bound = (state, state.step, state.opt_state,
                 *tree_leaves(state.params))
        if self._state is None:
            self._state, self._bound = state, bound
            return
        if len(bound) != len(self._bound) or any(
                a is not b for a, b in zip(bound, self._bound)):
            raise ValueError(
                "this train step serves the TrainState of its first call "
                "(its programs hold that state's memory); make another step "
                "with make_train_step for another state")

    def _on_cuda(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        dev = state.step.device
        key = tuple(sorted((k, tuple(v.shape), v.dtype)
                           for k, v in batch.items()))
        with torch.cuda.device(dev):
            if key not in self._warm:
                out = self._warm_up(state, batch, dev)
                self._warm.add(key)
                return out
            program = self._programs.get(key)
            if program is None:
                program = self._programs[key] = self._capture(state, batch,
                                                              dev)
            for k, buf in program.batch.items():
                buf.copy_(batch[k], non_blocking=True)
            program.graph.replay()
            self.replays += 1
            return program.loss, program.grad_norm

    def _warm_up(self, state, batch, dev):
        """The step run eagerly on a side stream (``graphs.warm_up``), as
        ``LLMEngine`` warms its programs before capture."""
        if self._side is None:
            self._side = torch.cuda.Stream(dev)

        def body():
            moved = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
            for v in moved.values():
                v.record_stream(self._side)
            return self._body(state, moved)

        return graphs.warm_up(body, dev, self._side)

    def _capture(self, state, batch, dev) -> _Program:
        """Captures one step over static batch buffers (``graphs.capture``,
        thread-local mode: a batch pump's thread may pin memory and copy on
        its own stream meanwhile)."""
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for k, v in batch.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cap = graphs.capture(lambda: self._body(state, static), self._pool)
        self.captures += 1
        return _Program(cap.graph, static, *cap.result, cap.launches)


def _metrics(loss_val, grad_norm, step) -> Dict[str, torch.Tensor]:
    """Fresh copies, so that a later step (a graph replay over the same
    static outputs) cannot change metrics a caller kept."""
    return {"loss": loss_val.clone(), "grad_norm": grad_norm.clone(),
            "step": step.clone()}
