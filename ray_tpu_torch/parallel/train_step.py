"""Train state and train step, on one device or over a device mesh
(PyTorch port).

Port of ``ray_tpu/parallel/train_step.py``: ``TrainState``,
``batch_sharding`` (:51), ``make_sharded_state`` (:56), ``make_train_step``
(:99) and ``default_optimizer`` (:142). The step takes the loss's gradients
by autograd, clips them by their global norm, and applies AdamW, all on the
card and without a host sync: its metrics stay device tensors.

Over a mesh (``parallel/mesh.py``), DP, FSDP and TP are placements, as
they are shardings in the reference: the parameters and AdamW's moments are
DTensors laid out by ``param_logical_axes`` under the rules, the batch is
split over the batch axes, and the same step body runs over DTensors. Each
gradient is reduced into its parameter's placements (an all-reduce or a
reduce-scatter over the batch axes) before the clip, whose norm is taken
over the whole gradient.

Where JAX donates the state to a jitted step (``donate_argnums``, :133-139),
the port updates parameters, optimizer state and ``step`` in place, and on
CUDA runs the whole step as one captured program: the first call with a
batch of new shapes is a real step run eagerly (the warm-up), the next one
captures a CUDA graph of the step and replays it, and every later call
copies its batch into the graph's static buffers and replays. Over a mesh
the graph holds the DTensors' local kernels and any collectives, and its
static buffers are the local tensors of DTensors: DTensor's host-side
dispatch is paid at the warm-up and the capture only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch import graphs
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
    param_logical_axes,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    AxisRules,
    logical_to_placements,
    mesh_device,
    shardings_for,
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
        torch._foreach_mul_([_local(g) for g in grads], scale)
        return norm


def default_optimizer(lr: float = 3e-4,
                      weight_decay: float = 0.01) -> ClippedAdamW:
    return ClippedAdamW(lr=lr, weight_decay=weight_decay)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in fp32. A DTensor's norm is over the whole tensor: the norms of its
    shards are combined across the mesh."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    norms = [n.full_tensor() if isinstance(n, DTensor) else n for n in norms]
    return torch.linalg.vector_norm(torch.stack(norms))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (the memory it owns); a tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def batch_sharding(mesh, rules: AxisRules = DEFAULT_RULES) -> Tuple:
    """Tokens/targets [B, S]: batch over dp(+ep), sequence over sp, as
    ``(mesh, placements)`` (what ``data.device_batches`` takes)."""
    return mesh, logical_to_placements(mesh, rules, ("batch", "seq"))


def make_sharded_state(
    config: TransformerConfig,
    optimizer: ClippedAdamW,
    seed: int,
    device: Union[DeviceLike, Sequence[DeviceLike]] = None,
    params: Optional[Dict] = None,
    *,
    mesh=None,
    rules: AxisRules = DEFAULT_RULES,
) -> Tuple[TrainState, Optional[TrainState]]:
    """Returns (state, state_shardings): params from ``init_params(config,
    seed)`` or, when given, ``params`` (such as the JAX package's, converted
    by ``params_from_numpy``), on ``device`` (CUDA by default), and the
    optimizer's state.

    Without ``mesh`` the state lies on one device, given params are updated
    in place, and the second value is None (one device has no shardings).
    With ``mesh`` every parameter is a DTensor with the placements of
    ``param_logical_axes(config)`` under ``rules``: every rank makes (or is
    given) the same global values and keeps its own box of each, so a seed
    gives the same global state on every mesh shape and world size. AdamW's
    moments, made at the first step, lie as their parameters do; ``step``
    and AdamW's count are replicated. ``state_shardings`` is a
    ``TrainState`` of placements: ``step`` replicated, ``params`` the
    parameters' and ``opt_state`` the moments' (the same tree)."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(
                f"a train state over {len(device)} devices is laid out on a "
                "mesh: pass mesh=build_mesh(...) (parallel/mesh.py), not a "
                "list of devices")
        device = device[0]
    if mesh is None:
        dev = resolve_device(device)
        if params is None:
            params = init_params(config, seed, dev)
        params = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                          params)
        state = TrainState(step=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                           params=params, opt_state=optimizer.init(params))
        return state, None
    dev = mesh_device(mesh, device)
    if params is None:
        params = init_params(config, seed, dev)
    # in the params' own key order (a converted tree's keys are sorted)
    placements = _tree_zip(lambda _, pl: pl, params, shardings_for(
        mesh, rules, param_logical_axes(config)))
    params = _tree_zip(
        lambda t, pl: distribute_tensor(
            t.detach().to(dev), mesh, pl,
            src_data_rank=None).requires_grad_(True),
        params, placements)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                       params=params, opt_state=optimizer.init(params))
    replicated = (Replicate(),) * mesh.ndim
    return state, TrainState(step=replicated, params=placements,
                             opt_state=placements)


def _tree_zip(fn: Callable, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of dicts of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def make_train_step(
    config: TransformerConfig,
    optimizer: ClippedAdamW,
    loss: Callable = loss_fn,
    grads_fn: Optional[Callable] = None,
    *,
    mesh=None,
    state_shardings: Optional[TrainState] = None,
    rules: AxisRules = DEFAULT_RULES,
) -> "TrainStep":
    """(state, batch) -> (state, metrics), updating the state in place.

    ``loss(params, batch, config)`` (under a mesh ``loss(params, batch,
    config, mesh)``) is differentiated by autograd unless
    ``grads_fn(params, batch) -> (loss, grads)`` is given (a schedule with a
    hand-written backward). ``metrics`` = {loss, grad_norm (of the raw
    grads, before clipping), step}: device tensors of their own at every
    call, whole on every rank. On CUDA the step runs as one captured program
    (``TrainStep``); on the CPU it runs eagerly.

    With ``mesh`` the state is ``make_sharded_state(..., mesh=mesh)``'s
    (its parameters must lie as ``state_shardings.params`` says, when
    given), and the batch is split as ``batch_sharding(mesh, rules)``: a
    batch of DTensors is taken as it lies, and a batch of whole tensors
    (the same on every rank) is cut to each rank's box. Every gradient is
    reduced into its parameter's placements before the clip."""
    if mesh is None:
        if state_shardings is not None:
            raise ValueError("state_shardings needs the mesh they lie on")
        place = None
    else:
        _, batch_placements = batch_sharding(mesh, rules)

        def place(batch):
            return {k: v if isinstance(v, DTensor) else distribute_tensor(
                        v, mesh, batch_placements, src_data_rank=None)
                    for k, v in batch.items()}

    def body(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        if grads_fn is not None:
            loss_val, grads = grads_fn(state.params, batch)
            for p, g in zip(leaves, tree_leaves(grads)):
                p.grad = g
        elif mesh is None:
            loss_val = loss(state.params, batch, config)
            loss_val.backward()
        else:
            loss_val = loss(state.params, batch, config, mesh)
            loss_val.backward()
        grad_norm = optimizer.clip_([_reduced_grad(p) for p in leaves])
        state.opt_state.step()
        for p in leaves:
            p.grad = None  # next step's backward starts from no grads
        state.step.add_(1)
        if isinstance(loss_val, DTensor):
            loss_val = loss_val.full_tensor()
        return loss_val.detach(), grad_norm

    check = None
    if state_shardings is not None:
        def check(state: TrainState) -> None:
            if not all(tree_leaves(_tree_zip(
                    lambda p, pl: tuple(p.placements) == tuple(pl),
                    state.params, state_shardings.params))):
                raise ValueError("the state's parameters do not lie as "
                                 "state_shardings says")

    return TrainStep(body, place=place, check=check)


def _reduced_grad(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, redistributed into ``p``'s placements when it lies
    otherwise (a Partial sum over the batch axes becomes an all-reduce, or
    a reduce-scatter onto a sharded parameter)."""
    g = p.grad
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        g = p.grad = g.redistribute(p.device_mesh, p.placements)
    return g


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
    warm-up runs), to hold a captured step against it.

    A mesh step's batch may be DTensors: its programs' static buffers are
    then DTensors of the same placements, and a replay copies the local
    tensors."""

    def __init__(self, body: Callable, place: Optional[Callable] = None,
                 check: Optional[Callable] = None):
        self._body = body
        self._place = place  # a mesh step's batch placement
        self._check = check  # a mesh step's check of the state's layout
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
        if self._place is not None:
            batch = self._place(batch)
        if state.step.device.type == "cuda":
            loss_val, grad_norm = self._on_cuda(state, batch)
        else:
            loss_val, grad_norm = self._body(state, batch)
        return state, _metrics(loss_val, grad_norm, state.step)

    def eager(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One step run eagerly on the current stream, as the warm-up runs
        it (on any state: no program is involved)."""
        if self._place is not None:
            batch = self._place(batch)
        loss_val, grad_norm = self._body(state, batch)
        return state, _metrics(loss_val, grad_norm, state.step)

    def _bind(self, state: TrainState) -> None:
        bound = (state, state.step, state.opt_state,
                 *tree_leaves(state.params))
        if self._state is None:
            if self._check is not None:
                self._check(state)
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
        key = tuple(sorted((k, tuple(v.shape), v.dtype,
                            tuple(getattr(v, "placements", ())))
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
                _local(buf).copy_(_local(batch[k]), non_blocking=True)
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
                _local(v).record_stream(self._side)
            return self._body(state, moved)

        return graphs.warm_up(body, dev, self._side)

    def _capture(self, state, batch, dev) -> _Program:
        """Captures one step over static batch buffers (``graphs.capture``,
        thread-local mode: a batch pump's thread may pin memory and copy on
        its own stream meanwhile)."""
        static = {k: _empty_like(v, dev) for k, v in batch.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cap = graphs.capture(lambda: self._body(state, static), self._pool)
        self.captures += 1
        return _Program(cap.graph, static, *cap.result, cap.launches)


def _empty_like(v: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A static buffer for ``v`` on ``dev``: a DTensor of ``v``'s layout
    over a new local tensor, or a new tensor."""
    if not isinstance(v, DTensor):
        return torch.empty(v.shape, dtype=v.dtype, device=dev)
    local = torch.empty(v.to_local().shape, dtype=v.dtype, device=dev)
    return DTensor.from_local(local, v.device_mesh, v.placements,
                              shape=v.shape, stride=v.stride())


def _metrics(loss_val, grad_norm, step) -> Dict[str, torch.Tensor]:
    """Fresh copies, so that a later step (a graph replay over the same
    static outputs) cannot change metrics a caller kept."""
    return {"loss": loss_val.clone(), "grad_norm": grad_norm.clone(),
            "step": step.clone()}
