"""Device mesh construction and logical-axis sharding rules (PyTorch port of
``ray_tpu/parallel/mesh.py``).

One ``torch.distributed`` ``DeviceMesh`` whose axes are the reference's
five, ``dp`` (data), ``pp`` (pipeline stage), ``ep`` (expert), ``sp``
(sequence) and ``tp`` (tensor), in that order. Parameters and activations
carry logical axis names ('vocab', 'embed', 'mlp', 'heads', 'batch', ...),
and an ``AxisRules`` table maps each onto mesh axes. Where JAX turns a
rule into a ``PartitionSpec``, the port turns it into DTensor placements,
one per mesh axis: ``Shard(dim)`` on the axes a tensor dimension maps to,
``Replicate()`` on every other. So DP, FSDP and TP stay sharding
annotations, as in the reference.

``MeshConfig``, ``AxisRules``, ``DEFAULT_RULES`` and ``FSDP_RULES`` are the
port's own copies of the reference's (pure Python, rule for rule).
``shard_box`` is the index box a mesh coordinate holds of a sharded tensor,
computed without a process group (the checkpoint and the batch pump use
it).

The ``DeviceMesh`` keeps only the axes of more than one device (``dp``
alone when every axis has one). DTensor's sharding propagation enumerates
strategies over every mesh dimension: over all five, one einsum of the
model took more than 100 s to place (torch 2.13, on the CPU), against
0.2 s over three. An axis left out holds one device, so a tensor split over
it is whole there: rules that name it give ``Replicate()``, and the boxes
each rank holds are the reference's.

A mesh needs an initialized process group whose world size is the mesh's
product: call ``torch.distributed.init_process_group`` (with its address,
world size and rank) before ``build_mesh``. The port starts no group of its
own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ray_tpu_torch.device import DeviceLike, resolve_device

MESH_AXES = ("dp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of the five mesh axes. Product must equal the device count.

    Any axis left at -1 absorbs the remaining devices (at most one).
    """

    dp: int = -1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        sizes = [self.dp, self.pp, self.ep, self.sp, self.tp]
        free = [i for i, s in enumerate(sizes) if s == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if free:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(MESH_AXES, sizes))} != {n_devices} devices"
            )
        return tuple(sizes)


def build_mesh(config: MeshConfig = MeshConfig(),
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the initialized process group,
    with the axes of ``MESH_AXES`` that have more than one device (see the
    module docstring), on CUDA unless ``device_type`` says otherwise
    (``"cpu"``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "build_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh builds a CUDA mesh by default and no CUDA device "
                "is available; pass device_type='cpu' for a CPU mesh")
        device_type = "cuda"
    from torch.distributed.device_mesh import init_device_mesh

    sizes = config.resolve(dist.get_world_size())
    kept = [(a, n) for a, n in zip(MESH_AXES, sizes) if n > 1] or [("dp", 1)]
    return init_device_mesh(device_type, tuple(n for _, n in kept),
                            mesh_dim_names=tuple(a for a, _ in kept))


MeshAxis = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical axis name -> mesh axis (or tuple of mesh axes, or None=replicate)."""

    rules: Tuple[Tuple[str, MeshAxis], ...]

    def lookup(self, logical: Optional[str]) -> MeshAxis:
        if logical is None:
            return None
        for name, axis in self.rules:
            if name == logical:
                return axis
        return None

    def with_overrides(self, **overrides: MeshAxis) -> "AxisRules":
        table = dict(self.rules)
        table.update(overrides)
        return AxisRules(tuple(table.items()))


# Megatron-style TP for vocab/mlp/heads, batch over (dp, ep), sequence over
# sp, the layer stack over pp; 'embed' replicated. FSDP shards 'embed' over
# dp as well (parameters and optimizer state ZeRO-style).
DEFAULT_RULES = AxisRules(
    (
        ("batch", ("dp", "ep")),
        ("seq", "sp"),
        ("vocab", "tp"),
        ("embed", None),
        ("mlp", "tp"),
        ("heads", "tp"),
        ("kv_heads", "tp"),
        ("head_dim", None),
        ("experts", "ep"),
        ("layers", "pp"),
        ("stage", "pp"),
    )
)

FSDP_RULES = DEFAULT_RULES.with_overrides(embed=("dp",))


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", mesh)
    if not names:
        raise ValueError("the mesh needs named axes (build_mesh names them)")
    return tuple(names)


def logical_to_placements(mesh, rules: AxisRules,
                          logical_axes: Sequence[Optional[str]]) -> tuple:
    """One DTensor placement per axis of ``mesh`` (a ``DeviceMesh``, or its
    axis names) for a tensor whose dimensions carry ``logical_axes``: the
    counterpart of the reference's ``logical_to_spec``. A mesh axis that a
    tensor dimension maps to gives ``Shard(dim)``; every other axis gives
    ``Replicate()``; an axis the mesh left out (one device) splits nothing.
    A dimension mapped to several axes (``("dp", "ep")``) is split over
    them major axis first, as JAX's ``PartitionSpec`` does; DTensor splits
    in mesh order, so the axes must be listed in mesh order."""
    names = _axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, logical in enumerate(logical_axes):
        axes = rules.lookup(logical)
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in MESH_AXES]
        if unknown:
            raise ValueError(f"rule {logical!r} -> {axes}: no mesh axis "
                             f"{unknown} in {MESH_AXES}")
        if [MESH_AXES.index(a) for a in axes] != sorted(
                MESH_AXES.index(a) for a in axes):
            raise ValueError(
                f"rule {logical!r} -> {axes}: the axes are out of mesh order "
                f"{MESH_AXES}, which DTensor placements cannot express")
        for i in (names.index(a) for a in axes if a in names):
            if placements[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions of {tuple(logical_axes)}")
            placements[i] = Shard(dim)
    return tuple(placements)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shardings_for(mesh, rules: AxisRules, logical_tree):
    """Map a tree (dicts, lists) of logical-axis tuples to the same tree of
    placements."""
    if _is_axes_leaf(logical_tree):
        return logical_to_placements(mesh, rules, logical_tree)
    if isinstance(logical_tree, dict):
        return {k: shardings_for(mesh, rules, v)
                for k, v in logical_tree.items()}
    return type(logical_tree)(shardings_for(mesh, rules, v)
                              for v in logical_tree)


def shard_box(global_shape: Sequence[int], mesh_shape: Sequence[int],
              placements: Sequence, coord: Sequence[int]) -> list:
    """[(start, stop), ...] per dimension: the box of a tensor of
    ``global_shape`` that the rank at mesh coordinate ``coord`` holds under
    ``placements``. Shards split a dimension as DTensor does, in mesh
    order, each split as ``torch.chunk`` splits (ceil-sized, trailing
    chunks smaller or empty). Needs no process group."""
    box = [[0, int(n)] for n in global_shape]
    for size, placement, c in zip(mesh_shape, placements, coord):
        if not isinstance(placement, Shard):
            if not placement.is_replicate():
                raise ValueError(f"no box for a {placement} placement")
            continue
        lo, hi = box[placement.dim]
        chunk = -(-(hi - lo) // size)
        start = min(lo + c * chunk, hi)
        box[placement.dim] = [start, min(start + chunk, hi)]
    return [tuple(b) for b in box]


def local_box(mesh, shape: Sequence[int], placements: Sequence) -> list:
    """This rank's ``shard_box`` on ``mesh``."""
    return shard_box(shape, mesh.shape, placements, mesh.get_coordinate())


def mesh_device(mesh, device: DeviceLike = None) -> torch.device:
    """This rank's device on ``mesh``: ``device`` when given (it must be of
    the mesh's type), else the current CUDA device for a CUDA mesh, the CPU
    for a CPU one."""
    if device is None:
        device = None if mesh.device_type == "cuda" else mesh.device_type
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not on the mesh's "
                         f"{mesh.device_type!r} devices")
    return dev


def axis_size(mesh, name: str) -> int:
    names = _axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def host_local_mesh(n: int = 0, device_type: Optional[str] = None):
    """A data-parallel mesh over ``n`` ranks (default: every rank of the
    process group, one device each)."""
    if n and dist.is_initialized() and n != dist.get_world_size():
        raise ValueError(f"a mesh over {n} ranks needs a process group of "
                         f"{n}, not {dist.get_world_size()}")
    return build_mesh(MeshConfig(dp=-1), device_type)
