"""MeshGroup: gang-scheduled multi-host jobs over one DeviceMesh (PyTorch
port of ``ray_tpu/mesh/group.py``).

The compute-plane composition of primitives the runtime already proves
in isolation: a STRICT_SPREAD placement group reserves one bundle per
host (atomic gang placement), ``devices_per_host`` long-lived
``_MeshWorker`` actors land in each bundle — ONE PROCESS PER DEVICE, as
PyTorch runs (the reference runs one process per host) — and a
``torch.distributed`` rendezvous through a TCP store that rank 0 binds
(the ``train.worker_group`` bootstrap) joins every rank into one process
group, over which each rank builds the gang's ``DeviceMesh``. User step
functions compile against an explicit sharding plan
(:func:`ray_tpu_torch.mesh.plan.compile_step_with_plan`: DTensor
placements when both shardings are given, ``local_map`` otherwise) and
execute as lockstep gang calls with a single typed failure semantics:
any rank death fails the step for the WHOLE gang
(:class:`RankFailedError`, naming the dead process's rank and its host).

Failure/restart: :meth:`MeshGroup.recover` tears the broken gang down
(survivors wedged in a dead rank's collective are killed, never
awaited), re-places a fresh one in fresh processes — same or DIFFERENT
``mesh_shape``/host count — re-runs the rendezvous under a bumped epoch,
re-compiles every registered step, and restores training state by
RESHARDING the last sharded checkpoint onto the new mesh
(``train.sharded_checkpoint.load_sharded(like=)``).

Devices: a ``GPU`` entry of ``resources_per_host`` gives every rank one
card (``num_gpus=1``; the lease names it, so the rank's device is
``cuda:0``) and NCCL; a gang whose resources name no GPU runs gloo ranks
on the CPU. A GPU gang raises where no card is granted: it never trains
on the CPU.

Observability: the controller publishes gang membership, rendezvous
epoch, steps run and the last failure to the GCS mesh-group registry;
each member node's ``node_stats`` surfaces its gangs under a
``mesh_groups`` section, and member nodes carry a
``raytpu.io/gang=<name>`` label that the object plane's locality-aware
stripe-peer picker prefers.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.mesh.plan import normalize_mesh_shape

logger = logging.getLogger(__name__)

# gang lifecycle states
PLACING = "PLACING"
RENDEZVOUS = "RENDEZVOUS"
READY = "READY"
BROKEN = "BROKEN"
SHUTDOWN = "SHUTDOWN"

_PORT_ATTEMPTS = 8  # coordinator ports tried before giving up

_auto_name_seq = 0


def _auto_name() -> str:
    """Auto gang name: drawn from the chaos-seeded RNG (plus a process-
    local sequence) so a replayed workload names — and therefore
    jitters, labels and registers — its gangs identically; without a
    chaos plane replay_rng is OS-seeded, i.e. plain unique names."""
    from ray_tpu_torch._private import chaos

    global _auto_name_seq
    _auto_name_seq += 1
    rng = chaos.replay_rng(f"meshgroup:autoname:{_auto_name_seq}")
    return f"meshgroup_{_auto_name_seq}_{rng.getrandbits(32):08x}"


class MeshGroupError(RayTpuError):
    """Gang-level failure (placement, rendezvous, lockstep timeout)."""


class RankFailedError(MeshGroupError):
    """A rank died (or its actor became unreachable) during a lockstep
    call — the step failed for the whole gang. ``rank`` is the dead
    process's rank, ``host`` the index of its host. ``recover()``
    re-places and reshard-restores."""

    def __init__(self, group: str, rank: int, epoch: int,
                 cause: Optional[BaseException] = None,
                 host: Optional[int] = None):
        super().__init__(
            f"mesh group {group!r}: rank {rank} (host {host}) failed during "
            f"a lockstep call (rendezvous epoch {epoch}) — the step failed "
            f"for the whole gang; call recover() to re-place and "
            f"reshard-restore"
        )
        self.group = group
        self.rank = rank
        self.host = host
        self.epoch = epoch
        self.cause = cause


class StateKey:
    """Marker argument for :meth:`MeshGroup.run_step`: resolved on each
    rank to that rank's worker-resident state entry (sharded tensors
    never travel through the controller)."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __repr__(self):
        return f"StateKey({self.key!r})"


class MeshWorkerContext:
    """Per-rank view handed to ``MeshGroup.run`` functions: the global
    mesh, this rank's coordinates, its device, and the persistent per-rank
    state store that ``run_step``'s StateKey args resolve against."""

    def __init__(self, worker: "_MeshWorker"):
        self.mesh = worker._mesh
        self.rank = worker._rank
        self.world_size = worker._world
        self.host = worker._host
        self.epoch = worker._epoch
        self.device = worker._device
        self.state = worker._state


def _to_host(x):
    """A fetched output as host numpy: a DTensor whole (a collective: every
    rank fetches the same outputs), a tensor as it is (bf16 as float32)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return np.asarray(x) if isinstance(x, (int, float, bool)) else x


class _MeshWorker:
    """Actor body: one per device, owns that device for the gang's
    lifetime. All methods run serially; the controller drives them in
    lockstep across ranks."""

    def __init__(self):
        self._state: Dict[str, Any] = {}
        self._steps: Dict[str, Callable] = {}
        self._step_plans: Dict[str, Dict] = {}
        self._mesh = None
        self._rank = -1
        self._world = 0
        self._host = -1
        self._epoch = 0
        self._steps_run = 0
        self._device = "cpu"
        self._store = None  # rank 0's TCP store, held while the gang lives

    # -- bootstrap ----------------------------------------------------

    def init_runtime(self, env: Dict[str, str], use_gpu: bool) -> str:
        """The gang's env, applied before this process's first CUDA call,
        then the device: ``cuda:0`` (the card the lease names) when the
        gang asks GPUs, else the CPU with one torch thread (gloo ranks
        share the host's cores)."""
        import os

        os.environ.update(env or {})
        import torch

        if use_gpu:
            if not torch.cuda.is_available():
                raise MeshGroupError(
                    "the gang asks a GPU per rank but this rank sees no CUDA "
                    "device (its lease's CUDA_VISIBLE_DEVICES names no "
                    "usable card); it does not train on the CPU")
            torch.cuda.set_device(0)
            self._device = "cuda:0"
        else:
            torch.set_num_threads(1)
            self._device = "cpu"
        return self._device

    def coordinator_info(self) -> str:
        """Bind the gang's TCP store on this node and return its address.
        The port is picked free and bound at once; a port taken in between
        (EADDRINUSE) is picked again."""
        import datetime
        import errno

        import torch.distributed as dist

        from ray_tpu_torch._private.node import node_ip_address, pick_free_port

        host, attempt = node_ip_address(), 0
        while True:
            attempt += 1
            port = pick_free_port()
            try:
                self._store = dist.TCPStore(
                    host, port, is_master=True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=60))
                return f"{host}:{port}"
            except (RuntimeError, OSError) as e:
                in_use = (getattr(e, "errno", None) == errno.EADDRINUSE
                          or "address already in use" in str(e).lower())
                if not in_use or attempt == _PORT_ATTEMPTS:
                    raise

    def rendezvous(self, coordinator: str, world: int, rank: int,
                   host: int, epoch: int, axis_names: Sequence[str],
                   sizes: Sequence[int], timeout_s: float) -> Dict[str, Any]:
        """Join the gang: ``init_process_group`` through the TCP store at
        ``coordinator`` (NCCL on the card, gloo on the CPU; every
        collective bounded by ``timeout_s``), one all-reduce so that
        NCCL's communicator exists before any step is captured, then the
        gang's mesh."""
        import datetime
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.mesh.plan import make_mesh

        cuda = self._device.startswith("cuda")
        timeout = datetime.timedelta(seconds=timeout_s)
        if rank == 0:
            if self._store is None:
                raise MeshGroupError("coordinator_info was not called on "
                                     "rank 0")
            store = self._store
        else:
            addr, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(addr, int(port), is_master=False,
                                  timeout=timeout)
        dist.init_process_group(backend="nccl" if cuda else "gloo",
                                store=store, rank=rank, world_size=world,
                                timeout=timeout)
        one = torch.ones(1, device=self._device)
        dist.all_reduce(one)
        self._mesh = make_mesh(dict(zip(axis_names, sizes)),
                               axis_names=tuple(axis_names),
                               device_type="cuda" if cuda else "cpu")
        self._rank, self._world, self._host = rank, world, host
        self._epoch = epoch
        uuid = (str(torch.cuda.get_device_properties(0).uuid) if cuda
                else "")
        return {
            "node_id": ray_tpu_torch.get_runtime_context().get_node_id(),
            "pid": os.getpid(),
            "rank": rank,
            "host": host,
            "device": self._device,
            "device_uuid": uuid,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "global_devices": int(one.item()),
        }

    # -- gang work ----------------------------------------------------

    def run(self, fn: Callable, args: Tuple, kwargs: Dict) -> Any:
        """Execute ``fn(ctx, *args, **kwargs)`` on this rank."""
        return fn(MeshWorkerContext(self), *args, **(kwargs or {}))

    def compile_step(self, step_id: str, fn: Callable,
                     plan: Dict[str, Any]) -> int:
        from ray_tpu_torch.mesh.plan import compile_step_with_plan

        self._steps[step_id] = compile_step_with_plan(
            fn, self._mesh, **plan
        )
        self._step_plans[step_id] = plan
        return 1

    def _globalize_args(self, step_id: str, argv: List) -> List:
        """Turn broadcast host values (numpy/scalars — identical on every
        rank by construction: the controller ships one copy to all) into
        DTensors laid out per the step's input plan: each rank builds its
        piece with ``DTensor.from_local`` from its box
        (``parallel.mesh.local_box``). DTensors already laid out (StateKey
        resolutions, prior outputs) pass through untouched."""
        from ray_tpu_torch.mesh.plan import globalize

        plan = self._step_plans.get(step_id) or {}
        in_tree = plan.get("in_shardings")
        if in_tree is None:
            in_tree = plan.get("in_specs")
        return globalize(self._mesh, in_tree, argv,
                         plan.get("static_argnums") or ())

    def run_step(self, step_id: str, args: Tuple,
                 store: Optional[Dict[int, str]],
                 fetch: Optional[List[int]]) -> List:
        """One lockstep execution of a compiled step.

        StateKey args resolve to this rank's state entries; outputs
        listed in ``store`` stay worker-resident (sharded training state
        never leaves the devices); ``fetch`` indices come back as host
        numpy, whole (every rank returns the same values)."""
        step = self._steps.get(step_id)
        if step is None:
            raise MeshGroupError(f"unknown step {step_id!r} on rank "
                                 f"{self._rank} (compile before run)")
        argv = [
            self._state[a.key] if isinstance(a, StateKey) else a
            for a in args
        ]
        out = step(*self._globalize_args(step_id, argv))
        outs = out if isinstance(out, tuple) else (out,)
        store = {int(k): v for k, v in (store or {}).items()}
        for idx, key in store.items():
            self._state[key] = outs[idx]
        if fetch is None:
            fetch = [i for i in range(len(outs)) if i not in store]
        self._steps_run += 1
        return [_to_host(outs[int(i)]) for i in fetch]

    def _tree(self, keys: Optional[List[str]]):
        """The named state entries as one checkpoint tree: a lone
        ``TrainState`` as itself (the train step's checkpoint format),
        else ``{key: entry}``."""
        from ray_tpu_torch.parallel.train_step import TrainState

        keys = list(keys) if keys else sorted(self._state)
        tree = {k: self._state[k] for k in keys}
        states = [k for k in keys if isinstance(tree[k], TrainState)]
        if states and len(keys) > 1:
            raise MeshGroupError(
                f"rank {self._rank}: a TrainState ({states[0]!r}) is saved "
                f"alone; save_state(keys=[{states[0]!r}]) and the other "
                f"entries to another path")
        return keys, (tree[keys[0]] if states else tree)

    def save_state(self, path: str, step: int,
                   keys: Optional[List[str]]) -> int:
        """Sharded checkpoint of the named state entries (every rank
        writes only the pieces it holds; rank 0 commits)."""
        from ray_tpu_torch.train.sharded_checkpoint import save_sharded

        _, tree = self._tree(keys)
        save_sharded(tree, path, step=step, wait=True)
        return step

    def restore_state(self, path: str,
                      keys: Optional[List[str]]) -> int:
        """Reshard-restore the named entries from a sharded checkpoint
        onto THIS gang's mesh (slice-intersection reassembly — the
        checkpoint may come from a different mesh shape/world size).
        The entries must already exist (state_init ran) so their layouts
        define the restore; a TrainState is filled in place."""
        from ray_tpu_torch.parallel.train_step import TrainState
        from ray_tpu_torch.train.sharded_checkpoint import (
            checkpoint_step,
            load_sharded,
        )

        if not (keys or self._state):
            raise MeshGroupError(
                f"rank {self._rank}: no state entries to restore into — "
                f"run the state init first (restoring into empty state "
                f"would silently restore nothing)"
            )
        keys, template = self._tree(keys)
        restored = load_sharded(path, like=template)
        if isinstance(template, TrainState):
            self._state[keys[0]] = restored
        else:
            for k in keys:
                self._state[k] = restored[k]
        return checkpoint_step(path)

    def stats(self) -> Dict[str, int]:
        return {"rank": self._rank, "steps_run": self._steps_run,
                "epoch": self._epoch}


class MeshGroup:
    """Controller handle on a gang of ``devices_per_host`` ``_MeshWorker``
    processes on each of ``hosts`` hosts.

    ``mesh_shape`` is an ordered ``{axis: size}`` dict (or a
    ``parallel.mesh.MeshConfig``); its product must equal
    ``hosts * devices_per_host``. ``resources_per_host`` is one host's
    bundle (default one CPU per rank); a ``GPU`` entry must give each rank
    one card. The constructor blocks until the gang is placed,
    rendezvoused and READY.
    """

    def __init__(
        self,
        hosts: int,
        mesh_shape,
        axis_names: Optional[Sequence[str]] = None,
        *,
        devices_per_host: Optional[int] = None,
        name: Optional[str] = None,
        resources_per_host: Optional[Dict[str, float]] = None,
        env: Optional[Dict[str, str]] = None,
        checkpoint_path: Optional[str] = None,
        state_init: Optional[Callable] = None,
        heal_policy: Optional[Any] = None,
    ):
        if hosts < 1:
            raise ValueError("hosts must be >= 1")
        self.name = name or _auto_name()
        # heal policy (mesh.heal.GangHealer): notified on rank death to
        # file a replacement host; drives heal() back to READY at the
        # original shape. ``heal_state`` mirrors its FSM into the
        # registry ("" when no heal is in flight).
        self.heal_policy = heal_policy
        self.heal_state = ""
        self.hosts = hosts
        self.axis_names, self.sizes = normalize_mesh_shape(
            mesh_shape, axis_names
        )
        self.devices_per_host = devices_per_host
        self.resources_per_host = dict(
            resources_per_host or {"CPU": float(devices_per_host or 1)})
        self.env = dict(env or {})
        self.checkpoint_path = checkpoint_path
        self.state_init = state_init
        self.state = PLACING
        self.epoch = 0
        self.steps_run = 0
        self.last_failure = ""
        self.pg = None
        self.workers: List = []  # rank order: host-major
        self.members: List[Dict] = []  # rendezvous replies, rank order
        self._registry_quiet_until = 0.0  # periodic-publish cooldown
        # (fn, plan) per compiled step — recover() recompiles these on
        # the fresh gang
        self._step_registry: Dict[str, Tuple[Callable, Dict]] = {}
        self._validate_shape()
        try:
            self._bring_up(attempts=3)
        except BaseException:
            # the gang never existed publicly: a constructor failure
            # must not leave a BROKEN orphan in the registry
            self._teardown(note="init failed")
            self._gcs_call("mesh_group_remove", self.name)
            raise

    # ------------------------------------------------------------------

    @property
    def ranks_per_host(self) -> int:
        return int(self.devices_per_host or 1)

    @property
    def world_size(self) -> int:
        return self.hosts * self.ranks_per_host

    def _bring_up(self, attempts: int = 3):
        """Place + rendezvous with bounded, jittered retries: transient
        cluster weather (a node falsely declared dead under chaos, a
        host lost between the 2PC reservation and worker boot) costs a
        re-place, not the gang. Jitter draws from the chaos-seeded RNG
        so a replayed fault schedule meets identical re-placement
        traffic. Exhaustion leaves the gang BROKEN and raises."""
        from ray_tpu_torch._private import chaos

        rng = chaos.replay_rng(f"meshgroup:{self.name}:bring_up")
        last: Optional[BaseException] = None
        for attempt in range(max(1, attempts)):
            try:
                self._place()
                self._rendezvous()
                return
            except Exception as e:
                # not just MeshGroupError: a dying host surfaces as an
                # actor/task error — exactly the transient class this
                # loop exists for; teardown so nothing leaks between
                # attempts
                last = e
                self._teardown(note=f"bring-up attempt {attempt} failed")
                time.sleep((0.2 + 0.3 * attempt) * (1 + rng.random()))
        self.state = BROKEN
        self.last_failure = f"bring-up failed: {last}"
        self._publish_registry()
        raise MeshGroupError(
            f"mesh group {self.name!r}: gang bring-up exhausted "
            f"{attempts} placement attempt(s): {last}"
        ) from last

    def _validate_shape(self):
        total = math.prod(self.sizes)
        want = self.world_size
        if total != want:
            raise MeshGroupError(
                f"mesh {dict(zip(self.axis_names, self.sizes))} has "
                f"{total} devices but hosts x devices_per_host = {want}"
            )
        gpus = float(self.resources_per_host.get("GPU", 0.0))
        if gpus and gpus != self.ranks_per_host:
            raise MeshGroupError(
                f"resources_per_host GPU={gpus:g} for {self.ranks_per_host}"
                f" rank(s) per host: a gang runs one process per card, so a "
                f"host's bundle names devices_per_host GPUs")

    def _worker_resources(self) -> Dict[str, float]:
        """One rank's share of its host's bundle."""
        n = self.ranks_per_host
        return {r: q / n for r, q in self.resources_per_host.items()}

    def _place(self):
        """Gang-reserve one bundle per host (STRICT_SPREAD 2PC), then pin
        ``devices_per_host`` workers into each bundle — atomic multi-host
        placement, one process per device."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        self.state = PLACING
        timeout = GLOBAL_CONFIG.mesh_group_placement_timeout_s
        self.pg = placement_group(
            [dict(self.resources_per_host) for _ in range(self.hosts)],
            strategy="STRICT_SPREAD",
            name=f"mesh:{self.name}",
        )
        if not self.pg.wait(timeout_seconds=timeout):
            raise MeshGroupError(
                f"mesh group {self.name!r}: STRICT_SPREAD placement of "
                f"{self.hosts} bundle(s) {self.resources_per_host} did "
                f"not complete within {timeout}s — not enough distinct "
                f"feasible hosts?"
            )
        res = self._worker_resources()
        opts = {"resources": dict(res), "max_restarts": 0}
        if res.get("GPU"):
            opts["num_gpus"] = res["GPU"]
        actor_cls = ray_tpu_torch.remote(**opts)(_MeshWorker)
        self.workers = [
            actor_cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, placement_group_bundle_index=host
                )
            ).remote()
            for host in range(self.hosts)
            for _ in range(self.ranks_per_host)
        ]
        use_gpu = bool(res.get("GPU"))
        ray_tpu_torch.get(
            [w.init_runtime.remote(self.env, use_gpu) for w in self.workers],
            timeout=timeout,
        )

    def _rendezvous(self):
        """Join every rank into one process group under a new epoch and
        build the gang's mesh on every rank."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self.state = RENDEZVOUS
        self.epoch += 1
        timeout = GLOBAL_CONFIG.mesh_group_rendezvous_timeout_s
        coordinator = ray_tpu_torch.get(
            self.workers[0].coordinator_info.remote(), timeout=60
        )
        n = self.ranks_per_host
        self.members = self._gang_call(
            [
                w.rendezvous.remote(
                    coordinator, self.world_size, i, i // n, self.epoch,
                    list(self.axis_names), list(self.sizes), timeout,
                )
                for i, w in enumerate(self.workers)
            ],
            timeout=timeout,
            what="rendezvous",
        )
        total = math.prod(self.sizes)
        seen = self.members[0]["global_devices"]
        if seen != total:
            raise MeshGroupError(
                f"mesh group {self.name!r}: rendezvous saw {seen} global "
                f"devices, mesh {dict(zip(self.axis_names, self.sizes))} "
                f"needs {total}"
            )
        # one node per host: a host's ranks share a node, hosts do not
        by_host = [{m["node_id"] for m in self.members[h * n:(h + 1) * n]}
                   for h in range(self.hosts)]
        node_ids = [next(iter(s)) for s in by_host if len(s) == 1]
        if len(node_ids) != self.hosts or len(set(node_ids)) != self.hosts:
            raise MeshGroupError(
                f"mesh group {self.name!r}: gang is not one-per-host "
                f"({[sorted(s) for s in by_host]})"
            )
        self.state = READY
        self._publish_registry()
        self._stamp_gang_labels(node_ids)

    # -- lockstep machinery --------------------------------------------

    def _gang_call(self, refs: List, timeout: float, what: str) -> List:
        """Gather one lockstep call across all ranks. Any rank's failure
        (actor death first among them) breaks the WHOLE gang: survivors
        may be wedged inside the dead rank's collective, so they are
        torn down rather than awaited."""
        deadline = time.monotonic() + timeout
        remaining = list(enumerate(refs))
        results: List[Any] = [None] * len(refs)
        failures: Dict[int, BaseException] = {}
        while remaining:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            ready, _ = ray_tpu_torch.wait(
                [r for _, r in remaining],
                num_returns=len(remaining),
                timeout=min(1.0, budget),
            )
            ready_set = set(ready)
            still = []
            for rank, ref in remaining:
                if ref in ready_set:
                    try:
                        results[rank] = ray_tpu_torch.get(ref, timeout=60)
                    except Exception as e:  # rank death / typed task error
                        failures[rank] = e
                else:
                    still.append((rank, ref))
            remaining = still
            if failures:
                break
        if failures:
            # A dead rank's peers often fail FIRST (their collective
            # aborts before the raylet reports the death): sweep the
            # still-pending refs for a short grace so the error
            # attributes to the rank that actually died, not the first
            # survivor that felt it.
            grace = time.monotonic() + 2.0
            while remaining and time.monotonic() < grace:
                ready, _ = ray_tpu_torch.wait(
                    [r for _, r in remaining],
                    num_returns=len(remaining), timeout=0.5,
                )
                ready_set = set(ready)
                still = []
                for rank, ref in remaining:
                    if ref in ready_set:
                        try:
                            results[rank] = ray_tpu_torch.get(ref,
                                                              timeout=10)
                        except Exception as e:
                            failures[rank] = e
                    else:
                        still.append((rank, ref))
                remaining = still
            from ray_tpu_torch.exceptions import (
                ActorDiedError,
                ActorUnavailableError,
                WorkerCrashedError,
            )

            dead = [
                r for r, e in sorted(failures.items())
                if isinstance(e, (ActorDiedError, ActorUnavailableError,
                                  WorkerCrashedError))
            ]
            rank = dead[0] if dead else min(failures)
            self._break_gang(f"{what}: rank {rank} failed: "
                             f"{failures[rank]!r}")
            if self.heal_policy is not None:
                # fire the replacement request BEFORE the typed error
                # propagates: provisioning latency starts now. Never
                # lets a policy bug mask the failure.
                try:
                    self.heal_policy.note_failure(
                        self, rank, failures[rank]
                    )
                except Exception:
                    logger.exception(
                        "mesh group %s: heal policy note_failure failed",
                        self.name,
                    )
            raise RankFailedError(
                self.name, rank, self.epoch, cause=failures[rank],
                host=rank // self.ranks_per_host,
            ) from failures[rank]
        if remaining:
            ranks = sorted(r for r, _ in remaining)
            self._break_gang(
                f"{what}: ranks {ranks} did not complete in {timeout}s"
            )
            raise MeshGroupError(
                f"mesh group {self.name!r}: lockstep {what} timed out "
                f"after {timeout}s waiting on ranks {ranks} — the gang "
                f"is broken; call recover()"
            )
        return results

    def _break_gang(self, why: str):
        self.state = BROKEN
        self.last_failure = why
        logger.warning("mesh group %s broken: %s", self.name, why)
        # keep the broken incarnation's membership visible: teardown
        # clears self.members (labels, actors), but the registry record
        # must still name the members/ranks so their node_stats surface
        # BROKEN + last_failure where operators look
        members = list(self.members)
        self._teardown(note=why, keep_registry=True)
        self.members = members
        self._publish_registry()

    def _require_ready(self):
        if self.state != READY:
            why = f" ({self.last_failure})" if self.last_failure else ""
            hint = " — call recover()" if self.state == BROKEN else ""
            raise MeshGroupError(
                f"mesh group {self.name!r} is {self.state}{why}{hint}"
            )

    # -- public gang API ----------------------------------------------

    def run(self, fn: Callable, *args, timeout: Optional[float] = None,
            **kwargs) -> List:
        """Lockstep-run ``fn(ctx, *args, **kwargs)`` on every rank;
        returns per-rank results in rank order."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._require_ready()
        return self._gang_call(
            [w.run.remote(fn, args, kwargs) for w in self.workers],
            timeout=timeout or GLOBAL_CONFIG.mesh_group_step_timeout_s,
            what="run",
        )

    def compile_step_with_plan(
        self,
        fn: Callable,
        *,
        in_shardings=None,
        out_shardings=None,
        donate_argnums: Sequence[int] = (),
        static_argnums: Sequence[int] = (),
        in_specs=None,
        out_specs=None,
        step_id: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> str:
        """Compile ``fn`` against the sharding plan on EVERY rank (DTensor
        placements when both shardings are given, ``local_map`` over
        in_specs/out_specs otherwise). Returns the step id for
        :meth:`run_step`. The plan is registered controller-side so
        :meth:`recover` can recompile it on a fresh gang."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._require_ready()
        step_id = step_id or f"step_{len(self._step_registry)}"
        plan = {
            "in_shardings": in_shardings,
            "out_shardings": out_shardings,
            "donate_argnums": tuple(donate_argnums),
            "static_argnums": tuple(static_argnums),
            "in_specs": in_specs,
            "out_specs": out_specs,
        }
        self._gang_call(
            [w.compile_step.remote(step_id, fn, plan)
             for w in self.workers],
            timeout=timeout or GLOBAL_CONFIG.mesh_group_step_timeout_s,
            what=f"compile:{step_id}",
        )
        self._step_registry[step_id] = (fn, plan)
        return step_id

    def run_step(self, step_id: str, *args,
                 store: Optional[Dict[int, str]] = None,
                 fetch: Optional[List[int]] = None,
                 timeout: Optional[float] = None) -> List:
        """Gang-coherent dispatch of one compiled step: all ranks execute
        it as one lockstep call. ``StateKey`` args resolve per rank;
        ``store={output_index: state_key}`` keeps those outputs
        worker-resident; ``fetch`` indices return as host numpy, whole
        (rank 0's copy). Any rank death raises :class:`RankFailedError`
        for the whole gang."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._require_ready()
        out = self._gang_call(
            [w.run_step.remote(step_id, args, store, fetch)
             for w in self.workers],
            timeout=timeout or GLOBAL_CONFIG.mesh_group_step_timeout_s,
            what=f"step:{step_id}",
        )
        self.steps_run += 1
        if self.steps_run % 16 == 0:  # keep the registry's counter warm
            self._publish_registry_periodic()
        return out[0]

    def save_state(self, path: Optional[str] = None, *, step: int = 0,
                   keys: Optional[List[str]] = None,
                   timeout: Optional[float] = None) -> str:
        """Sharded-checkpoint the gang's worker-resident state (every
        rank writes its pieces, rank 0 commits). Returns the path."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        path = path or self.checkpoint_path
        if not path:
            raise MeshGroupError("no checkpoint path configured")
        self._require_ready()
        self._gang_call(
            [w.save_state.remote(path, step, keys) for w in self.workers],
            timeout=timeout or GLOBAL_CONFIG.mesh_group_step_timeout_s,
            what="save_state",
        )
        return path

    def restore_state(self, path: Optional[str] = None, *,
                      keys: Optional[List[str]] = None,
                      timeout: Optional[float] = None) -> int:
        """Reshard-restore state from a sharded checkpoint onto the
        CURRENT mesh (any source mesh shape). Returns the checkpoint
        step."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        path = path or self.checkpoint_path
        if not path:
            raise MeshGroupError("no checkpoint path configured")
        self._require_ready()
        out = self._gang_call(
            [w.restore_state.remote(path, keys) for w in self.workers],
            timeout=timeout or GLOBAL_CONFIG.mesh_group_step_timeout_s,
            what="restore_state",
        )
        return out[0]

    # -- failure recovery ----------------------------------------------

    def recover(self, mesh_shape=None, *, hosts: Optional[int] = None,
                devices_per_host: Optional[int] = None,
                state_init: Optional[Callable] = None,
                restore_from: Optional[str] = None,
                attempts: int = 3) -> Optional[int]:
        """Rebuild a broken (or live) gang and resume from the last
        sharded checkpoint.

        Tears the old gang down, re-places fresh processes — optionally
        onto a NEW ``mesh_shape`` / ``hosts`` (shrink or grow) — re-runs
        the rendezvous under a bumped epoch (a new process group), re-
        compiles every registered step, re-runs ``state_init`` to lay out
        fresh state on the new mesh, and reshard-restores the checkpoint
        onto it. Returns the restored checkpoint step (None when there
        was nothing to restore).
        """
        if mesh_shape is not None:
            self.axis_names, self.sizes = normalize_mesh_shape(
                mesh_shape, None if isinstance(mesh_shape, dict)
                else self.axis_names
            )
        if hosts is not None:
            self.hosts = hosts
        if devices_per_host is not None:
            self.devices_per_host = devices_per_host
        init = state_init or self.state_init
        path = restore_from or self.checkpoint_path
        self._validate_shape()
        self._teardown(note="recovering")
        self._bring_up(attempts=attempts)
        for step_id, (fn, plan) in self._step_registry.items():
            self._gang_call(
                [w.compile_step.remote(step_id, fn, plan)
                 for w in self.workers],
                timeout=120.0, what=f"recompile:{step_id}",
            )
        if init is not None:
            self.run(init)
        restored = None
        if path:
            from ray_tpu_torch.train.sharded_checkpoint import is_committed

            if is_committed(path):
                if init is None:
                    # fresh ranks have EMPTY state: restoring into it
                    # would silently restore nothing — the target
                    # layouts must exist first
                    self.state = BROKEN
                    self.last_failure = "recover: no state_init"
                    self._publish_registry()
                    raise MeshGroupError(
                        f"mesh group {self.name!r}: a committed "
                        f"checkpoint exists at {path} but no state_init "
                        f"is configured — recover() needs it (or pass "
                        f"state_init=) to lay out the target shardings "
                        f"the reshard-restore loads into"
                    )
                restored = self.restore_state(path)
        self.last_failure = ""
        self._publish_registry()
        return restored

    # -- data-plane composition ----------------------------------------

    def member_node_ids(self) -> List[str]:
        """Rank-ordered member node ids (hex) — the shard->node map the
        streaming data plane routes block production with (one entry per
        rank: the port runs one process per card)."""
        return [m["node_id"] for m in self.members]

    def split_dataset(self, ds, n_per_host: int = 1) -> List:
        """Per-rank ingest iterators for ``ds``, placement-routed onto
        this gang: shard ``i``'s producing tasks are soft-pinned to rank
        ``i``'s node (its consumer's reads become same-arena zero-copy
        maps) and earlier stages stay on gang-labeled nodes via the
        ``raytpu.io/gang`` stamp. Returns ``len(members) * n_per_host``
        :class:`~ray_tpu_torch.data.iterator.DataIterator`\\ s in rank-major
        order; consume them with
        ``iter_device_batches(prefetch_blocks=...)`` so block arrival
        (windowed striped pulls into the local arena) overlaps
        ``run_step``. The reference's members are hosts; the port's are
        ranks, so the hints repeat each rank's node."""
        self._require_ready()
        hints = [
            nid for nid in self.member_node_ids()
            for _ in range(max(1, n_per_host))
        ]
        return ds.streaming_split(
            len(hints), locality_hints=hints, gang=self.name
        )

    # -- observability / lifecycle -------------------------------------

    def _host_node_ids(self) -> List[str]:
        n = self.ranks_per_host
        return [m.get("node_id") for m in self.members[::n]]

    def stats(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "state": self.state,
            "epoch": self.epoch,
            "hosts": self.hosts,
            "world_size": self.world_size,
            "mesh_shape": dict(zip(self.axis_names, self.sizes)),
            "steps_run": self.steps_run,
            "members": self._host_node_ids(),
            "last_failure": self.last_failure,
            "heal_state": self.heal_state,
        }

    def status(self) -> Dict[str, Any]:
        """Gang status incl. the heal FSM state (HEALING / WAITING_HOST
        / RECOVERING / DEGRADED, "" when no heal is in flight) — the
        same record the GCS mesh-group registry and member ``node_
        stats`` surface."""
        return self.stats()

    def heal(self, **kwargs) -> Dict[str, Any]:
        """Drive the configured heal policy: wait (bounded) for the
        replacement host filed at failure time, then recover() at the
        ORIGINAL mesh shape — or shrink-recover when ``heal_timeout_s``
        expires. Requires ``heal_policy=`` at construction."""
        if self.heal_policy is None:
            raise MeshGroupError(
                f"mesh group {self.name!r} has no heal_policy — pass "
                f"heal_policy=GangHealer(provider) to the constructor"
            )
        return self.heal_policy.heal(self, **kwargs)

    def _registry_record(self) -> Dict[str, Any]:
        """The GCS registry record: ``members`` one node per host (host
        order), ``host_index`` node -> host, ``ranks`` node -> the ranks
        of its processes."""
        ranks: Dict[str, List[int]] = {}
        for i, m in enumerate(self.members):
            ranks.setdefault(m.get("node_id"), []).append(i)
        hosts = self._host_node_ids()
        return {
            "name": self.name,
            "state": self.state,
            "epoch": self.epoch,
            "hosts": self.hosts,
            "world_size": self.world_size,
            "mesh_shape": dict(zip(self.axis_names, self.sizes)),
            "axis_names": list(self.axis_names),
            "steps_run": self.steps_run,
            "members": hosts,
            "host_index": {nid: h for h, nid in enumerate(hosts)},
            "ranks": ranks,
            "last_failure": self.last_failure,
            "heal_state": self.heal_state,
        }

    def _gcs_call(self, method: str, payload,
                  timeout: float = 10.0) -> Any:
        """Best-effort GCS registry traffic: a GCS mid-restart must not
        fail gang work."""
        from ray_tpu_torch._private.worker import require_connected

        try:
            return require_connected().gcs.call(method, payload,
                                                timeout=timeout)
        except Exception as e:
            logger.debug("mesh registry %s skipped: %r", method, e)
            return None

    def _publish_registry(self):
        self._gcs_call("mesh_group_update", self._registry_record())

    def _publish_registry_periodic(self):
        """Steps-counter refresh from the run_step hot path: pure
        observability, so it gets a SHORT timeout and a cooldown after
        a failure — a GCS mid-restart must cost lockstep training at
        most one 2s stall per 30s, not 10s every 16 steps."""
        now = time.monotonic()
        if now < self._registry_quiet_until:
            return
        ok = self._gcs_call("mesh_group_update", self._registry_record(),
                            timeout=2)
        self._registry_quiet_until = 0.0 if ok else now + 30.0

    def _stamp_gang_labels(self, node_ids: List[str], clear: bool = False):
        from ray_tpu_torch._private.protocol import LABEL_GANG

        for nid in node_ids:
            if clear:
                # compare-and-clear: a teardown running off a stale
                # member list (the node was freed and a successor gang
                # stamped it) must not wipe the successor's label
                self._gcs_call(
                    "update_node_labels",
                    [bytes.fromhex(nid), {LABEL_GANG: None},
                     {LABEL_GANG: self.name}],
                )
            else:
                self._gcs_call(
                    "update_node_labels",
                    [bytes.fromhex(nid), {LABEL_GANG: self.name}],
                )

    def _teardown(self, note: str = "", keep_registry: bool = False):
        """Release actors + bundles (and clear gang labels). Workers are
        killed (SIGKILL), never awaited: a survivor may be wedged in a
        dead rank's collective. State and registry handling is the
        caller's job."""
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.members:
            try:
                self._stamp_gang_labels(self._host_node_ids(), clear=True)
            except Exception:
                pass
        self.members = []
        if self.pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )

            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
        if not keep_registry and note:
            logger.debug("mesh group %s teardown: %s", self.name, note)

    def shutdown(self):
        """Kill the gang, release the placement group, drop the registry
        entry and gang labels."""
        self._teardown(note="shutdown")
        self.state = SHUTDOWN
        self._gcs_call("mesh_group_remove", self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
