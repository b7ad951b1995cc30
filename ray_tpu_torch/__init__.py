"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports), in two halves.

The runtime (this module's API): ``init / shutdown / remote / get / put /
wait / kill / cancel / get_actor / method / available_resources /
cluster_resources / nodes / get_runtime_context``, placement groups
(``util/placement_group.py``) and ``cluster_utils.Cluster``, over the
port's own copy of the control plane (``_private/gcs.py``), the node plane
(``_private/raylet.py``, the shared-memory store and the native conduit,
built from ``src/`` into ``ray_tpu_torch/_build/``) and the execution
plane (``_private/core_worker.py``). Its accelerator resource is ``GPU``,
counted from CUDA at ``init()``; ``num_gpus=`` asks for it. Importing this
package loads no torch, so CPU workers start without it.

The model half, imported by the code that uses it: ``ops/`` (hand-written
CUDA C++ kernels for Hopper: flash attention forward and backward, an int8
weight-only matmul, decode attention), ``models/`` (``transformer.py``,
``generation.py``, ``convert.py``, ``quant.py``), ``parallel/`` (the mesh,
the train step, the pipeline), ``data/``, ``train/``, ``serve/llm.py``,
``rllib/`` (learners on the card, env runners on CPU actors) and
``graphs.py``. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID  # noqa: F401
from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch._private.worker import (  # noqa: F401
    global_worker,
    init,
    require_connected,
    shutdown,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "ObjectRef", "available_resources",
    "cluster_resources", "nodes", "exceptions", "method", "get_runtime_context",
]


def is_initialized() -> bool:
    return global_worker.connected


def remote(*args, **kwargs):
    """Decorator: turn a function into a task / a class into an actor."""

    def make(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, **kwargs)
        return RemoteFunction(obj, **kwargs)

    if len(args) == 1 and not kwargs and (
        inspect.isfunction(args[0]) or inspect.isclass(args[0])
    ):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return make


def method(num_returns: int = 1):
    """Decorator marking actor-method return arity (parity: ray.method)."""

    def deco(fn):
        fn.__ray_num_returns__ = num_returns
        return fn

    return deco


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
):
    cw = require_connected()
    single = isinstance(refs, ObjectRef)
    lst = [refs] if single else list(refs)
    for r in lst:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get takes ObjectRefs, got {type(r)}")
    out = cw.get(lst, timeout=timeout)
    return out[0] if single else out


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return require_connected().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    cw = require_connected()
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns > number of refs")
    return cw.wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor: ActorHandle, *, no_restart: bool = True):
    require_connected().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task producing ``ref`` (parity: worker.py:2806 +
    CoreWorker cancellation). Queued/unscheduled tasks are dropped and their
    returns resolve to TaskCancelledError; a task already running to
    completion is not interrupted (returns False). ``force``/``recursive``
    accepted for API parity; interruptive force-kill requires executor
    preemption, which the single-threaded JAX executor deliberately avoids."""
    return require_connected().cancel_task(ref)


def get_actor(name: str) -> ActorHandle:
    cw = require_connected()
    rec = cw.get_named_actor(name)
    return ActorHandle(rec["actor_id"], name,
                       method_meta=rec.get("method_meta") or {})


def nodes() -> List[Dict]:
    cw = require_connected()
    return cw.gcs.call("get_all_nodes", None)


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n.get("alive", True):
            for k, v in (n.get("resources") or {}).items():
                total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    """Currently-available resources across alive nodes (from raylet stats)."""
    cw = require_connected()
    import ray_tpu_torch._private.rpc as rpc_mod

    out: Dict[str, float] = {}
    for n in nodes():
        if not n.get("alive", True):
            continue
        try:
            client = rpc_mod.Client.connect(n["raylet_addr"], timeout=5)
            stats = client.call("node_stats", None, timeout=5)
            client.close()
            for k, v in stats.get("available", {}).items():
                out[k] = out.get(k, 0.0) + v
        except Exception:
            continue
    return out
