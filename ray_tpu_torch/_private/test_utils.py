"""Test/chaos utilities.

Parity: reference ``python/ray/_private/test_utils.py`` — ``NodeKillerActor
:1400`` / ``kill_raylet:1741``: random fault injection used by the nightly
chaos suite to prove lineage reconstruction + actor restart under fire.

Two chaos planes compose here:
- :func:`network_chaos` — message-level faults (drop/delay/dup/partition/
  blackout) via ``_private/chaos.py``, seeded + deterministic.
- :class:`ChaosKiller` — process-level faults (SIGKILL workers/raylets).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import chaos


def assert_no_leaks(cluster=None, timeout_s: float = 10.0,
                    check_intents: bool = True):
    """Teardown helper for the resource-lifecycle ledger: poll every
    alive raylet's ``node_stats["leaks"]`` section (open transfer sinks,
    held creator pins, unreleased peer-pool connections, partial serves,
    worker-side unsealed creates and actor-window credits) until every
    counter is zero, and — with ``check_intents`` — assert the GCS
    autoscaler-intent table is empty (a leftover intent is a provisioning
    WAL entry whose heal never completed or cleaned up).

    Polls because the raylet's worker fan-out is cached ~2s and
    background release paths (pool returns, sink unregisters) may still
    be draining when the workload's last result lands. Nodes whose
    raylet process has exited (chaos kills) are skipped — their ledger
    died with them.
    """
    import ray_tpu_torch._private.rpc as rpc_mod
    from ray_tpu_torch._private import worker as worker_mod

    if cluster is None:
        cluster = worker_mod.global_worker.cluster
        assert cluster is not None, "no cluster to audit (not connected?)"
    # accept both the cluster_utils.Cluster wrapper and the impl-level
    # node.Cluster that ray_tpu_torch.init() stores on the global worker
    impl = getattr(cluster, "_impl", cluster)

    deadline = time.monotonic() + timeout_s
    last: Dict[str, Dict] = {}
    while True:
        last = {}
        clean = True
        for n in impl.nodes.values():
            if n.proc.poll() is not None:
                continue
            try:
                client = rpc_mod.Client.connect(n.raylet_addr, timeout=5)
                try:
                    stats = client.call("node_stats", None, timeout=5)
                finally:
                    client.close()
            except Exception as e:
                clean = False
                last[n.node_id.hex()] = {"unreachable": str(e)}
                continue
            leaks = dict(stats.get("leaks") or {})
            last[n.node_id.hex()] = leaks
            if any(leaks.values()):
                clean = False
        # the connected driver's own ledger, checked directly (it is
        # also in the raylet fan-out, but that view is ~2s stale)
        cw = getattr(worker_mod.global_worker, "core_worker", None)
        if cw is not None:
            mine = cw.leak_stats()
            last["driver"] = mine
            if any(mine.values()):
                clean = False
        if check_intents:
            try:
                client = rpc_mod.Client.connect(impl.gcs_addr, timeout=5)
                try:
                    intents = client.call("autoscaler_intent_table",
                                          None, timeout=5) or {}
                finally:
                    client.close()
            except Exception as e:
                intents = {"unreachable": str(e)}
            if intents:
                clean = False
                last["gcs_intents"] = dict(intents)
        if clean:
            return
        if time.monotonic() >= deadline:
            raise AssertionError(f"resource leaks at teardown: {last}")
        time.sleep(0.25)


@contextlib.contextmanager
def network_chaos(spec: Dict, role: str = "driver"):
    """Export a chaos spec to the environment (inherited by every daemon
    and worker a subsequently-started cluster spawns) AND install it in
    this process; restores both on exit. Start the cluster INSIDE the
    context or the daemons won't see the spec."""
    old = os.environ.get(chaos.ENV_SPEC)
    os.environ[chaos.ENV_SPEC] = json.dumps(spec)
    plane = chaos.install(spec, role=role)
    try:
        yield plane
    finally:
        if old is None:
            os.environ.pop(chaos.ENV_SPEC, None)
        else:
            os.environ[chaos.ENV_SPEC] = old
        chaos.uninstall()


class ChaosKiller:
    """Driver-side chaos thread: randomly SIGKILLs worker processes (and
    optionally whole raylets) of a simulated ``cluster_utils.Cluster`` while
    a workload runs. Tasks with retries / lineage must still complete."""

    def __init__(self, cluster, *, kill_interval_s: float = 0.5,
                 kill_nodes: bool = False, seed: int = 0,
                 spare_head: bool = True):
        self.cluster = cluster
        self.kill_interval_s = kill_interval_s
        self.kill_nodes = kill_nodes
        self.spare_head = spare_head
        self.rng = random.Random(seed)
        self.kills = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- targets --
    def _worker_procs(self) -> List[int]:
        import os

        raylet_pids = {
            n.proc.pid
            for n in self.cluster._impl.nodes.values()
            if n.proc.poll() is None
        }
        procs = []
        try:
            # workers are children of raylets: find them via /proc
            for pid in os.listdir("/proc"):
                if not pid.isdigit():
                    continue
                try:
                    with open(f"/proc/{pid}/stat") as f:
                        ppid = int(f.read().split()[3])
                    if ppid in raylet_pids:
                        with open(f"/proc/{pid}/cmdline") as f:
                            cmd = f.read()
                        if "worker_main" in cmd:
                            procs.append(int(pid))
                except (OSError, ValueError, IndexError):
                    continue
        except OSError:
            pass
        return procs

    def _kill_once(self):
        import os
        import signal

        if self.kill_nodes and self.rng.random() < 0.3:
            handles = list(self.cluster._impl.nodes.values())
            nodes = handles[1:] if self.spare_head else handles
            if nodes:
                victim = self.rng.choice(nodes)
                try:
                    self.cluster.remove_node(victim)
                    self.kills += 1
                except Exception:
                    pass
                return
        pids = self._worker_procs()
        if pids:
            try:
                os.kill(self.rng.choice(pids), signal.SIGKILL)
                self.kills += 1
            except OSError:
                pass

    # -- lifecycle --
    def start(self):
        def loop():
            while not self._stop.is_set():
                time.sleep(self.kill_interval_s)
                self._kill_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.kills
