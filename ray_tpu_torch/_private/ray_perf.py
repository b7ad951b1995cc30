"""Core microbenchmarks — the perf regression floor (the PyTorch port of
``ray_tpu/_private/ray_perf.py``).

Parity: reference ``python/ray/_private/ray_perf.py:93`` (single/multi
client task, actor-call, and put/get throughput timers — the canonical
core-perf gate run nightly). Run directly::

    python -m ray_tpu_torch._private.ray_perf

or call :func:`run_microbenchmarks` programmatically.

Importing this module loads no torch. The host-plane legs (transfer,
broadcast, GCS plane, GCS failover, serving scale) run no torch at all; the
gang legs (``run_mesh_group_bench``, ``run_mesh_heal_bench``,
``run_data_plane_bench``) run torch steps on the ``device`` they are given:
CUDA by default, one card per rank (they raise with fewer), or gloo ranks on
the CPU when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

# the directory that holds this package: first on a leg's PYTHONPATH, so
# the leg imports this checkout whatever its working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _timeit(fn, n: int) -> float:
    """Ops/second of fn() called n times (one warmup batch). GC is
    paused during the timed region — the stdlib ``timeit`` the reference
    perf suite builds on does the same (a gen0 pause mid-burst is
    measurement noise, not steady-state cost)."""
    import gc

    fn()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return n / (time.perf_counter() - t0)
    finally:
        if was_enabled:
            gc.enable()


_TRANSFER_BENCH_CODE = """
import json, sys, time
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch._private import rpc

size_mb = int(sys.argv[1])
store = max(size_mb * 2, 256) * 1024 * 1024


def measure(extra_config):
    # the bench measures the raylet-to-raylet transfer plane: no
    # workers are involved, and their boot must not timeshare the
    # measurement on small CI boxes
    cfg = {
        "object_store_memory_bytes": store,
        "prestart_workers": False,
        "log_to_driver": False,
    }
    cfg.update(extra_config)
    c = Cluster(
        initialize_head=True,
        head_node_args={"resources": {"CPU": 2, "head": 1}},
        system_config=cfg,
    )
    c.add_node(num_cpus=1, resources={"other": 1})
    c.connect()
    try:
        arr = np.random.randint(0, 255, size_mb * 1024 * 1024,
                                dtype=np.uint8)
        ref = ray_tpu_torch.put(arr)
        head_hex = c.head_node.node_id.hex()
        other = [n for n in ray_tpu_torch.nodes()
                 if n["node_id"].hex() != head_hex][0]
        cli = rpc.Client.connect(other["raylet_addr"],
                                 name="transfer-bench")
        cli.call("node_stats", None, timeout=30)  # warm the connection
        best = 0.0
        nbytes = 0
        for i in range(3):  # best-of-3: shared CI boxes are noisy
            t0 = time.perf_counter()
            ok = cli.call("pull_object", ref.binary(), timeout=600,
                          retry=False)
            dt = time.perf_counter() - t0
            assert ok is True, "pull failed"
            meta = cli.call("read_object_meta", ref.binary(), timeout=30)
            assert meta and meta["size"] >= size_mb * 1024 * 1024
            nbytes = meta["size"]
            best = max(best, nbytes / dt)
            if i < 2:  # drop the local copy so the next pull is real
                cli.call("free_local_object", ref.binary(), timeout=30)
        return round(best / 1e9, 3), nbytes
    finally:
        c.shutdown()
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass


# default config: two local raylets use the same-host shm fast path
shm_gbps, nbytes = measure({})
# socket plane: windowed + striped + zero-copy raw chunk frames
sock_gbps, _ = measure({"object_transfer_same_host_shm": False})
print(json.dumps({
    "transfer_gbps": shm_gbps,
    "transfer_socket_gbps": sock_gbps,
    "bytes": nbytes,
}))
"""


def _run_isolated(label: str, code: str, argv=(),
                  timeout: int = 900) -> Dict[str, float]:
    """Shared subprocess harness for the isolated-cluster benches:
    scrubbed env (own cluster, no inherited chaos or cluster address; the
    devices stay visible: each leg takes its device by argument), this
    checkout's package first on the path, last-JSON-line result protocol,
    stderr tail on failure. Every bench wrapper routes through here so an
    env-scrub or parse fix lands once, not four times."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("RAYTPU_CHAOS_SPEC", None)  # a chaotic bench is not a bench
    env.pop("RAYTPU_ADDRESS", None)     # own cluster, not the caller's
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    r = subprocess.run(
        [sys.executable, "-c", code, *[str(a) for a in argv]],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    for line in reversed(r.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"{label} bench produced no result (rc={r.returncode}): "
        f"{r.stderr[-500:]}"
    )


def run_transfer_bench(size_mb: int = 256) -> Dict[str, float]:
    """Two-raylet loopback pull bandwidth: a driver-put object of
    ``size_mb`` MiB is pulled raylet-to-raylet (the windowed/striped
    zero-copy plane) by timing the puller's ``pull_object`` RPC.

    Runs in a SUBPROCESS with its own 2-node cluster so it composes with
    an already-connected driver (the bench gate calls it while its own
    cluster is up) and needs no accelerator (it imports no torch)."""
    return _run_isolated("transfer", _TRANSFER_BENCH_CODE, [size_mb])


_BROADCAST_BENCH_CODE = """
import json, sys, threading, time
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch._private import rpc

size_mb = int(sys.argv[1])
k = int(sys.argv[2])
store = max(size_mb * 2, 192) * 1024 * 1024

c = Cluster(
    initialize_head=True,
    head_node_args={"resources": {"CPU": 2, "head": 1}},
    system_config={
        "object_store_memory_bytes": store,
        "object_transfer_same_host_shm": False,  # exercise the NIC plane
        "object_broadcast_min_bytes": 4 * 1024 * 1024,
        "prestart_workers": False,
        "log_to_driver": False,
    },
)
try:
    nodes = [c.add_node(num_cpus=1, resources={f"p{i}": 1})
             for i in range(k)]
    c.connect()
    arr = np.random.randint(0, 255, size_mb * 1024 * 1024, dtype=np.uint8)
    ref = ray_tpu_torch.put(arr)
    info = {n["node_id"].hex(): n for n in ray_tpu_torch.nodes()}
    head_hex = c.head_node.node_id.hex()
    cli_head = rpc.Client.connect(info[head_hex]["raylet_addr"],
                                  name="bb-head")
    clis = [rpc.Client.connect(info[n.node_id.hex()]["raylet_addr"],
                               name=f"bb-{i}") for i, n in enumerate(nodes)]
    for cl in clis + [cli_head]:
        cl.call("node_stats", None, timeout=30)  # warm the conns
    base_out = cli_head.call(
        "node_stats", None, timeout=30)["transfer"]["bytes_out"]
    results = [None] * k

    def pull(i):
        t0 = time.perf_counter()
        ok = clis[i].call("pull_object", ref.binary(), timeout=600,
                          retry=False)
        results[i] = (ok, time.perf_counter() - t0)

    t_start = time.perf_counter()
    ts = [threading.Thread(target=pull, args=(i,)) for i in range(k)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t_start
    assert all(r and r[0] is True for r in results), results
    head_out = cli_head.call(
        "node_stats", None, timeout=30)["transfer"]["bytes_out"] - base_out
    tree_pulls = sum(
        cl.call("node_stats", None, timeout=30)["transfer"]["tree_pulls"]
        for cl in clis
    )
    print(json.dumps({
        "fanout_seconds": round(wall, 3),
        "egress_ratio": round(head_out / arr.nbytes, 2),
        "aggregate_gbps": round(k * arr.nbytes / wall / 1e9, 3),
        "tree_pulls": tree_pulls,
        "k": k,
        "size_mb": size_mb,
    }))
finally:
    c.shutdown()
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass
"""


def run_broadcast_bench(size_mb: int = 64, k: int = 4) -> Dict[str, float]:
    """Broadcast-tree weight fan-out: ``k`` raylets concurrently pull one
    ``size_mb`` MiB object (the scale-up shape: K new replicas fetching
    the same weights). Records the fan-out wall seconds and the SOURCE
    egress ratio — the tree's whole point is that ratio staying O(fanout)
    instead of K. Subprocess-isolated like the transfer bench."""
    return _run_isolated("broadcast", _BROADCAST_BENCH_CODE, [size_mb, k])


_SERVING_SCALE_CODE = """
import json, threading, time
import ray_tpu_torch
from ray_tpu_torch import serve

ray_tpu_torch.init(num_cpus=8, object_store_memory=192 * 1024 * 1024)
try:
    TOKENS = 25
    TOK_S = 0.02  # per-token service time -> ~1250 tok/s ceiling/replica

    @serve.deployment(
        max_ongoing_requests=4,
        max_queued_requests=64,
        max_queue_wait_s=20.0,
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_ongoing_requests": 4,
            "ttft_slo_ms": 300.0,
            "upscale_delay_s": 1.0,
            "downscale_delay_s": 120.0,
        },
        ray_actor_options={"num_cpus": 0.25},
    )
    class TokenStream:
        def stream(self, req):
            for i in range(req["tokens"]):
                time.sleep(TOK_S)
                yield i

    h = serve.run(TokenStream.bind())
    # warm one stream end to end (replica boot off the clock)
    assert sum(1 for _ in h.stream({"tokens": 2})) == 2

    DURATION = 16.0
    RATE = 11.0  # open-loop arrivals/s: ~2x one replica's capacity
    lock = threading.Lock()
    ttfts, rejected, failed, tokens_done = [], [0], [0], [0]
    stop_at = time.monotonic() + DURATION

    def client(delay):
        time.sleep(delay)
        t0 = time.monotonic()
        try:
            it = h.stream({"tokens": TOKENS})
            got = 0
            for i, _ in enumerate(it):
                if i == 0:
                    with lock:
                        ttfts.append((time.monotonic() - t0, t0))
                got += 1
            with lock:
                tokens_done[0] += got
        except serve.BackpressureError:
            with lock:
                rejected[0] += 1
        except Exception:
            with lock:
                failed[0] += 1

    n = int(DURATION * RATE)
    threads = [
        threading.Thread(target=client, args=(i / RATE,)) for i in range(n)
    ]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.monotonic() - t_start

    ctrl = serve._get_or_start_controller()
    m = ray_tpu_torch.get(
        ctrl.deployment_metrics.remote("TokenStream"), timeout=30
    )
    replicas = m.get("num_replicas", 1)
    # steady-state TTFT: samples from the second half of the run (the
    # scale-up transient is the first half's story)
    mid = t_start + DURATION / 2
    late = sorted(t for t, at in ttfts if at >= mid)
    all_t = sorted(t for t, _ in ttfts)
    pct = lambda v, q: v[min(len(v) - 1, int(len(v) * q))] * 1e3 if v else None
    print(json.dumps({
        "submitted": n,
        "completed": len(ttfts),
        "rejected": rejected[0],
        "failed": failed[0],
        "replicas_final": replicas,
        "ttft_p50_ms": round(pct(all_t, 0.50) or 0, 1),
        "ttft_p95_ms": round(pct(all_t, 0.95) or 0, 1),
        "steady_ttft_p95_ms": round(pct(late, 0.95) or 0, 1),
        "tokens_per_s": round(tokens_done[0] / wall, 1),
        "tokens_per_s_per_replica": round(
            tokens_done[0] / wall / max(1, replicas), 1
        ),
        "rejected_ratio": round(rejected[0] / n, 3),
        "router": {
            k: v for k, v in m.items()
            if k in ("ongoing", "queued", "rejected_total", "routed_total",
                     "ttft_p95_ms")
        },
    }))
finally:
    ray_tpu_torch.shutdown()
"""


_MESH_GROUP_BENCH_CODE = """
import json, sys, time
import numpy as np
from torch.distributed.tensor import Replicate, Shard
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.mesh import MeshGroup, StateKey

device = sys.argv[1]
gpu = {"GPU": 2} if device == "cuda" else {}
c = Cluster(
    initialize_head=True,
    head_node_args={"resources": {"CPU": 3, **gpu}},
    system_config={"prestart_workers": False, "log_to_driver": False},
)
try:
    c.add_node(num_cpus=3, num_gpus=gpu.get("GPU"))
    c.connect()
    t0 = time.perf_counter()
    mg = MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                   devices_per_host=2, name="bench_gang",
                   resources_per_host={"CPU": 2, **gpu} if gpu else None)
    spinup_s = time.perf_counter() - t0

    def _card(device):
        # the uuid of the rank's card (None on the CPU): ranks that each
        # see their card as cuda:0 still name distinct cards
        import torch
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return str(torch.cuda.get_device_properties(device).uuid)

    def init_state(ctx):
        import torch
        from torch.distributed.tensor import Shard, distribute_tensor
        glob = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
        ctx.state["w"] = distribute_tensor(
            glob.to(ctx.device), ctx.mesh, (Shard(0), Shard(1)),
            src_data_rank=None)
        return ctx.device, _card(ctx.device)

    def train_step(w, b):
        w = w * 0.999 + b[:, None]
        return w, w.sum()

    held = mg.run(init_state)
    t0 = time.perf_counter()
    sid = mg.compile_step_with_plan(
        train_step,
        in_shardings=((Shard(0), Shard(1)), (Shard(0), Replicate())),
        out_shardings=((Shard(0), Shard(1)), (Replicate(), Replicate())),
        donate_argnums=(0,),
    )
    compile_s = time.perf_counter() - t0
    batch = np.ones((64,), np.float32)
    # warmup + timed loop: each iteration is a full gang-coherent
    # lockstep dispatch (controller -> 4 ranks -> DTensor step and its
    # collectives)
    for _ in range(3):
        mg.run_step(sid, StateKey("w"), batch, store={0: "w"})
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        mg.run_step(sid, StateKey("w"), batch, store={0: "w"})
        n += 1
    steps_per_s = n / (time.perf_counter() - t0)
    mg.shutdown()
    print(json.dumps({
        "spinup_s": round(spinup_s, 2),
        "compile_s": round(compile_s, 2),
        "steps_per_s": round(steps_per_s, 1),
        "hosts": 2,
        "mesh_shape": "dp2xtp2",
        "devices": [d for d, _ in held],
        "cards": [u for _, u in held],
    }))
finally:
    c.shutdown()
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass
"""


_MESH_HEAL_BENCH_CODE = """
import json, sys, time
import numpy as np
from torch.distributed.tensor import Replicate, Shard
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.mesh import GangHealer, MeshGroup, RankFailedError, StateKey

device = sys.argv[1]
gpu = {"GPU": 2} if device == "cuda" else {}
c = Cluster(
    initialize_head=True,
    head_node_args={"resources": {"CPU": 3, **gpu}},
    system_config={
        "prestart_workers": False, "log_to_driver": False,
        # node death declared after 2s of missed health checks: the
        # bench measures the HEAL loop, not the default 10s detector
        "health_check_timeout_ms": 2000,
    },
)
try:
    n1 = c.add_node(num_cpus=3, num_gpus=gpu.get("GPU"))
    c.connect()
    from ray_tpu_torch.cloud_provider import MockTpuApi, QueuedResourceProvider

    api = MockTpuApi(grant_delay_s=0.3, provision_delay_s=0.2)
    provider = QueuedResourceProvider(
        # a mock slice name that hosts_for_accelerator maps to one host
        api, accelerator_type="v5p-8",
        host_resources={"CPU": 3, **gpu},
        host_bootstrapper=lambda s, vm, res, labels: c.add_node(
            resources=res, labels=labels),
        host_terminator=lambda h: c.remove_node(h),
    )
    healer = GangHealer(provider, heal_timeout_s=90.0,
                        poll_interval_s=0.1)

    def init_state(ctx):
        import torch
        from torch.distributed.tensor import Shard, distribute_tensor
        glob = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
        ctx.state["w"] = distribute_tensor(
            glob.to(ctx.device), ctx.mesh, (Shard(0), Shard(1)),
            src_data_rank=None)
        return 1

    def train_step(w, b):
        w = w + b[:, None]
        return w, w.sum()

    import tempfile
    ckpt = tempfile.mkdtemp(prefix="heal_bench") + "/ckpt"
    mg = MeshGroup(hosts=2, mesh_shape={"dp": 2, "tp": 2},
                   devices_per_host=2, name="bench_heal_gang",
                   checkpoint_path=ckpt, state_init=init_state,
                   heal_policy=healer,
                   resources_per_host={"CPU": 2, **gpu} if gpu else None)
    mg.run(init_state)
    sid = mg.compile_step_with_plan(
        train_step,
        in_shardings=((Shard(0), Shard(1)), (Shard(0), Replicate())),
        out_shardings=((Shard(0), Shard(1)), (Replicate(), Replicate())),
        donate_argnums=(0,))
    batch = np.ones((8,), np.float32)
    mg.run_step(sid, StateKey("w"), batch, store={0: "w"})
    mg.save_state(step=1)
    # STRICT_SPREAD over exactly {head, n1}: rank on n1 is the victim.
    t_kill = time.perf_counter()
    c.remove_node(n1)
    detect_s = None
    try:
        for _ in range(64):
            mg.run_step(sid, StateKey("w"), batch, store={0: "w"},
                        timeout=60)
    except RankFailedError:
        detect_s = time.perf_counter() - t_kill
    assert detect_s is not None, "gang never saw the node death"
    result = mg.heal()
    assert result["outcome"] == "healed", result
    assert mg.state == "READY" and mg.hosts == 2, (mg.state, mg.hosts)
    mg.run_step(sid, StateKey("w"), batch, store={0: "w"})
    mg.shutdown()
    print(json.dumps({
        "detect_s": round(detect_s, 3),
        "provision_s": round(result["provision_s"], 3),
        "recover_s": round(result["recover_s"], 3),
        "mttr_s": round(detect_s + result["provision_s"]
                        + result["recover_s"], 3),
        "create_calls": api.create_calls,
        "outcome": result["outcome"],
        "healed": 1,
    }))
finally:
    c.shutdown()
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass
"""


_GCS_PLANE_CODE = """
import json, os, subprocess, sys, tempfile, threading, time

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.gcs import GcsJournal

GLOBAL_CONFIG.initialize()
tmp = tempfile.mkdtemp(prefix="gcs_plane_bench")
_n = [0]


def start_gcs(extra_cfg):
    _n[0] += 1
    sock = os.path.join(tmp, f"gcs{_n[0]}.sock")
    storage = os.path.join(tmp, f"gcs{_n[0]}.snapshot")
    cfg = dict(GLOBAL_CONFIG.dump(), gcs_storage_backend="file")
    cfg.update(extra_cfg)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.gcs",
         "--sock", sock, "--config", json.dumps(cfg),
         "--storage", storage],
        stderr=subprocess.DEVNULL,
    )
    deadline = time.monotonic() + 30
    while True:
        try:
            cli = rpc.Client.connect(sock, timeout=2, name="bench-probe")
            cli.call("ping", None, timeout=5)
            return proc, sock, cli
        except Exception:
            assert time.monotonic() < deadline, "GCS never came up"
            time.sleep(0.1)


def mutations_per_s(sock, threads=16, seconds=1.5):
    clis = [rpc.Client.connect(sock, name=f"mut{i}")
            for i in range(threads)]
    for c in clis:
        c.call("ping", None, timeout=10)
    stop_at = time.monotonic() + seconds
    counts = [0] * threads

    def run(i):
        c, k = clis[i], 0
        while time.monotonic() < stop_at:
            c.call("kv_put", [f"bench:{i}:{k % 64}", b"v" * 32, True],
                   timeout=30)
            k += 1
        counts[i] = k

    ts = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    wall = time.monotonic() - t0
    state = clis[0].call("internal_state", None, timeout=10)
    for c in clis:
        c.close()
    return sum(counts) / wall, state


out = {}

# headline: mutations/s through the RPC plane against the DEFAULT
# file-backend config (group commit on, fsync off — durable vs SIGKILL)
proc, sock, cli = start_gcs({})
rate, state = mutations_per_s(sock)
out["gcs_mutations_per_s"] = round(rate, 1)
out["journal_appended"] = state["journal_appended"]
out["journal_flushes"] = state["journal_flushes"]
proc.kill(); proc.wait()

# group-commit A/B at the durability tier it exists for (fsync per
# flush), measured at the JOURNAL itself so the ratio is a property of
# the batching, not of RPC concurrency (the server's single-flight
# executor flush group-commits even at batch_max=1, and fsync cost on
# a shared box varies run to run — an end-to-end ratio flakes):
# per-record append+fsync vs depth-8 batches over identical records.
N_REC = 2000
jp = os.path.join(tmp, "ab_per_record")
j = GcsJournal(jp, fsync=True)
t0 = time.perf_counter()
for i in range(N_REC):
    j.append(["kv", f"k{i % 64}", b"v" * 32])
per_record = N_REC / (time.perf_counter() - t0)
j.close()
jb = os.path.join(tmp, "ab_batched")
j = GcsJournal(jb, fsync=True)
t0 = time.perf_counter()
for i in range(N_REC):
    j.buffer(["kv", f"k{i % 64}", b"v" * 32])
    if j.buffered >= 8:
        j.flush_buffered()
j.flush_buffered()
batched = N_REC / (time.perf_counter() - t0)
j.close()
out["journal_per_record_fsync_per_s"] = round(per_record, 1)
out["journal_batched8_fsync_per_s"] = round(batched, 1)
out["group_commit_speedup"] = round(batched / max(per_record, 1e-9), 2)

# informational: RPC-plane mutations/s with fsync-per-flush batching
# on (durable-at-ack at the power-loss tier); not gated — end-to-end
# fsync cost on a shared box is too run-dependent to floor
proc, sock, cli = start_gcs({"gcs_journal_fsync": True})
fsync_rate, _ = mutations_per_s(sock)
out["mutations_per_s_fsync_batched"] = round(fsync_rate, 1)
proc.kill(); proc.wait()

# pubsub fan-out latency: one publish -> N subscribed clients
N_SUBS = 16
proc, sock, cli = start_gcs({})
events = [threading.Event() for _ in range(N_SUBS)]


def make_handler(i):
    async def handler(conn, method, data):
        if method == "publish":
            events[i].set()
        return None
    return handler


subs = [rpc.Client.connect(sock, handler=make_handler(i), name=f"sub{i}")
        for i in range(N_SUBS)]
for s in subs:
    s.call("subscribe", ["logs"], timeout=10)
lat = []
for round_i in range(30):
    for e in events:
        e.clear()
    t0 = time.perf_counter()
    cli.call("publish_logs", [["bench", round_i]], timeout=10)
    for e in events:
        assert e.wait(10), "subscriber never saw the publish"
    lat.append(time.perf_counter() - t0)
lat.sort()
out["pubsub_subscribers"] = N_SUBS
out["pubsub_fanout_p50_ms"] = round(lat[len(lat) // 2] * 1e3, 2)
out["pubsub_fanout_p95_ms"] = round(lat[int(len(lat) * 0.95)] * 1e3, 2)
proc.kill(); proc.wait()

# journal replay rate (restore-time bound): 100k-record log
jpath = os.path.join(tmp, "replay.journal")
j = GcsJournal(jpath)
for i in range(100_000):
    j.buffer(["kv", f"k{i % 1024}", b"x" * 64])
    if j.buffered >= 512:
        j.flush_buffered()
j.close()
t0 = time.perf_counter()
n = sum(1 for _ in GcsJournal.replay(jpath))
dt = time.perf_counter() - t0
assert n == 100_000, n
out["journal_replay_entries_per_s"] = round(n / dt, 1)
out["journal_replay_100k_s"] = round(dt, 3)

print(json.dumps(out))
"""


_GCS_FAILOVER_CODE = """
import json, os, subprocess, sys, tempfile, threading, time

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG

GLOBAL_CONFIG.initialize()
tmp = tempfile.mkdtemp(prefix="gcs_failover_bench")
primary_sock = "unix:" + os.path.join(tmp, "gcs-primary.sock")
standby_sock = "unix:" + os.path.join(tmp, "gcs-standby.sock")
multi = primary_sock + "," + standby_sock
cfg = dict(
    GLOBAL_CONFIG.dump(),
    gcs_storage_backend="file",
    gcs_standby=True,
    gcs_standby_ack=True,            # durable-at-ack = standby-applied
    gcs_snapshot_interval_s=3600.0,  # the journal carries everything
    gcs_failover_grace_s=1.0,
)
primary_cmd = [
    sys.executable, "-m", "ray_tpu_torch._private.gcs",
    "--sock", primary_sock, "--config", json.dumps(cfg),
    "--storage", os.path.join(tmp, "gcs.pkl"),
    "--peers", standby_sock,
]
primary = subprocess.Popen(primary_cmd, stderr=subprocess.DEVNULL)
standby = subprocess.Popen(
    [sys.executable, "-m", "ray_tpu_torch._private.gcs_standby",
     "--sock", standby_sock, "--primary", primary_sock,
     "--storage", os.path.join(tmp, "gcs-standby.pkl"),
     "--config", json.dumps(cfg)],
    stderr=subprocess.DEVNULL,
)
probe = rpc.Client.connect(multi, timeout=30, name="bench-probe")
deadline = time.monotonic() + 30
while True:
    st = probe.call("internal_state", None, timeout=10)
    if st["standbys"] == 1:
        break
    assert time.monotonic() < deadline, "standby never subscribed"
    time.sleep(0.1)

out = {}
N_THREADS = 8
acked = [[] for _ in range(N_THREADS)]
stop = threading.Event()
clis = [rpc.Client.connect(multi, name=f"mut{i}") for i in range(N_THREADS)]
for c in clis:
    c.call("ping", None, timeout=10)


def run(i):
    c, k = clis[i], 0
    while not stop.is_set():
        try:
            if c.call("kv_put", [f"fo:{i}:{k}", b"v" * 32, True],
                      timeout=30):
                acked[i].append(k)
        except Exception:
            pass  # un-acked: allowed to be lost
        k += 1


ts = [threading.Thread(target=run, args=(i,)) for i in range(N_THREADS)]
t0 = time.monotonic()
for t in ts:
    t.start()
time.sleep(1.2)  # sustained load window before the kill
pre_kill_acks = sum(len(a) for a in acked)
t_kill = time.monotonic()
out["load_mutations_per_s"] = round(pre_kill_acks / (t_kill - t0), 1)
primary.kill()
primary.wait()

# MTTR: first successful control-plane RPC served by the PROMOTED
# standby (epoch 2) after the SIGKILL, measured through the same
# multi-endpoint reconnect cycling every client uses
while True:
    try:
        st = probe.call("internal_state", None, timeout=5)
        if st["epoch"] >= 2:
            break
    except Exception:
        pass
    assert time.monotonic() - t_kill < 60, "standby never promoted"
    time.sleep(0.05)
out["gcs_failover_mttr_s"] = round(time.monotonic() - t_kill, 2)

time.sleep(1.0)  # keep mutating against the new primary
stop.set()
for t in ts:
    t.join(timeout=120)
out["total_acked"] = sum(len(a) for a in acked)

# zero lost acks: every mutation a client saw acked must be readable
# at the promoted primary
lost = 0
for i in range(N_THREADS):
    for k in acked[i]:
        if probe.call("kv_get", f"fo:{i}:{k}", timeout=15) != b"v" * 32:
            lost += 1
out["acks_lost"] = lost

# split-brain rejection: the resurrected old primary must fence itself
# against the promoted peer and exit 3
old = subprocess.Popen(primary_cmd, stderr=subprocess.DEVNULL)
rc = old.wait(timeout=30)
out["old_primary_fenced"] = 1 if rc == 3 else 0
st = probe.call("internal_state", None, timeout=10)
out["post_failover_epoch"] = st["epoch"]

for c in clis:
    c.close()
probe.close()
standby.kill(); standby.wait()

print(json.dumps(out))
"""


_DATA_PLANE_CODE = """
import json, os, sys, time

device = sys.argv[1]
# Core separation, the CPU-box stand-in for "the step runs on the card,
# ingest on host CPUs": everything spawned from here (raylets, workers,
# the coordinator actor) inherits the UPPER half of the machine; rank
# processes re-pin to the lower half (_pin below). On a small box the pin
# is a no-op and the measurement simply carries the timeshare noise.
try:
    _ncpu = os.cpu_count() or 0
    if _ncpu >= 16:
        os.sched_setaffinity(0, set(range(_ncpu // 2, _ncpu)))
except Exception:
    pass
import numpy as np
import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu_torch._private import rpc
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.mesh import MeshGroup

out = {}

# ---- leg 1: streaming ingest into a RUNNING 2-host gang ----
# 16 columnar 4 MiB blocks (64 MiB) are produced placement-routed onto
# the rank-host that consumes them, prefetched over the zero-copy pull
# plane, and fed through a per-rank torch step timed SYNCHRONOUSLY (a
# synchronize on the step's device per step — "step time" is only
# observable when each step completes before the next batch is demanded);
# the gate compares the epoch wall against the SAME compute over
# pre-staged batches already on the device.
N_BLOCKS, ROWS_PER, DIM = 16, 4096, 256  # 4 MiB per block

gpu = {"GPU": 1} if device == "cuda" else {}
c = Cluster(
    initialize_head=True,
    head_node_args={"resources": {"CPU": 6, **gpu}},
    system_config={
        "prestart_workers": False,
        "log_to_driver": False,
        # ingest tasks soft-pin to rank hosts whose slots breathe with
        # the pipeline: spill off a transiently-saturated hint fast —
        # the bench epoch is short, 200 ms of parked locality is a stall
        "soft_affinity_spill_after_s": 0.05,
    },
)
try:
    c.add_node(num_cpus=6, num_gpus=gpu.get("GPU"))
    c.connect()
    mg = MeshGroup(hosts=2, mesh_shape={"dp": 2}, devices_per_host=1,
                   name="data_plane_gang",
                   resources_per_host={"CPU": 1, **gpu} if gpu else None)

    def make_block(b, _r=ROWS_PER, _d=DIM):
        import numpy as np
        return {"x": np.full((_r, _d), float(b[0]), np.float32)}

    def build_ds():
        return rd.from_items(
            list(range(N_BLOCKS)), parallelism=N_BLOCKS
        ).map_batches(make_block)

    def _pin(rank):
        # pin this rank's process to its own quarter of the machine's
        # LOWER half (both legs, fair A/B — this script pinned the infra
        # plane to the upper half before the cluster spawned), and cap
        # its torch threads at 2: on the CPU the step's threads would
        # otherwise timeshare the exact cores the producer tasks need,
        # and the measurement would conflate the two planes.
        import os as _os
        import torch
        torch.set_num_threads(2)
        try:
            ncpu = _os.cpu_count() or 0
            if ncpu >= 16:
                per = (ncpu // 2) // 2
                _os.sched_setaffinity(
                    0, set(range(rank * per, (rank + 1) * per))
                )
        except Exception:
            pass

    def _make_step():
        # FLOP-dense, cache-resident step body (one pass over the
        # batch, then square matmuls on a 512x512 working set) at
        # ~100 ms on two CPU threads — the training-step shape, NOT a
        # bandwidth sweep re-reading the batch every iteration: a
        # bandwidth-bound "step" measures the box's memory bus against
        # ingest's copies, not ingest overlap
        def step(acc, x):
            y = x.reshape(-1, 512)
            w = y.T @ y * 1e-3
            for _ in range(96):
                w = w @ w * 1e-6 + w
            return acc + w.sum()

        return step

    def _sync(device):
        import torch
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def _card(ctx):
        # the uuid of the rank's card (None on the CPU): ranks that each
        # see their card as cuda:0 still name distinct cards
        import torch
        device = torch.device(ctx.device)
        if device.type != "cuda":
            return None
        return str(torch.cuda.get_device_properties(device).uuid)

    def epoch_streaming(ctx, its, bsz):
        import time
        from itertools import chain
        import torch
        _pin(ctx.rank)
        it = its[ctx.rank]
        step = _make_step()
        acc = step(torch.zeros((), device=ctx.device),
                   torch.zeros((bsz, {DIM}), device=ctx.device))
        _sync(ctx.device)  # first launches off the clock
        gen = it.iter_device_batches(batch_size=bsz,
                                     prefetch_batches=2,
                                     prefetch_blocks=4,
                                     device=ctx.device)
        first = next(gen)  # pipeline priming off the clock (fill
        # latency is a constant, sustained ingest is the contract; the
        # primed batch's STEP still runs on the clock below)
        rows = 0
        nbytes = 0
        t0 = time.perf_counter()
        for batch in chain([first], gen):
            x = batch["x"]
            rows += int(x.shape[0])
            nbytes += int(x.numel()) * 4
            acc = step(acc, x)
            _sync(ctx.device)  # sync step: stall lands HERE, between
            # steps, never hidden inside the device's launch queue
        wall = time.perf_counter() - t0
        return {"rows": rows, "bytes": nbytes, "wall": wall,
                "ingest": it.stats()["prefetch"]}

    def epoch_prestaged(ctx, steps, bsz):
        import time
        import torch
        _pin(ctx.rank)
        step = _make_step()
        batches = [torch.full((bsz, {DIM}), float(i), device=ctx.device)
                   for i in range(steps)]
        acc = step(torch.zeros((), device=ctx.device),
                   torch.zeros((bsz, {DIM}), device=ctx.device))
        _sync(ctx.device)
        t0 = time.perf_counter()
        for x in batches:
            acc = step(acc, x)
            _sync(ctx.device)
        return {"wall": time.perf_counter() - t0}

    # one untimed streaming epoch first: worker-process spawn, the
    # coordinator actor, and the step's first launches all warm OFF the
    # clock — the gate measures steady-state ingest (a real training
    # job's epoch 2+), not process cold-start
    its = mg.split_dataset(build_ds())
    mg.run(epoch_streaming, its, ROWS_PER)
    for it in its:
        it.stop()
        break
    pre_wall = None
    for _ in range(3):  # best-of-3 BOTH legs: a noisy single-sample
        # baseline would skew the gated ratio in either direction
        pre = mg.run(epoch_prestaged, N_BLOCKS // 2, ROWS_PER)
        w = max(r["wall"] for r in pre)
        pre_wall = w if pre_wall is None else min(pre_wall, w)
    best = None
    for _ in range(3):  # best-of-3: shared-box noise vs a 5% gate
        its = mg.split_dataset(build_ds())
        res = mg.run(epoch_streaming, its, ROWS_PER)
        for it in its:
            it.stop()
            break  # one stop kills the shared coordinator
        wall = max(r["wall"] for r in res)
        if best is None or wall < best[0]:
            best = (wall, res)
    stream_wall, res = best
    rows = sum(r["rows"] for r in res)
    nbytes = sum(r["bytes"] for r in res)
    assert rows == N_BLOCKS * ROWS_PER, (rows, res)
    out["rows"] = rows
    out["rows_per_s"] = round(rows / stream_wall, 1)
    out["bytes_per_s"] = round(nbytes / stream_wall, 1)
    out["epoch_wall_s"] = round(stream_wall, 3)
    out["prestaged_wall_s"] = round(pre_wall, 3)
    out["step_delta"] = round(stream_wall / pre_wall - 1.0, 4)
    out["ingest_stall_s"] = round(
        max(r["ingest"]["ingest_stall_s"] for r in res), 4
    )
    out["device"] = device
    out["cards"] = mg.run(_card)
    mg.shutdown()
finally:
    c.shutdown()
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass

# ---- leg 2: hot-partition shuffle over the broadcast machinery ----
# One 24 MiB source block shuffles into 4 partitions: the packed
# partition output is pulled by all 4 merges (routed one per node), so
# the holder's egress must stay O(tree fanout), not O(consumers).
SIZE_MB, K = 24, 4


def shuffle_leg(fanout):
    c = Cluster(
        initialize_head=True,
        head_node_args={"resources": {"CPU": 2, "head": 1}},
        system_config={
            "prestart_workers": False,
            "log_to_driver": False,
            "object_transfer_same_host_shm": False,  # measure the NIC plane
            "object_broadcast_min_bytes": 4 * 1024 * 1024,
            "object_broadcast_fanout": fanout,
        },
    )
    try:
        nodes = [c.add_node(num_cpus=1, resources={f"p{i}": 1})
                 for i in range(K)]
        c.connect()
        from ray_tpu_torch.data.shuffle import shuffle_stage
        from ray_tpu_torch.data.streaming import StreamingExecutor

        arr = np.arange(SIZE_MB * 1024 * 1024 // 4, dtype=np.float32)
        ds = rd.from_numpy(arr, parallelism=1)
        info = {n["node_id"].hex(): n for n in ray_tpu_torch.nodes()}
        clis = {nid: rpc.Client.connect(ni["raylet_addr"], name="dp-" + nid[:6])
                for nid, ni in info.items()}
        base = {nid: cl.call("node_stats", None, timeout=30)["transfer"]
                for nid, cl in clis.items()}
        ex = StreamingExecutor(
            [shuffle_stage(K, seed=7)], ds._source_refs,
            locality_hints=[n.node_id.hex() for n in nodes],
        )
        t0 = time.perf_counter()
        got = sum(1 for _ in ex.iter_output_refs())
        wall = time.perf_counter() - t0
        assert got == K, got
        after = {nid: cl.call("node_stats", None, timeout=30)["transfer"]
                 for nid, cl in clis.items()}
        egress = {nid: after[nid]["bytes_out"] - base[nid]["bytes_out"]
                  for nid in after}
        tree_pulls = sum(after[nid]["tree_pulls"] - base[nid]["tree_pulls"]
                        for nid in after)
        for cl in clis.values():
            cl.close()
        return max(egress.values()) / arr.nbytes, tree_pulls, wall
    finally:
        c.shutdown()
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass


ratio_tree, tree_pulls, wall_tree = shuffle_leg(2)
ratio_naive, _, wall_naive = shuffle_leg(0)
out["shuffle_egress_ratio"] = round(ratio_tree, 2)
out["shuffle_egress_ratio_naive"] = round(ratio_naive, 2)
out["shuffle_consumers"] = K
out["shuffle_tree_pulls"] = tree_pulls
out["shuffle_wall_s"] = round(wall_tree, 3)
print(json.dumps(out))
"""


def _gang_device(device, cards: int) -> str:
    """The device a gang leg's ranks run on: ``"cpu"`` (gloo ranks) only
    when the caller asks for it; otherwise CUDA, with at least ``cards``
    cards visible (one per rank, and per replacement host), else raise."""
    if device is not None and str(device) == "cpu":
        return "cpu"
    if device is not None and str(device) != "cuda":
        raise ValueError(f"a gang leg runs on 'cuda' or 'cpu', not {device!r}")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the gang legs run their ranks on CUDA by default and no CUDA "
            "device is available; pass device='cpu' for gloo ranks")
    if torch.cuda.device_count() < cards:
        raise RuntimeError(
            f"the gang leg puts one rank per CUDA card and needs {cards} "
            f"cards; {torch.cuda.device_count()} visible")
    return "cuda"


def run_data_plane_bench(device=None) -> Dict[str, float]:
    """Streaming data plane (r12): sustained rows/s + bytes/s of
    placement-routed, prefetched ingest into a RUNNING 2-host gang with
    the step-time delta vs pre-staged batches (the "ingest never blocks
    the step" contract), plus the hot-partition shuffle leg — the packed
    partition block's holder egress with K merge consumers, tree on vs
    off (sub-linear-in-consumers proof). The gang's two ranks run on two
    CUDA cards by default, or as gloo ranks with ``device="cpu"``.
    Subprocess-isolated like the transfer bench."""
    return _run_isolated(
        "data plane",
        _DATA_PLANE_CODE.replace("{DIM}", "256"),
        [_gang_device(device, 2)],
        timeout=600,
    )


def run_gcs_plane_bench() -> Dict[str, float]:
    """Control-plane micro (r11): mutations/s through the RPC plane
    against the file-backed GCS (group-commit journal), the group-commit
    A/B at the fsync durability tier (batch_max=1 = the legacy
    per-record flush), pubsub fan-out latency at N subscribers, and
    journal replay entries/s (restore-time bound). Subprocess-isolated
    like the transfer bench."""
    return _run_isolated("gcs plane", _GCS_PLANE_CODE, timeout=600)


def run_gcs_failover_bench() -> Dict[str, float]:
    """Warm-standby failover micro (r16): SIGKILL the primary GCS under
    sustained concurrent mutations and measure MTTR to the first RPC
    served by the promoted standby, acked-mutations lost (hard-gated to
    zero: ship acks make "durable" mean standby-applied), and the
    split-brain leg (a resurrected old primary must epoch-fence itself
    out, exit 3). Subprocess-isolated."""
    return _run_isolated("gcs failover", _GCS_FAILOVER_CODE, timeout=600)


def run_mesh_group_bench(device=None) -> Dict[str, float]:
    """MeshGroup micro: gang spin-up seconds (STRICT_SPREAD placement +
    worker boot + TCP rendezvous to READY) and gang-coherent compiled
    steps/s on a 2-host dp 2 x tp 2 mesh — the lockstep dispatch
    envelope. Four CUDA cards by default, or gloo ranks with
    ``device="cpu"``. Subprocess-isolated like the transfer bench."""
    return _run_isolated("mesh group", _MESH_GROUP_BENCH_CODE,
                         [_gang_device(device, 4)], timeout=600)


def run_mesh_heal_bench(device=None) -> Dict[str, float]:
    """Self-healing gang micro: SIGKILL one raylet under a 2-host gang,
    then time each leg of the heal loop — detect (kill to
    RankFailedError), provision (queued-resource grant + replacement
    raylet registration with topology labels), recover (full-shape gang
    rebuild + reshard-restore) — plus the summed MTTR the static
    ceiling gates on. On CUDA (the default) each host holds two cards
    and the replacement host two more; ``device="cpu"`` runs gloo ranks.
    Subprocess-isolated."""
    return _run_isolated("mesh heal", _MESH_HEAL_BENCH_CODE,
                         [_gang_device(device, 6)], timeout=600)


def run_serving_scale_bench() -> Dict[str, float]:
    """Serving-plane scale bench: sustained open-loop streamed traffic
    against an SLO-autoscaled deployment behind the shared Router actor.
    The deployment starts at 1 replica; the arrival rate is ~2x one
    replica's capacity, so the run only meets its TTFT floor if the
    TTFT-SLO burn actually scales it out — and bounded backpressure
    rejections are part of the recorded contract. Subprocess-isolated
    (own cluster, no torch) like the transfer bench."""
    return _run_isolated("serving_scale", _SERVING_SCALE_CODE)


def run_microbenchmarks(
    *,
    tasks_n: int = 200,
    actor_calls_n: int = 500,
    put_mb: int = 16,
    put_n: int = 8,
    batch: int = 10,
    pipelined_n: int = 0,  # 0: actor_calls_n batched bursts
    transfer_mb: int = 0,  # 0 = skip the two-raylet transfer bench
) -> Dict[str, float]:
    """Returns {metric: value}. Requires a connected ray_tpu_torch."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def nop():
        return b""

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.x = 0

        def inc(self):
            self.x += 1
            return self.x

    out: Dict[str, float] = {}

    # inline-counter baseline: the counters are process-cumulative, and
    # the bench may run in an already-busy driver — report the DELTA
    # over this measured section so it corresponds to the rates beside it
    from ray_tpu_torch._private.worker import require_connected

    cw = require_connected()
    _inline_base = (cw.task_inline_hits, cw.task_inline_bytes)

    # single-client task throughput, batched submission (ray_perf
    # "tasks per second" timers)
    def burst_tasks():
        ray_tpu_torch.get([nop.remote() for _ in range(batch)], timeout=60)

    out["tasks_per_s"] = round(_timeit(burst_tasks, tasks_n // batch) * batch, 1)

    # actor method throughput (sync round-trips + pipelined burst)
    a = Counter.remote()
    ray_tpu_torch.get(a.inc.remote(), timeout=60)

    def actor_call():
        ray_tpu_torch.get(a.inc.remote(), timeout=60)

    out["actor_calls_per_s"] = round(_timeit(actor_call, actor_calls_n), 1)
    # the same measurement, latency-shaped: the r11 sync-RTT fixes
    # (reaper-thread completion + caller-thread direct submit) are
    # gated on this number, not anecdote
    out["actor_call_sync_rtt_us"] = round(1e6 / out["actor_calls_per_s"], 1)

    # one DEEP burst shows the streaming submitter's real rate (small
    # bursts amortize nothing); warm the window first. Best-of-3: a
    # single 8k-call sample on the shared 1-core box has ~15% noise
    # (same best-of-N principle as the MFU headline). GC pauses during
    # the timed region, restoring the caller's prior state.
    deep = max(pipelined_n, batch)
    ray_tpu_torch.get([a.inc.remote() for _ in range(batch)], timeout=60)
    import gc

    best = 0.0
    gc_was_enabled = gc.isenabled()
    for _ in range(3):
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            ray_tpu_torch.get([a.inc.remote() for _ in range(deep)], timeout=300)
            best = max(best, deep / (time.perf_counter() - t0))
        finally:
            if gc_was_enabled:
                gc.enable()
    out["actor_calls_pipelined_per_s"] = round(best, 1)

    # put / get bandwidth on large arrays (zero-copy reads)
    arr = np.random.randint(0, 255, put_mb * 1024 * 1024, dtype=np.uint8)

    refs = []

    def put_one():
        refs.append(ray_tpu_torch.put(arr))

    puts_per_s = _timeit(put_one, put_n)
    out["put_gbps"] = round(puts_per_s * put_mb / 1024, 3)

    ref = ray_tpu_torch.put(arr)

    def get_one():
        ray_tpu_torch.get(ref, timeout=60)

    gets_per_s = _timeit(get_one, put_n)
    out["get_gbps"] = round(gets_per_s * put_mb / 1024, 3)
    del refs

    # task-return inlining counters (owner side: every "v" completion
    # materialized from a task_done frame above counts) — the bench
    # gate records these next to the rates they explain
    out["task_inline_hits"] = cw.task_inline_hits - _inline_base[0]
    out["task_inline_bytes"] = cw.task_inline_bytes - _inline_base[1]

    # inter-node object plane: two-raylet loopback pull — same-host shm
    # fast path (default) and the socket plane (windowed + striped +
    # zero-copy chunk frames) — isolated in a subprocess
    if transfer_mb > 0:
        try:
            tr = run_transfer_bench(transfer_mb)
            out["transfer_gbps"] = tr["transfer_gbps"]
            out["transfer_socket_gbps"] = tr["transfer_socket_gbps"]
        except Exception as e:  # keep the other measured numbers
            out["transfer_error"] = str(e)[:160]
    return out


def main():
    import json
    import os

    import ray_tpu_torch

    os.environ.setdefault("RAYTPU_LEASE_PUSH_PIPELINE_DEPTH", "16")
    os.environ.setdefault("RAYTPU_LEASE_KEEPALIVE_MS", "100")
    started = not ray_tpu_torch.is_initialized()
    if started:
        ray_tpu_torch.init(num_cpus=4, object_store_memory=512 * 1024 * 1024)
    try:
        results = run_microbenchmarks(
            tasks_n=1000, actor_calls_n=2000, put_mb=64, put_n=10,
            transfer_mb=256,
        )
        print(json.dumps(results, indent=2))
    finally:
        if started:
            ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
