"""The port's state API and metrics held against the reference's: the flows
of the reference's tests/test_observability.py (task events and states,
actors and nodes, the timeline, Counter / Gauge / Histogram), run in one
session of each package, their results compared.

Also here, on the port only: an actor's GPU share and the card ids of its
lease in ``list_actors``, and the metrics registry's flush after
``shutdown()``.
"""

import importlib
import json
import threading
import time

import pytest
from torch_parity import norm, run_flows


def _state(rt):
    return importlib.import_module(rt.__name__ + ".util.state")


def list_tasks_and_states(rt, tmp):
    state = _state(rt)

    @rt.remote
    def fine():
        return 1

    @rt.remote(max_retries=0)
    def broken():
        raise ValueError("boom")

    rt.get([fine.remote() for _ in range(3)], timeout=60)
    with pytest.raises(Exception):
        rt.get(broken.remote(), timeout=60)
    deadline = time.monotonic() + 15  # events flush on a ~1 s cadence
    while time.monotonic() < deadline:
        tasks = state.list_tasks()
        fins = [t for t in tasks if t["name"] == "fine"
                and t["state"] == "FINISHED"]
        fails = [t for t in tasks if t["name"] == "broken"
                 and t["state"] == "FAILED"]
        if len(fins) >= 3 and len(fails) >= 1:
            break
        time.sleep(0.3)
    summary = state.summarize_tasks()
    by_state = state.list_tasks(name="broken", state="FAILED")
    out = [len(fins), len(fails), "boom" in fails[0]["error"],
           fins[0]["events"].get("RUNNING") is not None,
           sorted(fins[0]), summary["fine"]["FINISHED"],
           summary["broken"]["FAILED"], len(by_state),
           [t["attempts"] for t in by_state]]
    assert out[:8] == [3, 1, True, True, out[4], 3, 1, 1], out
    return out


def list_actors_and_nodes(rt, tmp):
    state = _state(rt)

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    rt.get(a.ping.remote(), timeout=60)
    actors = state.list_actors()
    nodes = state.list_nodes()
    status = state.cluster_status()
    pgs = state.list_placement_groups()
    rt.kill(a)
    # the port's session also has two GPUs (gpu_actor_resources)
    cpu = {k: v for k, v in nodes[0]["resources"].items() if k != "GPU"}
    out = [any(x["state"] == "ALIVE" for x in actors), len(nodes),
           nodes[0]["alive"], cpu, status["nodes_alive"],
           status["nodes_dead"], status["cluster_resources"]["CPU"],
           status["placement_groups"], pgs]
    assert out[:3] == [True, 1, True] and out[4] == 1 and out[6] == 4
    return out


def timeline_chrome_trace(rt, tmp):
    state = _state(rt)

    @rt.remote
    def work():
        time.sleep(0.05)
        return 1

    rt.get([work.remote() for _ in range(4)], timeout=60)
    deadline = time.monotonic() + 15
    path = str(tmp / f"{rt.__name__}_trace.json")
    while time.monotonic() < deadline:
        events = state.timeline(path)
        spans = [e for e in events if e["name"] == "work"]
        # task events reach the GCS in batches: a span whose FINISHED event
        # has not arrived yet has no duration
        if len(spans) >= 4 and all(e["args"]["state"] == "FINISHED"
                                   for e in spans):
            break
        time.sleep(0.3)
    with open(path) as f:
        on_disk = json.load(f)
    out = [len(spans), all(e["ph"] == "X" and e["dur"] >= 0.05 * 1e6 * 0.5
                           for e in spans),
           sorted(spans[0]), bool(on_disk)]
    assert out[0] == 4 and out[1] and out[3], out
    return out


def metrics_counter_gauge_histogram(rt, tmp):
    metrics = importlib.import_module(rt.__name__ + ".util.metrics")
    c = metrics.Counter("test_requests", tag_keys=("route",))
    c.inc(2.0, {"route": "/a"})
    c.inc(3.0, {"route": "/a"})
    g = metrics.Gauge("test_depth")
    g.set(7.0)
    h = metrics.Histogram("test_lat", boundaries=[1, 10])
    h.observe(0.5)
    h.observe(5.0)
    h.observe(50.0)
    metrics.flush_to_gcs()
    agg = metrics.collect_cluster_metrics()
    hist = agg["test_lat"]["values"][()]
    out = [agg["test_requests"]["values"][(("route", "/a"),)],
           agg["test_depth"]["values"][()], hist["counts"], hist["sum"],
           agg["test_lat"]["boundaries"],
           [m["type"] for _, m in sorted(agg.items())],
           [type(e).__name__ for e in _bad_metrics(metrics)]]
    assert out[:4] == [5.0, 7.0, [1, 1, 1], 55.5], out
    return out


def _bad_metrics(metrics):
    errs = []
    for make in (lambda: metrics.Counter("has space"),
                 lambda: metrics.Counter("neg").inc(-1)):
        try:
            make()
        except ValueError as e:
            errs.append(e)
    return errs


def metrics_from_actors(rt, tmp):
    """Two actors' counters and histograms flushed from their own processes
    and summed by the reader (the aggregation a dashboard scrapes)."""

    @rt.remote
    class Served:
        def __init__(self):
            from importlib import import_module

            m = import_module(rt.__name__ + ".util.metrics")
            self.m = m
            self.tokens = m.Counter("served_tokens", tag_keys=("model",))
            self.ttft = m.Histogram("served_ttft_s", boundaries=[0.1, 1.0])

        def serve(self, n, ttft):
            self.tokens.inc(n, {"model": "m"})
            self.ttft.observe(ttft)
            self.m.flush_to_gcs()
            return n

    metrics = importlib.import_module(rt.__name__ + ".util.metrics")
    actors = [Served.remote(), Served.remote()]
    rt.get([a.serve.remote(n, t) for a, n, t in
            zip(actors, (7, 5), (0.05, 2.0))], timeout=60)
    agg = metrics.collect_cluster_metrics()
    for a in actors:
        rt.kill(a)
    out = [agg["served_tokens"]["values"][(("model", "m"),)],
           agg["served_ttft_s"]["values"][()]]
    assert out == [12.0, {"counts": [1, 0, 1], "sum": 2.05}], out
    return out


FLOWS = [list_tasks_and_states, list_actors_and_nodes,
         timeline_chrome_trace, metrics_counter_gauge_histogram,
         metrics_from_actors]


def gpu_actor_resources(rt, tmp):
    """Port only, on a node given two fake GPUs: two actors at 0.5 GPU each
    share one card; list_actors shows the share and the card's id."""
    state = _state(rt)

    @rt.remote(num_gpus=0.5)
    class Half:
        def ids(self):
            return rt.get_runtime_context().get_accelerator_ids()

    a, b = Half.remote(), Half.remote()
    seen = rt.get([a.ids.remote(), b.ids.remote()], timeout=60)
    rows = sorted((x["resources"], x["accelerator_ids"])
                  for x in state.list_actors() if x["state"] == "ALIVE")
    avail = rt.available_resources().get("GPU")
    rt.kill(a)
    rt.kill(b)
    return [seen, rows, avail]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in ("ray_tpu", "ray_tpu_torch"):
        tmp = tmp_path_factory.mktemp(name)
        kwargs = {"num_cpus": 4, "object_store_memory": 128 * 1024 * 1024}
        flows = FLOWS
        if name == "ray_tpu_torch":
            kwargs["num_gpus"] = 2
            flows = FLOWS + [gpu_actor_resources]
        out[name] = run_flows(name, flows, kwargs, lambda _n, t=tmp: (t,))
    return out


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_gpu_actors_show_their_share_and_card(runs):
    got = runs["ray_tpu_torch"]["gpu_actor_resources"]
    assert got[0] == "value", got
    seen, rows, avail = got[1]
    assert seen[0] == seen[1] and len(seen[0]["GPU"]) == 1, seen
    card = seen[0]["GPU"]
    # an actor holds a CPU for its life on this runtime, and its GPU share
    assert rows == [({"CPU": 1.0, "GPU": 0.5}, {"GPU": card})] * 2, rows
    assert avail == 1.0  # one card of two held by the two halves


def test_metrics_flush_after_shutdown_is_a_noop():
    """No session: flush_to_gcs() returns without a connection, and no
    thread of the metrics module runs (it flushes inline, on an update)."""
    from ray_tpu_torch.util import metrics

    before = {t.name for t in threading.enumerate()}
    c = metrics.Counter("after_shutdown_count")
    c.inc(1.0)
    metrics.flush_to_gcs()
    assert {t.name for t in threading.enumerate()} <= before
