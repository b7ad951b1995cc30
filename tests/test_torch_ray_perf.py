"""The port's runtime microbenchmarks (``ray_tpu_torch/_private/ray_perf.py``)
and ``ping`` on its three planes, held against the reference's
(``ray_tpu/_private/ray_perf.py``; ``rpc_ping`` of its GCS, raylet and core
worker): each flow runs in one session of each package and the results
compare equal. ``run_microbenchmarks`` runs at the sizes of the reference's
own test (tests/test_observability.py:118-124). Also here, on the port
only: ``_run_isolated``'s result protocol and scrubbed environment.
"""

import importlib
import os

import pytest
from torch_parity import norm, run_flows

from ray_tpu_torch._private import ray_perf

# the reference test's sizes (tests/test_observability.py:120)
SIZES = {"tasks_n": 40, "actor_calls_n": 60, "put_mb": 4, "put_n": 3}
RATES = ("tasks_per_s", "actor_calls_per_s", "actor_calls_pipelined_per_s",
         "put_gbps", "get_gbps")


def ping_the_three_planes(rt):
    """What ``ping`` answers on the GCS, the node's raylet and an actor's
    core worker."""
    pkg = rt.__name__
    rpc = importlib.import_module(pkg + "._private.rpc")
    worker = importlib.import_module(pkg + "._private.worker")

    @rt.remote(num_cpus=1)
    class Addr:
        def addr(self):
            import importlib as il

            return il.import_module(
                pkg + "._private.worker").global_worker.core_worker.my_addr

    actor = Addr.remote()
    got = [worker.global_worker.core_worker.gcs.call("ping", None,
                                                     timeout=30)]
    for addr in (rt.nodes()[0]["raylet_addr"],
                 rt.get(actor.addr.remote(), timeout=60)):
        cli = rpc.Client.connect(addr, name="ping-test")
        try:
            got.append(cli.call("ping", None, timeout=30))
        finally:
            cli.close()
    rt.kill(actor)
    return got


def microbenchmarks_at_the_reference_test_sizes(rt):
    """``run_microbenchmarks`` at the reference test's sizes: its keys, each
    rate positive and the inline deltas non-negative."""
    perf = importlib.import_module(rt.__name__ + "._private.ray_perf")
    r = perf.run_microbenchmarks(**SIZES)
    return [sorted(r), [r[k] > 0 for k in RATES],
            r["task_inline_hits"] >= 0 and r["task_inline_bytes"] >= 0,
            r["actor_call_sync_rtt_us"] > 0]


FLOWS = [ping_the_three_planes, microbenchmarks_at_the_reference_test_sizes]


@pytest.fixture(scope="module")
def runs():
    kwargs = {"num_cpus": 4, "object_store_memory": 128 * 1024 * 1024}
    return {name: run_flows(name, FLOWS, kwargs)
            for name in ("ray_tpu", "ray_tpu_torch")}


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_ping_answers_pong_on_the_three_planes(runs):
    assert runs["ray_tpu_torch"]["ping_the_three_planes"] == (
        "value", ["pong", "pong", "pong"])


def test_microbenchmarks_rates_and_inline_deltas(runs):
    got = runs["ray_tpu_torch"]["microbenchmarks_at_the_reference_test_sizes"]
    assert got[0] == "value", got
    keys, positive, inline_ok, rtt_ok = got[1]
    assert set(RATES) | {"task_inline_hits", "task_inline_bytes"} <= set(keys)
    assert all(positive) and inline_ok and rtt_ok, got


def test_run_isolated_reads_the_last_json_line_in_a_scrubbed_env(
        monkeypatch):
    """The result is the last line that starts with ``{``; the leg's
    environment has no ``RAYTPU_ADDRESS`` nor ``RAYTPU_CHAOS_SPEC`` (its own
    cluster, no inherited chaos), keeps the devices visible, and imports
    this checkout's package; argv reaches the code as strings."""
    monkeypatch.setenv("RAYTPU_ADDRESS", "unix:/nowhere.sock")
    monkeypatch.setenv("RAYTPU_CHAOS_SPEC", "{}")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    code = ("import json, os, sys, ray_tpu_torch\n"
            "print(json.dumps({'first': 1}))\n"
            "print(json.dumps({k: os.environ.get(k) for k in ("
            "'RAYTPU_ADDRESS', 'RAYTPU_CHAOS_SPEC', 'CUDA_VISIBLE_DEVICES')}"
            " | {'argv': sys.argv[1:], 'pkg': ray_tpu_torch.__file__}))\n")
    got = ray_perf._run_isolated("probe", code, [7, "cpu"], timeout=60)
    pkg = os.path.join(ray_perf._PACKAGE_ROOT, "ray_tpu_torch",
                       "__init__.py")
    assert got == {"RAYTPU_ADDRESS": None, "RAYTPU_CHAOS_SPEC": None,
                   "CUDA_VISIBLE_DEVICES": "3", "argv": ["7", "cpu"],
                   "pkg": pkg}
    assert os.environ["RAYTPU_ADDRESS"] == "unix:/nowhere.sock"


def test_run_isolated_raises_with_the_stderr_tail_when_no_result():
    code = "import sys\nprint('no result line'); sys.exit('leg failed: boom')\n"
    with pytest.raises(RuntimeError, match=r"probe bench produced no result "
                                           r"\(rc=1\): leg failed: boom"):
        ray_perf._run_isolated("probe", code, timeout=60)


def test_gang_legs_take_the_cpu_only_when_asked(monkeypatch):
    assert ray_perf._gang_device("cpu", 4) == "cpu"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ray_perf._gang_device("meta", 4)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ray_perf._gang_device(None, 2) == "cuda"
    with pytest.raises(RuntimeError, match="needs 4 cards; 2 visible"):
        ray_perf._gang_device("cuda", 4)
    assert ray_perf._gang_device("cuda", 1) == "cuda"
