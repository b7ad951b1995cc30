"""The port's one capture helper (ray_tpu_torch/graphs.py), on the CPU with
the CUDA stream and graph calls faked: the warm-up runs the body on a side
stream that waits for the current one (and is waited for), and a capture
records each hand-written kernel's launches and replays count."""

from contextlib import contextmanager

import pytest
import torch

from ray_tpu_torch import graphs
from ray_tpu_torch.ops import decode_attention, flash_attention, int8_matmul


class _Stream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append(f"{self.name} waits {other.name}")


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    log = []
    current = _Stream("current", log)

    @contextmanager
    def on(stream):
        log.append(f"on {stream.name}")
        yield
        log.append(f"off {stream.name}")

    @contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        log.append(f"capture {capture_error_mode}")
        yield
        log.append("captured")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: current)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda d=None: _Stream("side", log))
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return log


def test_warm_up_runs_the_body_on_a_side_stream(fake_cuda):
    out = graphs.warm_up(lambda: fake_cuda.append("body") or 7,
                         torch.device("cuda", 0))
    assert out == 7
    assert fake_cuda == ["side waits current", "on side", "body",
                         "off side", "current waits side"]


def test_warm_up_takes_a_given_stream(fake_cuda):
    graphs.warm_up(lambda: None, torch.device("cuda", 0),
                   _Stream("mine", fake_cuda))
    assert fake_cuda[0] == "mine waits current"


def test_capture_counts_launches_by_kernel(fake_cuda, monkeypatch):
    for mod, name in ((decode_attention, "launches"),
                      (int8_matmul, "launches"),
                      (flash_attention, "launches"),
                      (flash_attention, "launches_bwd_dq"),
                      (flash_attention, "launches_bwd_dkv")):
        monkeypatch.setattr(mod, name, 10)

    def body():
        decode_attention.launches += 3
        int8_matmul.launches += 12
        return "result"

    cap = graphs.capture(body)
    assert fake_cuda == ["capture thread_local", "captured"]
    assert cap.result == "result"
    assert cap.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "int8_matmul": 12,
                            "decode_attention": 3}
    for _ in range(3):
        cap.replay()
    assert cap.replays == 3 and cap.graph.replays == 3
    assert graphs.kernel_launches()["decode_attention"] == 13
