"""How a body becomes a replayable program on CUDA, for every module that
captures one: ``models/generation.py`` (``prefill`` and ``decode_loop``),
``serve/llm.py`` (the engine's prefill and decode-block programs) and
``parallel/train_step.py`` (the train step).

A body first runs once eagerly on a side stream (``warm_up``: kernels built
and their attributes set, cuBLAS's workspace made, the caching allocator's
blocks found), then is captured into a CUDA graph in a given memory pool
(``capture``), in thread-local capture mode, so that another thread (a batch
pump, a client) may allocate and copy meanwhile. The launches that each
hand-written kernel's wrapper counted during the capture are the launches
the graph makes at every replay (``Captured.launches``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch


def kernel_launches() -> Dict[str, int]:
    """Every hand-written kernel wrapper's launch counter, by kernel."""
    from ray_tpu_torch.ops import decode_attention, flash_attention, int8_matmul

    return {"flash_fwd": flash_attention.launches,
            "flash_bwd_dq": flash_attention.launches_bwd_dq,
            "flash_bwd_dkv": flash_attention.launches_bwd_dkv,
            "int8_matmul": int8_matmul.launches,
            "decode_attention": decode_attention.launches}


def warm_up(body: Callable, device: torch.device, stream=None):
    """``body()`` on a side stream (``stream``, or a new one) that first
    waits for the device's current stream, which then waits for it. Returns
    what ``body`` returns."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device) if stream is None else stream
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = body()
    cur.wait_stream(side)
    return out


@dataclasses.dataclass
class Captured:
    """A captured body: its graph, what the body returned (tensors in the
    graph's memory, rewritten by each replay), the kernel launches the graph
    holds by kernel, and its replays."""

    graph: "torch.cuda.CUDAGraph"
    result: object
    launches: Dict[str, int]
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def capture(body: Callable, pool=None) -> Captured:
    """Captures ``body()`` on the current device into a new CUDA graph that
    allocates from ``pool`` (a ``torch.cuda.graph_pool_handle()``; graphs
    that share one must never run at once). Capture runs nothing; a failed
    capture raises."""
    before = kernel_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        result = body()
    after = kernel_launches()
    return Captured(graph, result,
                    {k: after[k] - before[k] for k in after})
