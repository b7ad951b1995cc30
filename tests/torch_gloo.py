"""Runs a script in n processes of one gloo process group on the CPU, for
the port's multi-rank tests (ray_tpu_torch over a DeviceMesh).

Each process runs ``PREAMBLE`` and then the script, with ``rank``,
``world`` and ``work`` (a directory for results) defined and the process
group initialized at ``tcp://localhost:<free port>``. The caller waits at
most ``timeout`` seconds in all: when a rank exits with an error the others
are killed at once (they would wait in a collective for it), and on expiry
every rank is killed; either way the test fails with every rank's output.
Each rank dumps its Python stacks shortly before the deadline, so a hang
shows where it waits. ``start_ranks`` returns as soon as the ranks are
started, so that the caller can work meanwhile; its ``wait`` collects them.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PREAMBLE = textwrap.dedent("""
    import faulthandler, sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    faulthandler.dump_traceback_later(float(sys.argv[5]), exit=True)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` gloo ranks running a script (``start_ranks``); ``wait``
    collects them."""

    def __init__(self, script: str, world: int, work, timeout: float):
        self.world, self.timeout = world, timeout
        work = Path(work)
        work.mkdir(parents=True, exist_ok=True)
        code = PREAMBLE + textwrap.dedent(script) + (
            "\ndist.barrier()\ndist.destroy_process_group()\n")
        env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
        port = str(free_port())
        self.logs = [open(work / f"rank{r}.log", "w+") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), port, str(work),
             str(max(timeout - 15.0, 5.0))],
            cwd=REPO, env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        """The ranks' outputs (rank order). Raises AssertionError, with
        every rank's output, unless all exit 0 before the deadline."""
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs
                       if p.returncode is not None):
                    break  # a rank failed: its peers would wait for it
                if time.monotonic() > self.deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in self.logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        codes = [p.returncode for p in procs]
        if codes != [0] * self.world:
            report = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-6000:]}"
                               for r, (c, o) in enumerate(zip(codes, outs)))
            raise AssertionError(f"gloo ranks exited {codes} (timeout "
                                 f"{self.timeout} s):\n{report}")
        return outs


def start_ranks(script: str, world: int, work,
                timeout: float = 240.0) -> Ranks:
    """Starts ``script`` on ``world`` gloo ranks and returns at once, so
    that the caller can work meanwhile; ``.wait()`` collects them."""
    return Ranks(script, world, work, timeout)


def run_ranks(script: str, world: int, work, timeout: float = 240.0) -> list:
    """Runs ``script`` on ``world`` gloo ranks; returns their outputs (rank
    order). Raises AssertionError, with every rank's output, unless all
    exit 0 within ``timeout`` seconds."""
    return start_ranks(script, world, work, timeout).wait()
