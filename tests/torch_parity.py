"""Helpers of the runtime parity tests: a flow's outcome as plain data, and
the normalization that reads the two packages' results as one."""

import re

_ID = re.compile(r"\b[0-9a-f]{16,}\b")
_FRAME_LINE = re.compile(r'(File "[^"]*ray_tpu(?:_torch)?/[^"]*", line )\d+')


def norm(x):
    """A result with the package's name, ids and the package's frame line
    numbers made the same across the two packages."""
    if isinstance(x, str):
        x = x.replace("ray_tpu_torch", "ray_tpu")
        x = _FRAME_LINE.sub(r"\1N", x)
        return _ID.sub("<id>", x)
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    return x


def outcome(fn, *args, **kwargs):
    """("value", v) or ("raised", class name, message)."""
    try:
        return ("value", fn(*args, **kwargs))
    except Exception as e:  # the class and message are the result
        return ("raised", type(e).__name__, str(e))


def assert_no_leaks(timeout_s: float = 10.0):
    """The port's leak ledger at teardown: its copy of the reference's
    ``test_utils.assert_no_leaks`` over the connected cluster (every alive
    raylet's ``node_stats["leaks"]``, the driver's ``leak_stats()`` and the
    GCS's autoscaler-intent table), polled while background releases
    drain."""
    from ray_tpu_torch._private.test_utils import assert_no_leaks as audit

    audit(timeout_s=timeout_s)


def plain(x):
    """A flow's result as plain Python data: numpy arrays and scalars, and
    CPU torch tensors, become ``("nd", dtype name, nested list)`` or the
    scalar's value, so the two packages' results compare with ``==``."""
    import numpy as np

    if type(x).__module__.startswith("torch"):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def run_flows(name, flows, init_kwargs, make_args=lambda name: ()):
    """Runs each flow ``flow(rt, *make_args(name))`` in ONE runtime session
    of package ``name``, returning ``{flow name: outcome}`` with values made
    ``plain``. The reference's session runs with the automatic GC off and a
    collection between flows: the cyclic GC can finalize an ObjectRef
    inside the reference's ``CoreWorker._on_ref_created`` lock and hang it
    (ROADMAP Queue 3). The port runs with the GC on."""
    import gc
    import importlib

    rt = importlib.import_module(name)
    gc.collect()
    if name == "ray_tpu":
        gc.disable()
    rt.init(**init_kwargs)
    out = {}
    try:
        for flow in flows:
            res = outcome(flow, rt, *make_args(name))
            out[flow.__name__] = plain(res)
            gc.collect()
    finally:
        rt.shutdown()
        gc.enable()
    return out
