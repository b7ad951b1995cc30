"""The port's sharded async checkpoints (ray_tpu_torch/train/
sharded_checkpoint.py) on the CPU: the properties of
``tests/test_sharded_checkpoint.py`` on port train states, the on-disk
format read and written across the two packages, and a save by two gloo
processes.

Tolerance of the cross-package step (a JAX TrainState restored into the
port, then one step on each side): that of ``tests/test_torch_train_step.py``
for fp32, loss and grad norm at rtol 1e-5 and params at atol 2e-5 (the same
math; XLA and PyTorch sum in other orders). Everything else is bit for bit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import sharded_checkpoint as jck
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import (
    checkpoint_step,
    is_committed,
    load_sharded,
    save_sharded,
)

from tests.torch_gloo import run_ranks

REPO = Path(__file__).resolve().parents[1]


def _configs():
    return (jtf.TransformerConfig.tiny(dtype=jnp.float32, max_seq_len=32),
            ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32))


def _batch(vocab, seed=1, b=2, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_state(seed=0, steps=1):
    """A tiny port TrainState on the CPU after ``steps`` steps."""
    _, tcfg = _configs()
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(tcfg, opt, seed=seed, device="cpu")
    step = tts.make_train_step(tcfg, opt)
    tb = _torch_batch(_batch(tcfg.vocab_size))
    for _ in range(steps):
        step(state, tb)
    return state, step, tb


def _state_arrays(state):
    """Every array the port's TrainState holds, as numpy copies: step,
    params, and per param AdamW's step count and moments."""
    out = {"step": state.step.numpy().copy()}
    for i, p in enumerate(ttf.tree_leaves(state.params)):
        out[f"p{i}"] = p.detach().numpy().copy()
        st = state.opt_state.state.get(p, {})
        for name in ("step", "exp_avg", "exp_avg_sq"):
            if name in st:
                out[f"p{i}.{name}"] = st[name].numpy().copy()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_state_round_trip_is_bitwise(tmp_path):
    state, _, _ = _port_state(steps=2)
    path = str(tmp_path / "ckpt")
    h = save_sharded(state, path, step=2)
    h.wait(timeout=60)
    assert h.done() and is_committed(path, 2) and checkpoint_step(path) == 2
    assert h.seconds is not None and h.seconds >= 0
    fresh, _, _ = _port_state(seed=5, steps=0)
    assert not fresh.opt_state.state  # no AdamW state before a step
    assert load_sharded(path, like=fresh) is fresh
    _assert_same(_state_arrays(fresh), _state_arrays(state))


def test_restore_keeps_the_live_tensors(tmp_path):
    """Restoring fills the state in place: the same tensor objects (which a
    captured step holds) take the checkpoint's values."""
    src, _, _ = _port_state(steps=1)
    path = str(tmp_path / "ckpt")
    save_sharded(src, path, step=1, wait=True)
    dst, _, _ = _port_state(seed=3, steps=1)
    leaves = ttf.tree_leaves(dst.params)
    moments = [dst.opt_state.state[p]["exp_avg"] for p in leaves]
    step_t = dst.step
    load_sharded(path, like=dst)
    assert dst.step is step_t
    assert all(a is b for a, b in zip(ttf.tree_leaves(dst.params), leaves))
    assert all(dst.opt_state.state[p]["exp_avg"] is m
               for p, m in zip(leaves, moments))
    _assert_same(_state_arrays(dst), _state_arrays(src))


def test_restore_without_template_gives_numpy(tmp_path):
    state, _, _ = _port_state(steps=1)
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=1, wait=True)
    out = load_sharded(path)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    # keys are jax key-path strings, as the reference's TrainState gives them
    np.testing.assert_array_equal(
        out["[<flat index 1>]['embed']"],
        state.params["embed"].detach().numpy())
    assert out["[<flat index 0>]"].dtype == np.int32
    assert int(out["[<flat index 2>][1][0].count"]) == 1
    np.testing.assert_array_equal(
        out["[<flat index 2>][1][0].nu['lm_head']"],
        state.opt_state.state[state.params["lm_head"]]["exp_avg_sq"].numpy())


def test_tree_state_round_trip_and_aux(tmp_path):
    state = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
             "pair": (torch.ones(3, dtype=torch.int64), np.arange(5)),
             "note": "seven", "step": 7}
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=7, wait=True)
    got = load_sharded(path, like=state)
    assert got["step"] == 7 and got["note"] == "seven"
    assert isinstance(got["w"], torch.Tensor) and got["w"] is not state["w"]
    assert torch.equal(got["w"], state["w"])
    assert torch.equal(got["pair"][0], state["pair"][0])
    assert isinstance(got["pair"][1], np.ndarray)
    np.testing.assert_array_equal(got["pair"][1], state["pair"][1])
    assert sorted(load_sharded(path)) == [
        "['note']", "['pair'][0]", "['pair'][1]", "['step']", "['w']"]


def test_torn_save_is_not_restorable(tmp_path):
    state, _, _ = _port_state(steps=1)
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=1, wait=True)
    os.remove(os.path.join(path, "COMMIT"))
    with pytest.raises(FileNotFoundError, match="committed"):
        load_sharded(path)
    with pytest.raises(FileNotFoundError, match="committed"):
        load_sharded(path, like=state)
    with open(os.path.join(path, "COMMIT"), "w") as f:
        f.write("5")  # a commit of another save
    with pytest.raises(FileNotFoundError, match="mixed saves"):
        load_sharded(path)


def test_async_save_overlaps_work_and_snapshots(tmp_path, monkeypatch):
    """save_sharded returns before the write ends; steps taken meanwhile
    (which update the state in place) do not reach the checkpoint. The
    write is held at its first file until those steps are done."""
    import threading

    state, step, tb = _port_state(steps=1)
    before = _state_arrays(state)
    path = str(tmp_path / "ckpt")
    real_save = np.save
    steps_done = threading.Event()

    def held_save(*args, **kwargs):
        assert steps_done.wait(timeout=60)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(np, "save", held_save)
    t0 = time.monotonic()
    h = save_sharded(state, path, step=1)
    returned_in = time.monotonic() - t0
    step(state, tb)  # the train loop goes on while the write waits
    step(state, tb)
    assert not h.done()
    steps_done.set()
    h.wait(timeout=60)
    assert returned_in < 5.0  # snapshot only; the write is off-thread
    restored, _, _ = _port_state(seed=4, steps=0)
    load_sharded(path, like=restored)
    _assert_same(_state_arrays(restored), before)
    assert int(state.step) == 3


def test_stale_directory_reuse_is_safe(tmp_path):
    path = str(tmp_path / "ckpt")
    s1 = {"w": torch.arange(8, dtype=torch.float32)}
    save_sharded(s1, path, step=1, wait=True)
    s2 = {"w": s1["w"] * 3}
    h = save_sharded(s2, path, step=2, wait=True)
    assert h.done() and checkpoint_step(path) == 2
    assert torch.equal(load_sharded(path, like=s2)["w"], s2["w"])
    # the first save's artifacts are still there, scoped to their step
    assert os.path.exists(os.path.join(path, "shard_0.1.ok"))
    assert os.path.isdir(os.path.join(path, "pieces_1"))


@pytest.mark.parametrize("box", [
    (slice(2, 5), slice(None)),
    (slice(0, 1), slice(3, 6)),
    [(1, 4), (0, 2)],
], ids=["rows", "corner", "pairs"])
def test_requested_sub_slice_reassembles(tmp_path, box):
    w = np.arange(6 * 6, dtype=np.float32).reshape(6, 6)
    path = str(tmp_path / "ckpt")
    save_sharded({"w": w}, path, wait=True)
    got = load_sharded(path, slices={"['w']": box})["['w']"]
    want = w[tuple(slice(a, b) for a, b in box)] if isinstance(box, list) \
        else w[box]
    np.testing.assert_array_equal(got, want)


def test_bfloat16_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_sharded({"w": torch.ones(2, dtype=torch.bfloat16)},
                     str(tmp_path / "ckpt"))


# -- across the two packages --------------------------------------------------


def _jax_sharded_state():
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = build_mesh(MeshConfig(dp=2, tp=4))
    w = jnp.arange(64 * 32, dtype=jnp.float32).reshape(64, 32)
    b = jnp.arange(32, dtype=jnp.int32)
    return {"w": jax.device_put(w, NamedSharding(mesh, P("dp", "tp"))),
            "b": jax.device_put(b, NamedSharding(mesh, P("tp"))),
            "step": 7}


def test_port_restores_a_jax_sharded_save(tmp_path):
    state = _jax_sharded_state()
    path = str(tmp_path / "ckpt")
    jck.save_sharded(state, path, step=7, wait=True)
    index = pickle.load(open(os.path.join(path, "index_0.7.pkl"), "rb"))
    assert len(index["['w']"]) == 8  # one piece per dp x tp shard
    out = load_sharded(path)
    np.testing.assert_array_equal(out["['w']"], np.asarray(state["w"]))
    np.testing.assert_array_equal(out["['b']"], np.asarray(state["b"]))
    assert out["['step']"] == 7
    like = {"w": torch.zeros(64, 32), "b": torch.zeros(32, dtype=torch.int32),
            "step": 0}
    got = load_sharded(path, like=like)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(state["w"]))
    assert got["b"].dtype == torch.int32 and got["step"] == 7
    sub = load_sharded(path, slices={"['w']": (slice(30, 40), slice(5, 29))})
    np.testing.assert_array_equal(sub["['w']"],
                                  np.asarray(state["w"])[30:40, 5:29])


def test_jax_reads_a_port_save(tmp_path):
    state, _, _ = _port_state(steps=1)
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=1, wait=True)
    assert jck.is_committed(path, 1) and jck.checkpoint_step(path) == 1
    got = jck.load_sharded(path)
    want = load_sharded(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_state_after_one_step():
    jcfg, _ = _configs()
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    opt = jts.default_optimizer()
    state, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(0))
    step = jts.make_train_step(jcfg, mesh, opt, sh)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
    state, _ = step(state, jb)
    return state, step, jb


def test_jax_train_state_restores_into_the_port_and_steps_alike(tmp_path):
    jstate, jstep, jb = _jax_state_after_one_step()
    path = str(tmp_path / "ckpt")
    jck.save_sharded(jstate, path, step=1, wait=True)
    _, tcfg = _configs()
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(tcfg, opt, seed=9, device="cpu")
    load_sharded(path, like=state)
    assert int(state.step) == 1
    count = {float(st["step"]) for st in state.opt_state.state.values()}
    assert count == {1.0}
    jstate, jm = jstep(jstate, jb)
    _, tm = tts.make_train_step(tcfg, opt)(state, _torch_batch(
        {k: np.asarray(v) for k, v in jb.items()}))
    np.testing.assert_allclose(
        [tm["loss"].item(), tm["grad_norm"].item()],
        [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-5)
    got = params_to_numpy(state.params)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        np.testing.assert_allclose(_at(got, path_), np.asarray(leaf),
                                   atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path_))
    assert int(tm["step"]) == int(jm["step"]) == 2


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_port_train_state_restores_into_jax_and_steps_alike(tmp_path):
    """The other way: a port TrainState saved after one step restores into
    the JAX package's TrainState through its own ``load_sharded(like=)``,
    and the next step agrees."""
    jcfg, tcfg = _configs()
    jstate0, _, jb = _jax_state_after_one_step()  # a template of the tree
    init = _jax_init_params()
    opt = tts.default_optimizer()
    state, _ = tts.make_sharded_state(
        tcfg, opt, seed=0, device="cpu",
        params=params_from_numpy(init, device="cpu"))
    step = tts.make_train_step(tcfg, opt)
    tb = _torch_batch({k: np.asarray(v) for k, v in jb.items()})
    step(state, tb)
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=1, wait=True)
    jstate = jck.load_sharded(path, like=jstate0)
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jopt = jts.default_optimizer()
    _, sh = jts.make_sharded_state(jcfg, mesh, jopt, jax.random.key(0))
    jstep = jts.make_train_step(jcfg, mesh, jopt, sh)
    jstate, jm = jstep(jstate, jb)
    _, tm = step(state, tb)
    np.testing.assert_allclose(
        [tm["loss"].item(), tm["grad_norm"].item()],
        [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-5)
    got = params_to_numpy(state.params)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        np.testing.assert_allclose(_at(got, path_), np.asarray(leaf),
                                   atol=2e-5)


def _jax_init_params():
    jcfg, _ = _configs()
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    state, _ = jts.make_sharded_state(jcfg, mesh, jts.default_optimizer(),
                                      jax.random.key(0))
    return jax.tree.map(np.array, state.params)


# -- two processes ------------------------------------------------------------

_TWO_PROCESS_SCRIPT = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.train import is_committed, load_sharded, save_sharded

    rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": torch.ones(4), "step": 3}
    if rank == 0:
        h = save_sharded(state, path, step=3)
        own = os.path.join(path, "shard_0.3.ok")
        while not os.path.exists(own):
            time.sleep(0.005)
        time.sleep(0.5)  # process 0's barrier polls; the peer has not saved
        peer = os.path.exists(os.path.join(path, "shard_1.3.ok"))
        print("EARLY", is_committed(path), peer, flush=True)
        dist.barrier()
    else:
        dist.barrier()  # save only after process 0 looked
        h = save_sharded(state, path, step=3)
    h.wait(timeout=60)
    dist.barrier()
    got = load_sharded(path, like=state)
    ok = all(torch.equal(got[k], state[k]) for k in ("w", "b"))
    print("RESTORED", rank, ok and got["step"] == 3, flush=True)
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_save_one_replicated_state(tmp_path):
    path = str(tmp_path / "ckpt")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCESS_SCRIPT,
                               str(rank), port, path],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "EARLY False False" in outs[0]  # no commit before the peer's marker
    assert "RESTORED 0 True" in outs[0] and "RESTORED 1 True" in outs[1]
    assert is_committed(path, 3)
    commit = os.path.getmtime(os.path.join(path, "COMMIT"))
    assert commit >= os.path.getmtime(os.path.join(path, "shard_1.3.ok"))
    # process 0 wrote every piece; process 1 only its index and marker
    with open(os.path.join(path, "index_1.3.pkl"), "rb") as f:
        assert pickle.load(f) == {}
    with open(os.path.join(path, "index_0.3.pkl"), "rb") as f:
        assert sorted(pickle.load(f)) == ["['b']", "['w']"]
    assert jck.load_sharded(path)["['step']"] == 3


# -- states over a mesh: four gloo processes ----------------------------------
#
# The counterpart of tests/test_sharded_checkpoint.py:39-93 on the port's
# DTensor states (tests/torch_gloo.py): a port save from a 2 x 2 ("dp",
# "tp") mesh restores bit for bit into a dp = 4 FSDP mesh (in the ranks),
# into one unsharded process and into JAX on dp = 2, tp = 4 (here); a JAX
# dp = 2, tp = 4 save restores bit for bit into the port's 2 x 2 mesh (in
# the ranks). The port's save is taken while the next step runs (the
# snapshot rule, for local shards).

_MESH_SCRIPT = """
import json
import pickle
import numpy as np
import torch
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import load_sharded, save_sharded
from ray_tpu_torch.train.sharded_checkpoint import _leaves

cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32)
batch = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/batch.npz").items()}


def arrays(state):
    out = {}
    for key, leaf in _leaves(state):
        t = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
        out[key] = (t.detach().numpy().copy() if isinstance(t, torch.Tensor)
                    else np.array(t))  # copies: the state changes in place
    return out


mesh22 = tmesh.build_mesh(tmesh.MeshConfig(dp=2, tp=2), "cpu")
opt = tts.default_optimizer()
state, sh = tts.make_sharded_state(
    cfg, opt, 0, params=params_from_numpy(
        pickle.load(open(f"{work}/init.pkl", "rb")), device="cpu"),
    mesh=mesh22)
step = tts.make_train_step(cfg, opt, mesh=mesh22, state_shardings=sh)
step(state, batch)
at_save = arrays(state)
handle = save_sharded(state, f"{work}/port22", step=1)
step(state, batch)  # the loop goes on while the write runs
handle.wait(timeout=120)
placements = {key: [repr(p) for p in leaf.placements]
              for key, leaf in _leaves(state) if hasattr(leaf, "placements")}

mesh4 = tmesh.build_mesh(tmesh.MeshConfig(dp=4), "cpu")
opt4 = tts.default_optimizer()
st4, _ = tts.make_sharded_state(cfg, opt4, 5, mesh=mesh4,
                                rules=tmesh.FSDP_RULES)
assert load_sharded(f"{work}/port22", like=st4) is st4
into_dp4 = arrays(st4)

st22, _ = tts.make_sharded_state(cfg, tts.default_optimizer(), 7,
                                 mesh=mesh22)
load_sharded(f"{work}/jax24", like=st22)
from_jax = arrays(st22)
if rank == 0:
    for name, arrs in (("at_save", at_save), ("into_dp4", into_dp4),
                       ("from_jax", from_jax)):
        with open(f"{work}/{name}.pkl", "wb") as f:
            pickle.dump(arrs, f)
    with open(f"{work}/placements.json", "w") as f:
        json.dump({"placements": placements}, f)
with open(f"{work}/coord{rank}.json", "w") as f:
    json.dump(list(mesh22.get_coordinate()), f)
"""


@pytest.fixture(scope="module")
def mesh_checkpoints(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_ckpt")
    jcfg, _ = _configs()
    batch = _batch(jcfg.vocab_size, b=4)
    np.savez(work / "batch.npz", **batch)
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(_jax_init_params(), f)
    mesh = build_mesh(MeshConfig(dp=2, tp=4))
    opt = jts.default_optimizer()
    jstate, sh = jts.make_sharded_state(jcfg, mesh, opt, jax.random.key(3))
    data_sh = jts.batch_sharding(mesh)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh) for k, v in batch.items()}
    jstate, _ = jts.make_train_step(jcfg, mesh, opt, sh)(jstate, jb)
    jck.save_sharded(jstate, str(work / "jax24"), step=1, wait=True)
    run_ranks(_MESH_SCRIPT, 4, work, timeout=240)
    loaded = {name: pickle.load(open(work / f"{name}.pkl", "rb"))
              for name in ("at_save", "into_dp4", "from_jax")}
    return work, loaded


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        got_k, want_k = np.asarray(got[k]), np.asarray(want[k])
        assert got_k.dtype == want_k.dtype, k
        np.testing.assert_array_equal(got_k, want_k, err_msg=k)


def test_mesh_save_restores_into_another_mesh(mesh_checkpoints):
    work, loaded = mesh_checkpoints
    saved = load_sharded(str(work / "port22"))
    _assert_bitwise(saved, loaded["at_save"])  # the snapshot at save time
    _assert_bitwise(loaded["into_dp4"], saved)


def test_mesh_save_restores_into_one_process(mesh_checkpoints):
    work, loaded = mesh_checkpoints
    state, _, _ = _port_state(seed=9, steps=0)
    load_sharded(str(work / "port22"), like=state)
    from ray_tpu_torch.train.sharded_checkpoint import _leaves

    got = {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v)) for k, v in _leaves(state)}
    _assert_bitwise(got, loaded["at_save"])


def test_mesh_save_restores_into_jax_on_dp2_tp4(mesh_checkpoints):
    work, loaded = mesh_checkpoints
    jcfg, _ = _configs()
    mesh = build_mesh(MeshConfig(dp=2, tp=4))
    template, _ = jts.make_sharded_state(jcfg, mesh, jts.default_optimizer(),
                                         jax.random.key(1))
    jstate = jck.load_sharded(str(work / "port22"), like=template)
    got = {jax.tree_util.keystr(p): np.asarray(x)
           for p, x in jax.tree_util.tree_leaves_with_path(jstate)}
    _assert_bitwise(got, loaded["at_save"])
    assert jstate.params["embed"].sharding.spec[0] == "tp"


def test_jax_dp2_tp4_save_restores_into_the_port_mesh(mesh_checkpoints):
    work, loaded = mesh_checkpoints
    _assert_bitwise(loaded["from_jax"], load_sharded(str(work / "jax24")))


def test_only_coordinate_zero_replicas_wrote_pieces(mesh_checkpoints):
    """Each box of every leaf was written once, by the rank at coordinate 0
    of each mesh axis on which the leaf is replicated; leaves that are not
    DTensors (step, AdamW's count) by process 0 alone."""
    work, _ = mesh_checkpoints
    placements = json.loads((work / "placements.json").read_text())[
        "placements"]
    coords = [json.loads((work / f"coord{r}.json").read_text())
              for r in range(4)]
    manifest = json.loads((work / "port22" / "manifest.json").read_text())
    writers = {}
    for pid in range(4):
        with open(work / "port22" / f"index_{pid}.1.pkl", "rb") as f:
            for key, entries in pickle.load(f).items():
                for box, _fname in entries:
                    writers.setdefault(key, []).append((pid, tuple(
                        map(tuple, box))))
    assert sorted(writers) == sorted(k for k, m in manifest["leaves"].items()
                                     if not m.get("aux"))
    for key, pieces in writers.items():
        boxes = [b for _, b in pieces]
        assert len(set(boxes)) == len(boxes), (key, pieces)  # once each
        shape = manifest["leaves"][key]["shape"]
        assert sum(int(np.prod([b - a for a, b in box])) for box in boxes) \
            == int(np.prod(shape)), key  # and they tile the leaf
        pl = placements.get(key)
        for pid, _ in pieces:
            if pl is None:
                assert pid == 0, key
            else:
                assert all(c == 0 for p, c in zip(pl, coords[pid])
                           if p == "Replicate()"), (key, pid, pl)
    sharded_tp = [k for k, pl in placements.items()
                  if pl == ["Replicate()", "Shard(dim=0)"]]
    assert sharded_tp and all(sorted(p for p, _ in writers[k]) == [0, 1]
                              for k in sharded_tp)


def test_a_torn_mesh_save_is_refused(mesh_checkpoints):
    import shutil

    work, _ = mesh_checkpoints
    torn = work / "torn"
    shutil.copytree(work / "port22", torn)
    os.remove(torn / "COMMIT")
    with pytest.raises(FileNotFoundError, match="committed"):
        load_sharded(str(torn))


@pytest.mark.parametrize("scheme", ["file", "mock-bucket"])
def test_upload_and_download_round_trip_bitwise(tmp_path, scheme):
    """``upload_sharded_checkpoint`` pushes a committed checkpoint to
    external storage; ``download_sharded_checkpoint`` fetches it into a
    fresh directory, and ``load_sharded`` restores the state bit for bit
    (the reference's upload/download pair, on a local path and on the
    bucket code path)."""
    from ray_tpu_torch.train import (
        download_sharded_checkpoint,
        upload_sharded_checkpoint,
    )

    state, _, _ = _port_state(steps=2)
    path = str(tmp_path / "ckpt")
    save_sharded(state, path, step=2, wait=True)
    base = f"{scheme}://{tmp_path / 'remote'}"
    uri = upload_sharded_checkpoint(path, base, step=2)
    assert uri.rstrip("/").rsplit("/", 1)[1] == "ckpt"
    local = str(tmp_path / "fresh" / "ckpt")
    assert download_sharded_checkpoint(f"{base}/ckpt", local) == local
    assert is_committed(local, 2) and checkpoint_step(local) == 2
    fresh, _, _ = _port_state(seed=5, steps=0)
    load_sharded(local, like=fresh)
    _assert_same(_state_arrays(fresh), _state_arrays(state))


def test_upload_refuses_an_uncommitted_checkpoint(tmp_path):
    from ray_tpu_torch.train import upload_sharded_checkpoint

    (tmp_path / "torn").mkdir()
    with pytest.raises(RuntimeError, match="not committed"):
        upload_sharded_checkpoint(str(tmp_path / "torn"),
                                  f"file://{tmp_path / 'remote'}")
