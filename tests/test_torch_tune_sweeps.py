"""The port's Tuner against the JAX package's, the longer flows of
tests/test_tune.py: PBT's exploits (trials restarted from a donor's
checkpoint) and ``Tuner.restore`` after the sweep's driver dies. Each runs
once on each package, in one runtime session per package (the
reference's with the cyclic GC paused, ``torch_parity.run_flows``)."""

import importlib
import os
import time

import pytest
from torch_parity import norm, run_flows

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _tune(name):
    return importlib.import_module(name + ".tune")


def pbt_exploits_and_perturbs(rt, tune, tmp):
    def objective(config):
        import importlib as _il
        import time as _t

        train = _il.import_module(config["pkg"] + ".train")
        session = train.session
        start = session.get_checkpoint()
        base = 0 if start is None else start.to_dict()["it"]
        for i in range(base + 1, base + 13):
            session.report({"score": config["lr"] * 10 + i * 0.01,
                            "training_iteration": i},
                           checkpoint=train.Checkpoint.from_dict({"it": i}))
            _t.sleep(0.02)

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0]})
    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.1, 0.3, 0.6, 1.0]),
                     "pkg": rt.__name__},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=4,
                                    scheduler=pbt)).fit()
    assert pbt.num_exploits >= 1, "PBT never exploited"
    assert grid.get_best_result().metrics["score"] >= 10.0
    return [pbt.num_exploits >= 1,
            grid.get_best_result().metrics["score"] >= 10.0, len(grid)]


def tuner_restore_after_driver_death(rt, tune, tmp):
    """The sweep's driver (an actor) is killed mid-experiment;
    ``Tuner.restore`` finishes it: every trial accounted for, unfinished
    ones resumed from their last checkpoints."""
    import cloudpickle

    pkg = rt.__name__

    def trainable(config):
        import importlib as _il
        import time as _t

        train = _il.import_module(config["pkg"] + ".train")
        start = 0
        ck = train.session.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["it"] + 1
        for it in range(start, 4):
            train.session.report(
                {"score": config["x"] * 10 + it, "it": it},
                checkpoint=train.Checkpoint.from_dict({"it": it}))
            _t.sleep(0.4)

    @rt.remote(num_cpus=0.1, max_concurrency=2)
    class SweepDriver:
        def run(self, storage, pkg):
            import importlib as _il

            t = _il.import_module(pkg + ".tune")
            t.Tuner(trainable,
                    param_space={"x": t.grid_search([1, 2, 3, 4]),
                                 "pkg": pkg},
                    tune_config=t.TuneConfig(metric="score", mode="max",
                                             num_samples=1,
                                             max_concurrent_trials=2),
                    storage_path=storage, name="sweep").fit()
            return "done"

    drv = SweepDriver.remote()
    drv.run.remote(tmp, pkg)
    state_file = os.path.join(tmp, "sweep", "tuner_state.pkl")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if os.path.exists(state_file):
            with open(state_file, "rb") as f:
                st = cloudpickle.load(f)
            done = sum(t.status == "TERMINATED" for t in st["trials"])
            progressed = sum(t.iterations > 0 for t in st["trials"])
            if done >= 1 and progressed >= 2:
                break
        time.sleep(0.1)
    else:
        raise AssertionError("sweep made no persisted progress")
    rt.kill(drv)
    res = tune.Tuner.restore(os.path.join(tmp, "sweep")).fit()
    assert len(res) == 4 and not res.errors
    scores = sorted(r.metrics["score"] for r in res)
    assert scores == [13, 23, 33, 43]
    assert all(r.metrics["it"] == 3 for r in res)
    return scores


FLOWS = [pbt_exploits_and_perturbs, tuner_restore_after_driver_death]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 6, "object_store_memory": 256 * 1024 * 1024}

    def args(name):
        return _tune(name), str(tmp_path_factory.mktemp(name))

    return {name: run_flows(name, FLOWS, init, args) for name in PACKAGES}


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)
