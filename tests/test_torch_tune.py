"""The port's Tune library (ray_tpu_torch/tune/) against the JAX package's
(ray_tpu/tune/).

- Pure Python, no cluster: the variant generator, TPE and the concurrency
  limiter give the reference's suggestions for the same seed, and FIFO,
  ASHA, median stopping, PBT and PB2 give its decisions (and PBT/PB2 its
  exploit targets and explored configs) on the same recorded stream of
  results. Equal, not close: the same code over the same ``random``
  streams.
- The Tuner flows of tests/test_tune.py, each run once on each package in
  one runtime session per package (the reference's with the cyclic GC
  paused, ``torch_parity.run_flows``): best-result selection, per-trial
  error isolation, ASHA's early stops, median stopping, and the
  scheduler's trial identity across a snapshot. PBT and restore after the
  sweep's driver dies are in test_torch_tune_sweeps.py, the TPE-driven
  sweep in test_torch_tune_search.py (a file each keeps each file's time
  short).
- Port-only: a trial is a ``_TrainWorker`` that joins no process group
  (rank 0, its device the CPU here), and a trial asking for a card on a
  worker that sees none errors rather than running on the CPU.
"""

import importlib
import os

import numpy as np
import pytest
from torch_parity import norm, plain, run_flows

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _tune(name):
    return importlib.import_module(name + ".tune")


def _both(fn):
    return {name: plain(fn(_tune(name), name)) for name in PACKAGES}


# ------------------------------------------------- pure-Python parity


def test_variant_generation_equals_the_reference():
    def gen(tune, name):
        search = importlib.import_module(name + ".tune.search")
        space = {"a": tune.grid_search([1, 2, 3]),
                 "b": tune.choice(["x", "y"]), "c": 42,
                 "lr": tune.loguniform(1e-4, 1e-1),
                 "u": tune.uniform(-1.0, 1.0), "n": tune.randint(1, 9)}
        v = search.generate_variants(space, num_samples=2, seed=0)
        assert len(v) == 6 and {x["a"] for x in v} == {1, 2, 3}
        lo = search.generate_variants({"lr": tune.loguniform(1e-4, 1e-1)},
                                      20, seed=1)
        assert all(1e-4 <= x["lr"] <= 1e-1 for x in lo)
        basic = search.BasicVariantGenerator(space, 2, seed=5)
        served = [basic.suggest(f"t{i}") for i in range(7)]
        return [v, lo, served, basic.is_finished()]

    got = _both(gen)
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def _tpe_run(tune, name, space, metric, mode, score, n, n_initial, seed):
    search = importlib.import_module(name + ".tune.search")
    s = search.TPESearcher(space, metric=metric, mode=mode,
                           n_initial=n_initial, seed=seed)
    out = []
    for i in range(n):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        s.on_trial_complete(f"t{i}", {metric: score(cfg)})
    return out


def test_tpe_suggestions_equal_the_reference():
    def run(tune, name):
        a = _tpe_run(tune, name, {"x": tune.uniform(0.0, 10.0)}, "score",
                     "max", lambda c: -((c["x"] - 7.3) ** 2), 50, 8, 3)
        assert sum(1 for c in a[-10:] if abs(c["x"] - 7.3) < 2.0) >= 6
        b = _tpe_run(tune, name, {"c": tune.choice(["a", "b", "c"]),
                                  "n": tune.randint(1, 20)}, "loss", "min",
                     lambda c: (0.0 if c["c"] == "b" else 5.0)
                     + abs(c["n"] - 10), 38, 6, 0)
        assert sum(1 for c in b[-8:] if c["c"] == "b") >= 5
        return [a, b]

    got = _both(run)
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_concurrency_limiter_equals_the_reference():
    def run(tune, name):
        search = importlib.import_module(name + ".tune.search")
        base = search.BasicVariantGenerator(
            {"x": tune.grid_search(list(range(6)))}, 1)
        lim = search.ConcurrencyLimiter(base, max_concurrent=2)
        seq = [lim.suggest("t1"), lim.suggest("t2"), lim.suggest("t3")]
        assert seq[2] is None
        lim.on_trial_complete("t1", {"m": 1.0})
        seq.append(lim.suggest("t3"))
        assert seq[3] is not None
        return seq

    got = _both(run)
    assert got["ray_tpu_torch"] == got["ray_tpu"]


class _Trial:
    """A stand-in trial: schedulers key by identity and read ``config``."""

    def __init__(self, i, config):
        self.i, self.config = i, config


def _stream(n_trials=6, iters=12, seed=0):
    """A recorded stream of results: (trial, iteration, value), trials
    interleaved in a seeded order, values a seeded noisy curve per trial."""
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0.1, 2.0, n_trials)
    events = []
    next_it = [1] * n_trials
    while any(it <= iters for it in next_it):
        live = [t for t in range(n_trials) if next_it[t] <= iters]
        t = int(rng.choice(live))
        it = next_it[t]
        next_it[t] += 1
        events.append((t, it, float(quality[t] * it + rng.normal(0, 0.3))))
    return events


def _replay(sched, sched_mod, configs, events):
    trials = [_Trial(i, dict(c)) for i, c in enumerate(configs)]
    stopped, out = set(), []
    for t, it, value in events:
        if t in stopped:
            continue
        trial = trials[t]
        d = sched.on_trial_result(trial, {"score": value,
                                          "training_iteration": it})
        row = [t, it, d]
        if d == sched_mod.STOP:
            stopped.add(t)
            sched.on_trial_complete(trial, {"score": value})
        elif d == sched_mod.EXPLOIT:
            donor = sched.exploit_target([x for x in trials
                                          if x is not trial])
            if donor is not None:
                trial.config = sched.explore(donor.config)
                row += [donor.i, dict(trial.config)]
        out.append(row)
    return out


SCHEDULERS = {
    "fifo": lambda m: m.FIFOScheduler(),
    "asha": lambda m: m.ASHAScheduler(metric="score", mode="max",
                                      grace_period=2, reduction_factor=2,
                                      max_t=12),
    "asha_min": lambda m: m.ASHAScheduler(metric="score", mode="min",
                                          grace_period=1, reduction_factor=3,
                                          max_t=12),
    "median": lambda m: m.MedianStoppingRule(metric="score", grace_period=3,
                                             min_samples_required=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="score", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0]}, seed=4),
    "pb2": lambda m: m.PB2(metric="score", perturbation_interval=2,
                           hyperparam_bounds={"lr": (1e-3, 1.0)}, seed=2,
                           ucb_candidates=64, min_observations=3),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_equal_the_reference(kind, seed):
    events = _stream(seed=seed)
    configs = [{"lr": lr} for lr in (0.1, 0.3, 0.6, 1.0, 0.05, 0.2)]

    def run(tune, name):
        m = importlib.import_module(name + ".tune.schedulers")
        return _replay(SCHEDULERS[kind](m), m, configs, events)

    got = _both(run)
    decisions = {row[2] for row in got["ray_tpu"]}
    if kind in ("asha", "median"):
        assert "STOP" in {str(d).upper() for d in decisions}, decisions
    if kind in ("pbt", "pb2"):
        assert any(len(r) > 3 for r in got["ray_tpu"]), "no exploit"
    assert got["ray_tpu_torch"] == got["ray_tpu"]


# ---------------------------------------------------------- Tuner flows



def tuner_finds_best(rt, tune, tmp):
    pkg = rt.__name__

    def objective(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        score = -abs(config["width"] - 64) + config["bonus"]
        for i in range(3):
            session.report({"score": score + i * 0.1})

    grid = tune.Tuner(
        objective,
        param_space={"width": tune.grid_search([16, 64, 256]),
                     "bonus": 0.0, "pkg": pkg},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3)).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.config["width"] == 64
    assert abs(best.metrics["score"] - 0.2) < 1e-9
    return sorted((r.config["width"], round(r.metrics["score"], 9),
                   r.metrics["training_iteration"]) for r in grid)


def tuner_trial_error_isolated(rt, tune, tmp):
    def objective(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        session.report({"score": config["x"]})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2]), "pkg": rt.__name__},
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    assert len(grid.errors) == 1 and "bad trial" in grid.errors[0].error
    assert grid.get_best_result().config["x"] == 2
    return [len(grid.errors), grid.get_best_result().config["x"],
            sorted(r.config["x"] for r in grid if r.error is None)]


def asha_stops_bad_trials_early(rt, tune, tmp):
    def objective(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        for i in range(1, 9):
            session.report({"score": config["quality"] * i,
                            "training_iteration": i})

    grid = tune.Tuner(
        objective,
        param_space={"quality": tune.grid_search([2.0, 1.0, 0.2, 0.1]),
                     "pkg": rt.__name__},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=tune.ASHAScheduler(metric="score", grace_period=2,
                                         reduction_factor=2, max_t=8))).fit()
    assert grid.get_best_result().config["quality"] == 2.0
    by_q = {r.config["quality"]: r for r in grid}
    assert by_q[2.0].metrics["training_iteration"] == 8
    assert by_q[0.1].metrics["training_iteration"] < 8
    return [by_q[2.0].metrics["training_iteration"],
            by_q[0.1].metrics["training_iteration"] < 8]


def median_stopping_rule(rt, tune, tmp):
    sched = importlib.import_module(rt.__name__ + ".tune.schedulers")

    def objective(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        for it in range(12):
            session.report({"m": config["q"] * (it + 1)})

    res = tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 1.0, 1.1, 1.2]),
                     "pkg": rt.__name__},
        tune_config=tune.TuneConfig(
            metric="m", mode="max", num_samples=1, max_concurrent_trials=5,
            scheduler=sched.MedianStoppingRule(
                metric="m", grace_period=3, min_samples_required=2))).fit()
    stopped = [r for r in res if r.metrics.get("training_iteration", 12) < 12]
    finished = [r for r in res if r.metrics.get("training_iteration") == 12]
    assert finished, "top trials should run to completion"
    assert any(r.config["q"] < 0.5 for r in stopped)
    return [bool(finished), any(r.config["q"] < 0.5 for r in stopped)]


def restore_snapshot_preserves_scheduler_identity(rt, tune, tmp):
    import cloudpickle

    sched = importlib.import_module(rt.__name__ + ".tune.schedulers")

    def trainable(config):
        import importlib as _il

        train = _il.import_module(config["pkg"] + ".train")
        for it in range(3):
            train.session.report(
                {"score": config["x"] + it, "it": it},
                checkpoint=train.Checkpoint.from_dict({"it": it}))

    tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1.0, 2.0]), "pkg": rt.__name__},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=1,
            max_concurrent_trials=2,
            scheduler=sched.ASHAScheduler(metric="score", mode="max",
                                          max_t=3, grace_period=1)),
        storage_path=tmp, name="asha_exp").fit()
    with open(os.path.join(tmp, "asha_exp", "tuner_state.pkl"), "rb") as f:
        st = cloudpickle.load(f)
    trial_ids = {id(t) for t in st["trials"]}
    assert st["scheduler"]._trial_last_it, "ASHA tracked no trials"
    assert all(id(t) in trial_ids for t in st["scheduler"]._trial_last_it)
    pbt = sched.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=1,
        hyperparam_mutations={"x": [1.0, 2.0]})
    explored = cloudpickle.loads(cloudpickle.dumps(pbt)).explore({"x": 1.0})
    assert explored["x"] in (1.0, 2.0)
    return [sorted(t.status for t in st["trials"]), explored]


FLOWS = [tuner_finds_best, tuner_trial_error_isolated,
         asha_stops_bad_trials_early, median_stopping_rule,
         restore_snapshot_preserves_scheduler_identity]


def trial_joins_no_process_group(rt, tune, tmp):
    """Port-only: a trial's session is rank 0 of 1 on its worker's device
    (the CPU when it asks for no card), with no process group."""

    def objective(config):
        import torch.distributed as dist

        from ray_tpu_torch.train import session

        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size(),
                        "device": str(session.get_device()),
                        "pg": dist.is_initialized()})

    grid = tune.Tuner(objective, param_space={"x": tune.grid_search([0, 1])},
                      tune_config=tune.TuneConfig(metric="rank")).fit()
    assert not grid.errors, grid.errors
    return sorted(tuple(sorted(r.metrics.items())) for r in grid)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = {"num_cpus": 6, "object_store_memory": 256 * 1024 * 1024}

    def args(name):
        return _tune(name), str(tmp_path_factory.mktemp(name))

    return {
        "ray_tpu": run_flows("ray_tpu", FLOWS, init, args),
        "ray_tpu_torch": run_flows("ray_tpu_torch",
                                   FLOWS + [trial_joins_no_process_group],
                                   init, args),
    }


@pytest.mark.parametrize("flow", [f.__name__ for f in FLOWS])
def test_flow_matches_the_reference(runs, flow):
    ref, port = runs["ray_tpu"][flow], runs["ray_tpu_torch"][flow]
    assert ref[0] == "value", ref
    assert norm(port) == norm(ref)


def test_a_trial_joins_no_process_group(runs):
    kind, rows = runs["ray_tpu_torch"]["trial_joins_no_process_group"]
    assert kind == "value", rows
    want = (("device", "cpu"), ("pg", False), ("rank", 0),
            ("training_iteration", 1), ("world", 1))
    assert rows == [list(want)] * 2 or rows == [want] * 2


def test_a_gpu_trial_without_a_card_errors():
    """Two trials at ``GPU: 0.5`` share the one (simulated) card; this box
    has no CUDA, so each trial's worker refuses to run rather than train
    on the CPU, and the error reaches the ResultGrid."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    def objective(config):
        from ray_tpu_torch.train import session

        session.report({"device": str(session.get_device())})

    rt.init(num_cpus=4, num_gpus=1, object_store_memory=128 * 1024 * 1024)
    try:
        grid = tune.Tuner(
            objective, param_space={"x": tune.grid_search([0, 1])},
            tune_config=tune.TuneConfig(metric="device",
                                        max_concurrent_trials=2),
            resources_per_trial={"CPU": 1, "GPU": 0.5}).fit()
    finally:
        rt.shutdown()
    assert len(grid) == 2 and len(grid.errors) == 2
    for r in grid.errors:
        assert "sees no CUDA device" in r.error, r.error
        assert r.metrics == {}
