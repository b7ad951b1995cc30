"""The port's Tuner driven by an adaptive searcher (TPE) against the JAX
package's: the TPE sweep of tests/test_tune.py, run once on each package
in one runtime session per package (``torch_parity.run_flows``). The
searcher's own suggestions are compared without a cluster in
test_torch_tune.py."""

import importlib

import pytest
from torch_parity import norm, run_flows

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _tune(name):
    return importlib.import_module(name + ".tune")


def tuner_with_tpe_searcher(rt, tune, tmp):
    search = importlib.import_module(rt.__name__ + ".tune.search")

    def objective(config):
        import importlib as _il

        session = _il.import_module(config["pkg"] + ".train.session")
        session.report({"score": -(config["x"] - 3.0) ** 2})

    res = tune.Tuner(
        objective,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=10,
            max_concurrent_trials=2,
            search_alg=_PkgSearcher(search.TPESearcher(
                {"x": tune.uniform(0.0, 10.0)}, metric="score", mode="max",
                n_initial=4, seed=1), rt.__name__))).fit()
    assert len(res) == 10
    assert abs(res.get_best_result().config["x"] - 3.0) < 3.0
    return len(res)


class _PkgSearcher:
    """Adds the package's name to each suggested config (the trainable
    imports that package's session)."""

    def __init__(self, inner, pkg):
        self.inner, self.pkg = inner, pkg

    def suggest(self, trial_id):
        cfg = self.inner.suggest(trial_id)
        return None if cfg is None else dict(cfg, pkg=self.pkg)

    def is_finished(self):
        return self.inner.is_finished()

    def on_trial_complete(self, trial_id, result=None, error=False):
        self.inner.on_trial_complete(trial_id, result, error=error)


FLOWS = [tuner_with_tpe_searcher]


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
