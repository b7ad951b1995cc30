"""ray_tpu_torch.tune — the Tune-equivalent hyperparameter library.

    from ray_tpu_torch import tune

    def objective(config):
        from ray_tpu_torch.train import session
        for step in range(10):
            session.report({"score": f(config, step)})

    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.loguniform(1e-4, 1e-1),
                     "width": tune.grid_search([32, 64])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=4,
            scheduler=tune.ASHAScheduler(metric="score"),
        ),
    ).fit()
    best = grid.get_best_result()

Parity: reference ``python/ray/tune`` — Tuner (tuner.py:53), controller
(tune_controller.py:49), ASHA (schedulers/async_hyperband.py), PBT
(schedulers/pbt.py), search spaces (basic variant generator). Trainables
report through the same worker-side session as Train.
"""

from ray_tpu_torch.train.session import report  # noqa: F401 — tune.report parity
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid,
    TrialResult,
    TuneConfig,
    Tuner,
)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
    "PopulationBasedTraining", "PB2",
    "Searcher", "BasicVariantGenerator", "ConcurrencyLimiter", "TPESearcher",
    "report",
]
