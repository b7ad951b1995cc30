"""Trial schedulers: FIFO, ASHA early stopping, Population Based Training.

Parity: reference ``python/ray/tune/schedulers/`` —
``async_hyperband.py`` (ASHA) and ``pbt.py`` (PBT). The controller calls
``on_trial_result`` for every report and acts on the returned decision.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: restart this trial with a new config + checkpoint (exploit+explore)
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_trial_result(self, trial, result) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result) -> None:
        pass


class ASHAScheduler:
    """Async Successive Halving: when a trial reaches rung r (iteration
    grace_period * reduction_factor^k), it continues only if its metric is
    in the top 1/reduction_factor of results recorded at that rung."""

    def __init__(self, metric: str, mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        if mode not in ("max", "min"):
            raise ValueError("mode must be max|min")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung iteration -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = {}
        self._trial_last_it: Dict[Any, int] = {}
        r = grace_period
        self._rung_levels = []
        while r < max_t:
            self._rung_levels.append(r)
            r *= reduction_factor

    def _score(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result) -> str:
        it = int(result.get("training_iteration", 0))
        last = self._trial_last_it.get(trial, 0)
        self._trial_last_it[trial] = it
        # rung CROSSING, not exact membership: a trial reporting every k-th
        # iteration must still be evaluated at the rung it passed
        crossed = [r for r in self._rung_levels if last < r <= it]
        if not crossed:
            return CONTINUE
        score = self._score(result)
        for rung in crossed:
            recorded = self._rungs.setdefault(rung, [])
            recorded.append(score)
            recorded.sort(reverse=True)
            k = max(1, len(recorded) // self.rf)
            cutoff = recorded[k - 1]
            if score < cutoff:
                return STOP
        return CONTINUE

    def on_trial_complete(self, trial, result) -> None:
        pass


class PopulationBasedTraining:
    """PBT: every ``perturbation_interval`` iterations, a bottom-quantile
    trial clones a top-quantile trial's checkpoint and config, with
    hyperparameters perturbed (x1.2 / x0.8) or resampled."""

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self._last: Dict[Any, Tuple[int, float]] = {}  # trial -> (iter, score)
        self.num_exploits = 0

    def _score(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result) -> str:
        it = int(result.get("training_iteration", 0))
        self._last[trial] = (it, self._score(result))
        if it == 0 or it % self.interval:
            return CONTINUE
        scores = sorted(
            (s for _, s in self._last.values()), reverse=True
        )
        if len(scores) < 3:
            return CONTINUE
        n_q = max(1, int(len(scores) * self.quantile))
        lower_cut = scores[-n_q]
        my = self._score(result)
        if my <= lower_cut and my < scores[n_q - 1]:
            return EXPLOIT
        return CONTINUE

    def exploit_target(self, trials) -> Optional[Any]:
        """Pick a top-quantile trial to clone from."""
        scored = [
            (self._last[t][1], t) for t in trials if t in self._last
        ]
        if not scored:
            return None
        scored.sort(key=lambda x: -x[0])
        n_q = max(1, int(len(scored) * self.quantile))
        return self.rng.choice([t for _, t in scored[:n_q]])

    def explore(self, config: Dict) -> Dict:
        """Perturb the donor's config (x1.2 / x0.8 or resample)."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            elif callable(getattr(spec, "sample", None)):
                out[key] = spec.sample(self.rng)
            elif isinstance(out[key], (int, float)):
                out[key] = out[key] * self.rng.choice([0.8, 1.2])
        self.num_exploits += 1
        return out

    def on_trial_complete(self, trial, result) -> None:
        self._last.pop(trial, None)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (Parker-Holder et al., NeurIPS 2020;
    reference ``python/ray/tune/schedulers/pb2.py``): PBT's exploit step
    with the random perturbation replaced by a GP-UCB bandit — the GP is
    fit on (time, hyperparams) -> reward-improvement observations
    gathered from the whole population, and ``explore`` picks the
    hyperparameters maximizing the UCB acquisition over
    ``hyperparam_bounds``. Numpy-only (no GPy dependency): an RBF-kernel
    GP over standardized inputs with a jittered Cholesky solve.

    Continuous dims come from ``hyperparam_bounds``; anything in
    ``hyperparam_mutations`` keeps PBT's categorical resampling.
    """

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_bounds: Optional[Dict[str, Tuple[float, float]]]
                 = None,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 ucb_candidates: int = 256, min_observations: int = 4):
        super().__init__(
            metric, mode, perturbation_interval,
            hyperparam_mutations=hyperparam_mutations,
            quantile_fraction=quantile_fraction, seed=seed,
        )
        self.bounds = dict(hyperparam_bounds or {})
        if not self.bounds:
            raise ValueError("PB2 needs hyperparam_bounds")
        self.ucb_candidates = ucb_candidates
        self.min_observations = min_observations
        self._keys = sorted(self.bounds)
        # observations: (t, x_vec) -> reward delta over one interval
        self._obs_X: List[List[float]] = []
        self._obs_y: List[float] = []
        self._t = 0
        # trial -> score at its previous interval boundary
        self._boundary_score: Dict[Any, float] = {}

    _MAX_OBS = 500  # GP fit window: O(n^3) Cholesky must stay bounded

    # -- data collection --
    def on_trial_result(self, trial, result) -> str:
        it = int(result.get("training_iteration", 0))
        if it and it % self.interval == 0:
            score = self._score(result)
            prev = self._boundary_score.get(trial)
            if prev is not None:
                cfg = getattr(trial, "config", {}) or {}
                try:
                    x = [float(cfg[k]) for k in self._keys]
                except (KeyError, TypeError, ValueError):
                    x = None
                if x is not None:
                    self._t += 1
                    self._obs_X.append([float(self._t), *x])
                    self._obs_y.append(score - prev)
                    if len(self._obs_y) > self._MAX_OBS:
                        self._obs_X = self._obs_X[-self._MAX_OBS:]
                        self._obs_y = self._obs_y[-self._MAX_OBS:]
            self._boundary_score[trial] = score
        decision = super().on_trial_result(trial, result)
        if decision == EXPLOIT:
            # the trial restarts from the DONOR's checkpoint: its next
            # boundary delta would otherwise be measured against the
            # pre-exploit (bottom-quantile) score, crediting the
            # checkpoint jump to the new hyperparameters and poisoning
            # the GP with a huge spurious improvement
            self._boundary_score.pop(trial, None)
        return decision

    # -- GP-UCB explore --
    def explore(self, config: Dict) -> Dict:
        out = super().explore(config)  # categorical mutations + count
        if len(self._obs_y) < self.min_observations:
            # cold start: uniform sample inside the bounds (PBT's x0.8/
            # x1.2 can't escape a bad initial scale; uniform can)
            for k in self._keys:
                lo, hi = self.bounds[k]
                out[k] = lo + (hi - lo) * self.rng.random()
            return out
        import numpy as np

        X = np.asarray(self._obs_X, dtype=np.float64)
        y = np.asarray(self._obs_y, dtype=np.float64)
        # standardize inputs (time + each hyperparam) and center y
        mu_x, sd_x = X.mean(0), X.std(0) + 1e-9
        Xs = (X - mu_x) / sd_x
        y_mean, y_sd = y.mean(), y.std() + 1e-9
        ys = (y - y_mean) / y_sd

        def rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / max(1.0, A.shape[1]))

        K = rbf(Xs, Xs) + 1e-4 * np.eye(len(Xs))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, ys))

        # candidates at the NEXT time step, uniform over bounds
        rng = np.random.RandomState(self.rng.randrange(2 ** 31))
        n = self.ucb_candidates
        cand = np.empty((n, 1 + len(self._keys)))
        cand[:, 0] = self._t + 1
        for j, k in enumerate(self._keys):
            lo, hi = self.bounds[k]
            cand[:, 1 + j] = rng.uniform(lo, hi, n)
        Cs = (cand - mu_x) / sd_x
        Kc = rbf(Cs, Xs)
        mean = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        # GP-UCB beta: the practical schedule from the PB2 paper's code
        beta = 0.2 * len(self._keys) * np.log(2.0 * max(2, self._t))
        ucb = mean + np.sqrt(beta * var)
        best = cand[int(ucb.argmax())]
        for j, k in enumerate(self._keys):
            lo, hi = self.bounds[k]
            out[k] = float(min(hi, max(lo, best[1 + j])))
        return out

    def on_trial_complete(self, trial, result) -> None:
        self._boundary_score.pop(trial, None)
        super().on_trial_complete(trial, result)


class MedianStoppingRule:
    """Stop a trial at iteration t if its best metric so far is worse than
    the median of other trials' running averages at iteration >= t (parity:
    reference ``tune/schedulers/median_stopping_rule.py``)."""

    def __init__(self, metric: str, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        if mode not in ("max", "min"):
            raise ValueError("mode must be max|min")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial -> list of scores per report (score = metric, sign-fixed)
        self._history: Dict[Any, List[float]] = {}

    def _score(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result) -> str:
        it = int(result.get("training_iteration", len(
            self._history.get(trial, [])) + 1))
        h = self._history.setdefault(trial, [])
        h.append(self._score(result))
        if it < self.grace_period:
            return CONTINUE
        # running averages (up to iteration it) of OTHER trials that have at
        # least grace_period reports — NOT `>= it` reports: concurrent
        # trials advance in lockstep, so the first trial polled each round
        # would never see an eligible comparator
        others = [
            sum(v[:it]) / min(it, len(v))
            for t, v in self._history.items()
            if t is not trial and len(v) >= self.grace_period
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        if max(h) < median:
            return STOP
        return CONTINUE

    def on_trial_complete(self, trial, result) -> None:
        pass
