"""Search-space primitives + sample/grid expansion.

Parity: reference ``ray.tune`` search space API (``tune.grid_search``,
``tune.choice/uniform/loguniform/randint``) and the basic-variant-generator
(grid x random sampling) that backs ``Tuner(param_space=...)``.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List


class _Domain:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class GridSearch:
    def __init__(self, values: List[Any]):
        if not values:
            raise ValueError("grid_search needs at least one value")
        self.values = list(values)


class Choice(_Domain):
    def __init__(self, values: List[Any]):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


class Uniform(_Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(_Domain):
    def __init__(self, low: float, high: float):
        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be > 0")
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class RandInt(_Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


# -- public constructors (parity: tune.grid_search etc.) --

def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def choice(values: List[Any]) -> Choice:
    return Choice(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed: int = 0
) -> List[Dict[str, Any]]:
    """Expand grid axes (cartesian product), then draw ``num_samples``
    random samples of the stochastic axes for each grid point (the
    reference basic variant generator's semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    variants = []
    for combo in itertools.product(*grid_values) if grid_keys else [()]:
        for _ in range(num_samples):
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, _Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


# ---------------- adaptive searchers (suggest-based) ----------------
#
# Parity: reference ``python/ray/tune/search/`` — Searcher base
# (search/searcher.py), ConcurrencyLimiter (search/concurrency_limiter.py),
# and the TPE family the reference gets via hyperopt/optuna integrations
# (search/hyperopt/, search/optuna/). This build implements TPE natively
# (no external dependency): split observations at the top-gamma quantile,
# model per-param densities l(x) (good) and g(x) (rest) as Parzen mixtures,
# and suggest the candidate maximizing l/g.


class Searcher:
    """suggest(trial_id) -> config dict, or None = nothing to suggest *right
    now* (back off and ask again); is_finished() -> True = the searcher will
    never suggest again (exhausted). The two are distinct: an async searcher
    may momentarily return None while more suggestions are coming, and the
    tuner must not end the experiment on the first idle None.
    on_trial_complete(trial_id, result, error) feeds the model."""

    def suggest(self, trial_id: str):
        raise NotImplementedError

    def is_finished(self) -> bool:
        return False

    def on_trial_complete(self, trial_id: str, result=None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """The default: pre-expanded grid x random variants, served in order."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int,
                 seed: int = 0):
        self._variants = generate_variants(param_space, num_samples, seed)
        self._i = 0

    def suggest(self, trial_id):
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg

    def is_finished(self):
        return self._i >= len(self._variants)


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions from the wrapped searcher (adaptive
    searchers need completions before suggesting well; unlimited
    parallelism degrades them to random search)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def is_finished(self):
        return self.searcher.is_finished()

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over _Domain params (native; the
    reference reaches TPE through hyperopt). Non-domain keys pass through
    as constants; GridSearch is not supported here (use the basic
    generator for grids)."""

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", n_initial: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"TPESearcher does not take grid_search axes ({k!r})"
                )
        self.space = dict(param_space)
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._obs: List[Dict[str, Any]] = []  # {"config", "score"}
        self._pending: Dict[str, Dict] = {}

    def _random_config(self) -> Dict[str, Any]:
        return {
            k: (v.sample(self.rng) if isinstance(v, _Domain) else v)
            for k, v in self.space.items()
        }

    # -- Parzen densities --

    @staticmethod
    def _gauss(x: float, mu: float, sigma: float) -> float:
        z = (x - mu) / sigma
        return math.exp(-0.5 * z * z) / (sigma * 2.5066282746310002)

    def _numeric_density(self, x: float, values: List[float],
                         lo: float, hi: float, log: bool) -> float:
        if log:
            x, values = math.log(x), [math.log(v) for v in values]
            lo, hi = math.log(lo), math.log(hi)
        span = max(hi - lo, 1e-12)
        bw = max(span / max(1.0, math.sqrt(len(values))), span * 0.02)
        # uniform prior component keeps densities > 0 everywhere
        prior = 1.0 / span
        mix = sum(self._gauss(x, v, bw) for v in values) / len(values)
        return 0.2 * prior + 0.8 * mix

    def _cat_density(self, x, values: List, choices: List) -> float:
        counts = {c: 1.0 for c in choices}  # +1 smoothing
        for v in values:
            counts[v] = counts.get(v, 1.0) + 1.0
        total = sum(counts.values())
        return counts.get(x, 1.0) / total

    def _ratio(self, cfg: Dict, good: List[Dict], bad: List[Dict]) -> float:
        score = 0.0  # log l(x)/g(x), summed over params (TPE independence)
        for k, dom in self.space.items():
            if not isinstance(dom, _Domain):
                continue
            gv = [c[k] for c in good]
            bv = [c[k] for c in bad]
            if isinstance(dom, (Uniform, LogUniform, RandInt)):
                log = isinstance(dom, LogUniform)
                lo = float(dom.low)
                hi = float(dom.high)
                l_d = self._numeric_density(float(cfg[k]), gv, lo, hi, log)
                g_d = self._numeric_density(float(cfg[k]), bv, lo, hi, log)
            elif isinstance(dom, Choice):
                l_d = self._cat_density(cfg[k], gv, dom.values)
                g_d = self._cat_density(cfg[k], bv, dom.values)
            else:
                continue
            score += math.log(max(l_d, 1e-300)) - math.log(max(g_d, 1e-300))
        return score

    def _sample_from_good(self, good: List[Dict]) -> Dict[str, Any]:
        """Draw one candidate from the Parzen mixture l(x): per param, pick
        a good observation's value and jitter by the kernel bandwidth."""
        cfg: Dict[str, Any] = {}
        for k, dom in self.space.items():
            if not isinstance(dom, _Domain):
                cfg[k] = dom
                continue
            pick = self.rng.choice(good)[k]
            if isinstance(dom, Choice):
                # smoothed categorical over good values
                cfg[k] = (pick if self.rng.random() < 0.8
                          else self.rng.choice(dom.values))
            elif isinstance(dom, (Uniform, LogUniform, RandInt)):
                log = isinstance(dom, LogUniform)
                lo, hi = float(dom.low), float(dom.high)
                x = math.log(pick) if log else float(pick)
                s_lo, s_hi = (math.log(lo), math.log(hi)) if log else (lo, hi)
                span = max(s_hi - s_lo, 1e-12)
                bw = max(span / max(1.0, math.sqrt(len(good))), span * 0.02)
                x = min(s_hi, max(s_lo, self.rng.gauss(x, bw)))
                val = math.exp(x) if log else x
                if isinstance(dom, RandInt):
                    val = int(min(dom.high - 1, max(dom.low, round(val))))
                cfg[k] = val
            else:
                cfg[k] = dom.sample(self.rng)
        return cfg

    def suggest(self, trial_id):
        if len(self._obs) < self.n_initial:
            cfg = self._random_config()
        else:
            ranked = sorted(self._obs, key=lambda o: -o["score"])
            n_good = max(1, int(len(ranked) * self.gamma))
            good = [o["config"] for o in ranked[:n_good]]
            bad = [o["config"] for o in ranked[n_good:]] or good
            # candidates drawn from l(x) (perturbed good configs), plus a
            # prior-sampled tail for exploration
            n_from_l = (self.n_candidates * 3) // 4
            cands = [self._sample_from_good(good) for _ in range(n_from_l)]
            cands += [self._random_config()
                      for _ in range(self.n_candidates - n_from_l)]
            cfg = max(cands, key=lambda c: self._ratio(c, good, bad))
        self._pending[trial_id] = cfg
        return dict(cfg)

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._obs.append(
            {"config": cfg, "score": v if self.mode == "max" else -v}
        )
