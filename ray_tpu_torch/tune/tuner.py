"""Tuner + trial controller (PyTorch port of ``ray_tpu/tune/tuner.py``).

Parity: reference ``python/ray/tune/tuner.py:53`` /
``execution/tune_controller.py:49`` (``step():267``): trials run as actors
(reusing the Train worker-actor body — one shared AIR execution substrate,
like the reference's RayActorManager), the controller polls reports,
feeds them to the scheduler (FIFO/ASHA/PBT), and assembles a ResultGrid.

A trial that asks for ``GPU`` in ``resources_per_trial`` gets its card
through the named-card lease (a fraction shares one card: two trials at
``{"GPU": 0.5}`` both see card 0 as ``cuda:0``), and its session's
``get_device()`` is that card. Trial actors join no process group:
``get_world_rank()`` is 0.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import _TrainWorker
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, STOP, FIFOScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 2
    scheduler: Any = None  # FIFOScheduler | ASHAScheduler | PBT | Median
    # adaptive Searcher (TPESearcher / ConcurrencyLimiter); None = the
    # basic grid x random variant generator over param_space
    search_alg: Any = None
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be max|min")


class Trial:
    _next = 0

    @classmethod
    def next_id(cls) -> str:
        cls._next += 1
        return f"trial_{cls._next:05d}"

    def __init__(self, config: Dict[str, Any],
                 trial_id: Optional[str] = None):
        self.trial_id = trial_id or Trial.next_id()
        self.config = config
        self.status = PENDING
        self.actor = None
        self.poll_ref = None  # outstanding poll (one in flight per trial)
        self.last_result: Dict[str, Any] = {}
        self.iterations = 0
        self.error: Optional[str] = None
        self.checkpoint: Optional[Dict] = None  # latest reported (dict form)
        self.start_checkpoint: Optional[Dict] = None  # for PBT exploits

    def __getstate__(self):
        # Trials travel into the experiment-state snapshot (Tuner.restore);
        # live handles don't survive a driver death and must not be
        # serialized — schedulers keyed by Trial identity keep working
        # because the UNPICKLED objects are the resumed trials themselves.
        # The live actor's ID is recorded so restore can reap the orphan
        # (a dead driver's trial actors otherwise hold resources forever).
        d = dict(self.__dict__)
        d["_stale_actor_id"] = getattr(self.actor, "_actor_id", None)
        d["actor"] = None
        d["poll_ref"] = None
        return d

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iterations})"


@dataclasses.dataclass
class TrialResult:
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[str]
    trial_id: str = ""


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric, mode):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        ok = [r for r in self._results
              if r.error is None and metric in r.metrics]
        if not ok:
            raise ValueError("no successful trial reported "
                             f"metric {metric!r}")
        key = (lambda r: r.metrics[metric])
        return max(ok, key=key) if mode == "max" else min(ok, key=key)

    @property
    def errors(self) -> List[TrialResult]:
        return [r for r in self._results if r.error is not None]


class Tuner:
    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        storage_path: Optional[str] = None,
        name: str = "tune_experiment",
        sync_uri: Optional[str] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.resources = resources_per_trial or {"CPU": 1}
        self._exp_dir = (
            os.path.join(storage_path, name) if storage_path else None
        )
        self._restored_state: Optional[Dict] = None
        # cloud checkpoint sync (reference tune/syncer.py): every state
        # snapshot incrementally uploads the experiment dir to the bucket
        self._sync_uri = sync_uri
        self._syncer = None
        self._exp_name = name
        if sync_uri is not None and self._exp_dir is not None:
            from ray_tpu_torch._private.external_storage import (
                DirSyncer,
                storage_from_uri,
            )

            os.makedirs(self._exp_dir, exist_ok=True)
            self._syncer = DirSyncer(
                storage_from_uri(sync_uri), self._exp_dir, name
            )

    # -- experiment-level durability (parity: reference Tuner.restore,
    # tune/impl/tuner_internal.py:56 + experiment checkpointing) --

    STATE_FILE = "tuner_state.pkl"  # mutable sweep state, per-sweep write
    META_FILE = "tuner_meta.pkl"    # static definition, written once

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None
                ) -> "Tuner":
        """Rebuild a Tuner from a crashed/killed experiment directory;
        ``.fit()`` resumes unfinished trials from their last checkpoints
        with the searcher/scheduler state (PBT population, ASHA rungs,
        TPE observations) intact. Orphaned trial actors from the dead
        driver are reaped on resume.

        ``path`` may be a storage URI (``mock-bucket://...``, ``gs://``):
        the synced experiment is downloaded to a fresh local dir first —
        the lost-head-node recovery path (reference Tuner.restore from
        cloud upload_dir)."""
        import cloudpickle

        if "://" in path:
            import tempfile

            from ray_tpu_torch._private.external_storage import storage_from_uri

            storage = storage_from_uri(path.rsplit("/", 1)[0])
            exp_name = path.rstrip("/").rsplit("/", 1)[1]
            local = os.path.join(
                tempfile.mkdtemp(prefix="tune_restore_"), exp_name
            )
            storage.download_dir(exp_name, local)
            path = local
        path = path.rstrip(os.sep)
        with open(os.path.join(path, cls.META_FILE), "rb") as f:
            meta = cloudpickle.load(f)
        with open(os.path.join(path, cls.STATE_FILE), "rb") as f:
            st = cloudpickle.load(f)
        t = cls(
            trainable if trainable is not None else meta["trainable"],
            param_space=meta["param_space"],
            tune_config=meta["tune_config"],
            resources_per_trial=meta["resources"],
        )
        t._exp_dir = path  # snapshots continue in place
        t._restored_state = st
        return t

    def _atomic_dump(self, obj, fname: str):
        import cloudpickle

        tmp = os.path.join(self._exp_dir, fname + ".tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(obj, f)
        os.replace(tmp, os.path.join(self._exp_dir, fname))

    def _persist_meta(self):
        """The static experiment definition: written once per fit() (the
        trainable closure can be arbitrarily large — keeping it out of
        the per-sweep snapshot keeps the controller hot path cheap)."""
        if self._exp_dir is None:
            return
        os.makedirs(self._exp_dir, exist_ok=True)
        self._atomic_dump(
            {
                "trainable": self.trainable,
                "param_space": self.param_space,
                "tune_config": self.tune_config,
                "resources": self.resources,
            },
            self.META_FILE,
        )

    def _persist(self, trials, spawned, searcher, scheduler):
        if self._exp_dir is None:
            return
        self._atomic_dump(
            {
                "trials": trials,
                "spawned": spawned,
                "searcher": searcher,
                "scheduler": scheduler,
                "next_id": Trial._next,
            },
            self.STATE_FILE,
        )
        if self._syncer is not None:
            try:
                self._syncer.sync()
            except Exception:
                pass  # best-effort (reference syncer behavior)

    # -- controller --

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        if tc.search_alg is not None:
            searcher = tc.search_alg
            max_trials = tc.num_samples
        else:
            searcher = BasicVariantGenerator(
                self.param_space, tc.num_samples, seed=tc.seed
            )
            max_trials = None  # the generator itself exhausts
        trials: List[Trial] = []
        spawned = 0
        resume: List[Trial] = []
        if self._restored_state is not None:
            st, self._restored_state = self._restored_state, None
            trials = st["trials"]
            spawned = st["spawned"]
            searcher = st["searcher"]
            scheduler = st["scheduler"]
            Trial._next = max(Trial._next, st["next_id"])
            for t in trials:
                # reap the crashed driver's orphaned trial actor: it still
                # holds its resources and would starve the resumed sweep
                stale = t.__dict__.pop("_stale_actor_id", None)
                if stale is not None:
                    from ray_tpu_torch.actor import ActorHandle

                    try:
                        ray_tpu_torch.kill(ActorHandle(stale))
                    except Exception:
                        pass  # already dead / unknown
                if t.status in (PENDING, RUNNING):
                    # resume from the trial's last reported checkpoint
                    t.start_checkpoint = t.checkpoint or t.start_checkpoint
                    t.status = PENDING
                    resume.append(t)
        actor_cls = ray_tpu_torch.remote(resources=dict(self.resources))(
            _TrainWorker
        )
        use_gpu = float(self.resources.get("GPU", 0) or 0) > 0

        def start(trial: Trial):
            # Non-blocking: the actor may stay PENDING until cluster
            # resources free up (actor-FIFO guarantees start_training runs
            # before any poll); blocking here would stall the ack pump for
            # trials that are already running.
            trial.actor = actor_cls.remote()
            # the worker's device: the lease's card, else the CPU (actor
            # calls run in order, so this precedes start_training)
            trial.actor.init_runtime.remote(use_gpu)
            trial.poll_ref = None
            ctx = TrainContext(
                world_rank=0, world_size=1, experiment_name=trial.trial_id
            )
            trial.actor.start_training.remote(
                self.trainable, trial.config, ctx,
                trial.start_checkpoint, True,  # sync_reports: the
                # scheduler must be able to stop between iterations
            )
            trial.status = RUNNING

        def stop_actor(trial: Trial):
            if trial.actor is not None:
                try:
                    ray_tpu_torch.kill(trial.actor)
                except Exception:
                    pass
                trial.actor = None

        live: List[Trial] = []
        for t in resume:
            start(t)
            live.append(t)
        self._persist_meta()
        self._persist(trials, spawned, searcher, scheduler)
        dirty = False
        exhausted = False
        # A searcher returning None while not is_finished() means "nothing
        # to suggest right now" — back off and re-poll, bounded by an idle
        # deadline (reset on any suggestion or completion) so a wedged
        # searcher — or one written to the old "None = exhausted" contract
        # without is_finished() — can't hang fit() for long.
        SEARCHER_IDLE_TIMEOUT_S = 15.0
        idle_deadline = None
        # The trial id offered to an idle searcher is reused until it
        # accepts one, so back-off polling doesn't mint throwaway ids.
        pending_tid = None
        try:
            while True:
                while not exhausted and len(live) < tc.max_concurrent_trials:
                    if max_trials is not None and spawned >= max_trials:
                        exhausted = True
                        break
                    tid = pending_tid or Trial.next_id()
                    cfg = searcher.suggest(tid)
                    if cfg is None:
                        pending_tid = tid
                        if searcher.is_finished():
                            exhausted = True
                        break
                    pending_tid = None
                    idle_deadline = None
                    t = Trial(cfg, trial_id=tid)
                    trials.append(t)
                    spawned += 1
                    start(t)
                    live.append(t)
                    # persist IMMEDIATELY: a driver death between spawn and
                    # the end-of-round snapshot would otherwise leak an
                    # actor that restore() can never reap
                    self._persist(trials, spawned, searcher, scheduler)
                    dirty = False
                if not live:
                    if exhausted or (
                        max_trials is not None and spawned >= max_trials
                    ):
                        break
                    if searcher.is_finished():
                        break
                    # idle searcher with nothing live: wait for it, bounded
                    if idle_deadline is None:
                        idle_deadline = time.monotonic() + (
                            SEARCHER_IDLE_TIMEOUT_S
                        )
                    elif time.monotonic() > idle_deadline:
                        break
                    time.sleep(0.25)
                    continue
                for t in live:
                    if t.poll_ref is None:
                        t.poll_ref = t.actor.poll.remote(timeout=5.0)
                ready, _ = ray_tpu_torch.wait(
                    [t.poll_ref for t in live],
                    num_returns=len(live), timeout=8.0,
                )
                ready_set = set(ready)
                still = []
                for trial in live:
                    if trial.poll_ref not in ready_set:
                        # actor still pending placement (or a slow poll):
                        # keep the outstanding ref, check again next round
                        still.append(trial)
                        continue
                    ref, trial.poll_ref = trial.poll_ref, None
                    # per-trial fault isolation: a dead trial actor (OOM
                    # kill, node loss) becomes ERROR on that trial only —
                    # not a crashed experiment
                    try:
                        p = ray_tpu_torch.get(ref, timeout=120)
                    except Exception as e:
                        trial.status = ERROR
                        trial.error = f"trial actor died: {e!r}"
                        dirty = True
                        stop_actor(trial)
                        scheduler.on_trial_complete(trial, trial.last_result)
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_result, error=True
                        )
                        idle_deadline = None
                        continue
                    decision = CONTINUE
                    for ev in p["events"]:
                        trial.iterations += 1
                        m = dict(ev["metrics"])
                        m.setdefault("training_iteration", trial.iterations)
                        trial.last_result = m
                        if ev.get("checkpoint") is not None:
                            trial.checkpoint = ev["checkpoint"]
                        dirty = True
                        decision = scheduler.on_trial_result(trial, m)
                        if decision != CONTINUE:
                            break
                    if decision == CONTINUE and p["events"] and not p["done"]:
                        # rendezvous ack: unblock session.report for the
                        # next iteration
                        trial.actor.ack_report.remote()
                    if decision == STOP:
                        trial.status = TERMINATED
                        dirty = True
                        stop_actor(trial)
                        scheduler.on_trial_complete(trial, trial.last_result)
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_result
                        )
                        idle_deadline = None
                        continue
                    if decision == EXPLOIT:
                        donor = scheduler.exploit_target(
                            [t for t in trials if t is not trial
                             and t.checkpoint is not None]
                        )
                        if donor is not None:
                            stop_actor(trial)
                            trial.config = scheduler.explore(donor.config)
                            trial.start_checkpoint = donor.checkpoint
                            # the donor's checkpoint is now authoritative
                            # for this trial: a crash-resume must restart
                            # from the EXPLOITED weights, not the trial's
                            # own pre-exploit checkpoint
                            trial.checkpoint = donor.checkpoint
                            trial.iterations = donor.iterations
                            start(trial)
                            dirty = True
                        still.append(trial)
                        continue
                    if p["done"]:
                        if p["error"] is not None:
                            trial.status = ERROR
                            trial.error = (
                                f"{p['error']!r}\n{p.get('error_tb') or ''}"
                            )
                        else:
                            trial.status = TERMINATED
                        dirty = True
                        stop_actor(trial)
                        scheduler.on_trial_complete(trial, trial.last_result)
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_result,
                            error=p["error"] is not None,
                        )
                        idle_deadline = None
                        continue
                    still.append(trial)
                live = still
                if dirty:
                    # durable sweep: a killed driver resumes from here
                    # (reference tuner_internal.py:56 restore path)
                    self._persist(trials, spawned, searcher, scheduler)
                    dirty = False
        finally:
            for t in trials:
                stop_actor(t)
            self._persist(trials, spawned, searcher, scheduler)
        results = [
            TrialResult(
                config=t.config,
                metrics=t.last_result,
                checkpoint=(
                    Checkpoint.from_dict(t.checkpoint)
                    if t.checkpoint else None
                ),
                error=t.error,
                trial_id=t.trial_id,
            )
            for t in trials
        ]
        return ResultGrid(results, tc.metric, tc.mode)
