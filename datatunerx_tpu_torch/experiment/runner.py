"""ExperimentRunner: the closed loop, end to end (the port's copy of
``datatunerx_tpu/experiment/runner.py``).

    N jobs on a shared slice pool  →  continuous scoring / leaderboard
        →  winner  →  canary replica behind the gateway  →  weighted
        traffic shift  →  full rollout (or auto-rollback)

One runner owns one experiment: a ``SliceScheduler`` (elastic training), a
``ContinuousScoringWatcher`` (live leaderboard + early stop), and — when a
gateway is attached — the promotion phase. ``tick()`` advances whatever
phase the experiment is in; ``run()`` loops it. Everything the loop does
lands in ``dtx_experiment_*`` metrics and in spans under one trace id
(``dtx-exp-<name>``), merged into the gateway's trace store when a gateway
is present, so ``GET /debug/trace/dtx-exp-<name>`` shows the experiment's
phases next to the promotion's stage spans.

``main()`` is the ``dtx-torch experiment`` CLI: run a spec file's
experiment locally against the Fake backends (``--backend fake``, a
scripted self-driving demo of the whole loop: simulated training, scores,
canary shift) or the LocalProcessBackend (``--backend local``, the port's
trainer as subprocesses on ``--device``, ``cuda`` unless the caller asks
for the CPU; scoring then needs per-job serving endpoints in the spec).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics
from datatunerx_tpu_torch.experiment.pool import PoolSlice, SharedSlicePool
from datatunerx_tpu_torch.experiment.promotion import TERMINAL
from datatunerx_tpu_torch.experiment.scheduler import SliceScheduler
from datatunerx_tpu_torch.experiment.watcher import (
    ContinuousScoringWatcher,
    Leaderboard,
)
from datatunerx_tpu_torch.obs.trace import Tracer, TraceStore

PHASE_TRAIN = "train"
PHASE_PROMOTE = "promote"
PHASE_DONE = "done"


class ExperimentRunner:
    def __init__(self, name: str, scheduler: SliceScheduler,
                 watcher: ContinuousScoringWatcher,
                 gateway=None,
                 serving_backend=None,
                 canary_replica_factory: Optional[Callable] = None,
                 canary_spec_fn: Optional[Callable] = None,
                 promotion_config: Optional[dict] = None,
                 traffic_fn: Optional[Callable] = None,
                 metrics: Optional[ExperimentMetrics] = None):
        self.name = name
        self.scheduler = scheduler
        self.watcher = watcher
        self.gateway = gateway
        self.serving_backend = serving_backend
        self.canary_replica_factory = canary_replica_factory
        self.canary_spec_fn = canary_spec_fn
        self.promotion_config = dict(promotion_config or {})
        self.traffic_fn = traffic_fn
        self.metrics = metrics if metrics is not None \
            else ExperimentMetrics(experiment=name)
        self.trace_id = f"dtx-exp-{name}"
        # spans land where the gateway's do, so one /debug/trace/<id> shows
        # the whole loop; without a gateway the runner keeps a private ring
        self.tracer = gateway.tracer if gateway is not None \
            else Tracer(store=TraceStore())
        self.phase = PHASE_TRAIN
        self.promotion = None
        self.canary_name = f"{name}-canary"
        self._canary_deployed = False
        self.winner = None
        self.events: List[dict] = []
        # bounded score-drain: once training is done, keep ticking the
        # watcher while final-checkpoint scores are still pending (warming
        # endpoints) before picking a winner — up to this many ticks
        self.score_drain_ticks = 100
        self._drained = 0
        self._promotion_blocked_logged = False
        self._phase_span = self.tracer.start(
            "experiment.train", trace_id=self.trace_id, experiment=name)

    # ---------------------------------------------------------------- tick
    def tick(self) -> List[dict]:
        if self.phase == PHASE_TRAIN:
            events = self.scheduler.tick()
            events += self.watcher.tick()
            if self.scheduler.done():
                # final checkpoints whose scores are still warming get a
                # bounded number of retry ticks before the verdict — a
                # winner picked off stale mid-training scores is wrong
                if (self.watcher.pending_scores > 0
                        and self._drained < self.score_drain_ticks):
                    self._drained += 1
                else:
                    events += self._finish_training()
        elif self.phase == PHASE_PROMOTE:
            events = self._tick_promotion()
        else:
            events = []
        self.events.extend(events)
        return events

    def _finish_training(self) -> List[dict]:
        # final checkpoints of just-succeeded jobs still need scoring
        events = self.watcher.tick()
        standings = self.watcher.board.standings()
        succeeded = {j.name for j in self.scheduler.succeeded()}
        ranked = [e for e in standings
                  if e.job in succeeded and e.score is not None]
        self.winner = ranked[0] if ranked else None
        self._phase_span.set(
            jobs={j.name: j.state for j in self.scheduler.jobs()},
            winner=self.winner.job if self.winner else None,
            best_score=self.winner.score if self.winner else None)
        self.tracer.finish(self._phase_span)
        if self.winner is None or self.gateway is None:
            self.phase = PHASE_DONE
            return events + [{"event": "experiment_done",
                              "winner": None if self.winner is None
                              else self.winner.job,
                              "promoted": False}]
        self.phase = PHASE_PROMOTE
        self._phase_span = self.tracer.start(
            "experiment.promote", trace_id=self.trace_id,
            winner=self.winner.job, score=self.winner.score)
        return events + [{"event": "winner", "job": self.winner.job,
                          "score": self.winner.score}]

    # ----------------------------------------------------------- promotion
    def _tick_promotion(self) -> List[dict]:
        events: List[dict] = []
        if self.promotion is None:
            started = self._start_promotion()
            if started is not None:
                events.append(started)
            return events
        if self.traffic_fn is not None:
            self.traffic_fn(self.gateway)
        state = self.promotion.tick()
        if state in TERMINAL:
            self._phase_span.set(outcome=state,
                                 reason=self.promotion.reason)
            self.tracer.finish(
                self._phase_span,
                status="ok" if state == "completed" else "error")
            self.phase = PHASE_DONE
            events.append({"event": "experiment_done",
                           "winner": self.winner.job,
                           "promoted": state == "completed",
                           "outcome": state})
        return events

    def _start_promotion(self) -> Optional[dict]:
        """Deploy the winner's serving app (serving backend), wait for it
        to report HEALTHY, put its replica in the gateway pool, start the
        weighted shift."""
        job = self.scheduler.job(self.winner.job)
        if self.serving_backend is not None and not self._canary_deployed:
            spec = (self.canary_spec_fn(job) if self.canary_spec_fn
                    else self._default_canary_spec(job))
            self.serving_backend.deploy(self.canary_name, spec)
            self._canary_deployed = True
        if self.serving_backend is not None:
            if self.serving_backend.status(self.canary_name) != "HEALTHY":
                return None  # keep waiting; backend failure = stay here
        if self.gateway.pool.get(self.canary_name) is None:
            replica = None
            if self.canary_replica_factory is not None:
                replica = self.canary_replica_factory(job)
            elif self.serving_backend is not None:
                endpoint = self.serving_backend.endpoint(self.canary_name)
                if endpoint:
                    from datatunerx_tpu_torch.gateway.replica_pool import (
                        HTTPReplica,
                    )

                    replica = HTTPReplica(self.canary_name, endpoint)
            if replica is None:
                return None
            replica.name = self.canary_name
            self.gateway.pool.add(replica)
        try:
            self.promotion = self.gateway.start_promotion(
                self.canary_name, config=self.promotion_config,
                metrics=self.metrics, background=False)
        except ValueError as e:
            if "already active" not in str(e):
                # config error (bad schedule, empty fleet): terminal — an
                # unpromotable experiment must not crash or spin forever
                self._phase_span.set(error=str(e))
                self.tracer.finish(self._phase_span, status="error")
                self.phase = PHASE_DONE
                return {"event": "experiment_done",
                        "winner": self.winner.job, "promoted": False,
                        "error": str(e)}
            # an operator-initiated /admin/promote is mid-flight (single
            # flight): wait for it — the slot frees when it goes terminal.
            # Logged once, then silent retries each tick.
            if not self._promotion_blocked_logged:
                self._promotion_blocked_logged = True
                return {"event": "promotion_waiting", "reason": str(e)}
            return None
        self._promotion_blocked_logged = False
        # fold the promotion's spans into the experiment's trace
        self.promotion.trace_id = self.trace_id
        self.promotion._root.trace_id = self.trace_id
        return {"event": "promotion_started", "canary": self.canary_name,
                "schedule": list(self.promotion.config.schedule)}

    @staticmethod
    def _default_canary_spec(job) -> dict:
        spec = dict(job.spec.get("serve") or {})
        spec.setdefault("checkpoint_path", job.spec.get("checkpoint_dir"))
        return spec

    # ------------------------------------------------------------ blocking
    def run(self, max_ticks: int = 10_000, tick_s: float = 0.05) -> str:
        for _ in range(max_ticks):
            self.tick()
            if self.phase == PHASE_DONE:
                break
            if tick_s > 0:
                time.sleep(tick_s)
        return self.phase

    # -------------------------------------------------------------- reports
    def status(self) -> dict:
        return {
            "name": self.name,
            "phase": self.phase,
            "jobs": [j.to_dict() for j in self.scheduler.jobs()],
            "leaderboard": self.watcher.board.to_dict(),
            "winner": self.winner.job if self.winner else None,
            "promotion": (self.promotion.status()
                          if self.promotion is not None else None),
            "trace_id": self.trace_id,
        }


# --------------------------------------------------------------------- fakes

class _FakeLoopDriver:
    """Self-driving demo for ``dtx experiment --backend fake``: simulated
    training on the FakeTrainingBackend (jobs 'train' for a few ticks,
    dropping periodic eval checkpoints whose scores follow a per-job curve),
    a FakeServingBackend canary, and synthetic gateway traffic during the
    shift — the whole closed loop in-process, no models, no cards."""

    def __init__(self, backend, serving_backend, jobs: List[dict],
                 ticks_per_step: int = 2, steps_to_finish: int = 3):
        self.backend = backend
        self.serving = serving_backend
        self.jobs = {j["name"]: j for j in jobs}
        self.ticks_per_step = max(1, ticks_per_step)
        self.steps_to_finish = steps_to_finish
        self._ticks: dict = {}

    def advance(self):
        for name, state in list(self.backend.states.items()):
            if state not in ("Pending", "Running"):
                continue
            self.backend.states[name] = "Running"
            t = self._ticks[name] = self._ticks.get(name, 0) + 1
            if t >= self.ticks_per_step * self.steps_to_finish:
                self.backend.states[name] = "Succeeded"
        for name, state in list(self.serving.states.items()):
            if state == "PENDING":
                self.serving.states[name] = "HEALTHY"

    def checkpoints(self, job) -> List[int]:
        t = self._ticks.get(job.name, 0)
        done = self.backend.status(job.name) == "Succeeded"
        steps = t // self.ticks_per_step + (1 if done else 0)
        return list(range(1, min(steps, self.steps_to_finish) + 1))

    def score(self, job, step: int) -> float:
        base = float(self.jobs[job.name].get("fake_base_score",
                                             50 + 7 * (hash(job.name) % 5)))
        slope = float(self.jobs[job.name].get("fake_score_slope", 3.0))
        return round(base + slope * step, 2)


def _fake_traffic(gateway):
    import uuid as _uuid

    for _ in range(4):
        try:
            gateway.chat({"messages": [
                {"role": "user",
                 "content": f"probe {_uuid.uuid4().hex[:8]}"}]})
        except Exception:  # noqa: BLE001 — synthetic traffic is best-effort
            pass


def _build_fake_experiment(spec: dict) -> ExperimentRunner:
    from datatunerx_tpu_torch.gateway.replica_pool import (
        InProcessReplica,
        ReplicaPool,
    )
    from datatunerx_tpu_torch.gateway.server import Gateway
    from datatunerx_tpu_torch.operator.backends import (
        FakeServingBackend,
        FakeTrainingBackend,
    )

    class _EchoEngine:
        def __init__(self, tag):
            self.tag = tag
            self.slots = 4
            self._slot_req = [None] * 4

        def chat(self, messages, **kw):
            return f"[{self.tag}] ok"

    name = spec.get("name", "experiment")
    jobs = spec.get("jobs") or []
    slices = [PoolSlice(**s) for s in (spec.get("pool", {}).get("slices")
                                       or [{"name": "s0"}, {"name": "s1"}])]
    backend = FakeTrainingBackend()
    serving = FakeServingBackend()
    driver = _FakeLoopDriver(backend, serving, jobs)
    metrics = ExperimentMetrics(experiment=name)
    scheduler = SliceScheduler(SharedSlicePool(slices), backend,
                               metrics=metrics,
                               checkpoint_probe=lambda job: max(
                                   driver.checkpoints(job) or [0]) or None)
    scoring = spec.get("scoring") or {}
    pool = ReplicaPool([InProcessReplica("fleet-0", _EchoEngine("fleet-0")),
                        InProcessReplica("fleet-1", _EchoEngine("fleet-1"))])
    gateway = Gateway(pool, model_name=name)
    watcher = ContinuousScoringWatcher(
        scheduler, driver.checkpoints, driver.score, board=Leaderboard(),
        metrics=metrics,
        early_stop_margin=scoring.get("earlyStopMargin"),
        min_evals=int(scoring.get("minEvals", 2)))
    runner = ExperimentRunner(
        name, scheduler, watcher, gateway=gateway, serving_backend=serving,
        canary_replica_factory=lambda job: InProcessReplica(
            f"{name}-canary", _EchoEngine(f"canary:{job.name}")),
        promotion_config=spec.get("promotion")
        or {"schedule": [0.25, 1.0], "min_requests": 8, "step_s": 2.0},
        traffic_fn=_fake_traffic, metrics=metrics)
    runner._fake_driver = driver
    for j in jobs:
        scheduler.add_job(j["name"], j.get("spec") or {})
    return runner


def _build_local_experiment(spec: dict, workdir: str,
                            device: str = "cuda") -> ExperimentRunner:
    from datatunerx_tpu_torch.operator.backends import LocalProcessBackend
    from datatunerx_tpu_torch.scoring.builtin import score_endpoint
    from datatunerx_tpu_torch.training.checkpoint import checkpoint_steps

    name = spec.get("name", "experiment")
    slices = [PoolSlice(**s) for s in spec.get("pool", {}).get("slices", [])]
    if not slices:
        raise SystemExit("error: --backend local needs spec.pool.slices")
    backend = LocalProcessBackend(workdir, device=device)
    metrics = ExperimentMetrics(experiment=name)
    scheduler = SliceScheduler(SharedSlicePool(slices), backend,
                               metrics=metrics)
    scoring = spec.get("scoring") or {}

    def score_fn(job, step):
        endpoint = job.spec.get("score_endpoint")
        if not endpoint:
            return None
        try:
            return float(score_endpoint(
                endpoint, probes=scoring.get("probes"))["score"])
        except Exception:  # noqa: BLE001 — endpoint warming: retry next tick
            return None

    watcher = ContinuousScoringWatcher(
        scheduler, checkpoint_steps, score_fn,
        metrics=metrics,
        early_stop_margin=scoring.get("earlyStopMargin"),
        min_evals=int(scoring.get("minEvals", 2)))
    runner = ExperimentRunner(name, scheduler, watcher, metrics=metrics,
                              promotion_config=spec.get("promotion"))
    for j in spec.get("jobs") or []:
        scheduler.add_job(j["name"], j.get("spec") or {})
    return runner


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dtx-torch experiment",
        description="Run a closed-loop experiment: N jobs on a shared "
                    "slice pool, continuous scoring, canary promotion.")
    p.add_argument("-f", "--filename", required=True,
                   help="experiment spec (JSON): name, pool.slices, jobs, "
                        "scoring, promotion")
    p.add_argument("--backend", choices=["fake", "local"], default="fake")
    p.add_argument("--workdir", default="experiment-jobs",
                   help="job working directory (local backend)")
    p.add_argument("--max_ticks", type=int, default=2000)
    p.add_argument("--tick_s", type=float, default=0.05)
    p.add_argument("--status_json", default="",
                   help="write the final experiment status to this file")
    p.add_argument("--device", default="cuda",
                   help="where the local backend's trainers run: cuda "
                        "(default; they fail without a card) or cpu")
    args = p.parse_args(argv)

    with open(args.filename) as f:
        spec = json.load(f)
    if args.backend == "fake":
        runner = _build_fake_experiment(spec)
    else:
        runner = _build_local_experiment(spec, args.workdir, args.device)

    seen = 0
    for _ in range(args.max_ticks):
        if args.backend == "fake":
            runner._fake_driver.advance()
        runner.tick()
        for ev in runner.events[seen:]:
            print(f"[experiment] {json.dumps(ev)}", flush=True)
        seen = len(runner.events)
        if runner.phase == PHASE_DONE:
            break
        if args.tick_s > 0:
            time.sleep(args.tick_s)

    status = runner.status()
    print(f"[experiment] final {json.dumps(status, default=str)}",
          flush=True)
    if args.status_json:
        with open(args.status_json, "w") as f:
            json.dump(status, f, indent=1, default=str)
    ok = (runner.phase == PHASE_DONE
          and (runner.promotion is None
               or runner.promotion.state == "completed"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
