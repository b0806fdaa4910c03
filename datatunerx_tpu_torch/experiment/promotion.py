"""Canary promotion: checkpoint → canary replica → weighted traffic shift →
full rollout, with automatic rollback on regression (the port's copy of
``datatunerx_tpu/experiment/promotion.py``, driven by the port gateway's
``/admin/promote``).

The winner of an experiment never used to reach the gateway; this controller
closes that gap. Given a gateway whose pool already contains the canary
replica (spawned from the winning checkpoint — `ExperimentRunner` deploys it
via the serving backend, tests add an in-process replica), the promotion
walks a weight schedule:

  stage i: canary carries ``w`` of the traffic — its pool weight is set to
  ``w`` and every fleet replica's to ``(1-w)/n_fleet``, so the router's
  smooth-WRR share for the canary is exactly ``w``. The canary's circuit
  breaker opening (consecutive failures — already multi-request evidence)
  rolls back IMMEDIATELY; otherwise the stage holds until the canary has
  served ``min_requests`` attempts (or ``step_s`` elapses), then the
  guard runs:

    - canary error rate over the stage window > ``max_error_rate``, or
    - canary latency p95 over the STAGE'S OWN samples >
      ``max_latency_ratio`` × the fleet's p95 (from the per-replica
      outcome windows the gateway feeds from the same measurements as
      its request histograms)

  → ROLLBACK: canary weight 0, fleet restored to 1.0, promotion over.
  Otherwise the next stage begins; after the last stage (weight 1.0 — the
  fleet's weights are 0, all traffic on the canary) the promotion
  COMPLETES and the operator may drain the old replicas at leisure.

Tick-driven like the scheduler — ``tick()`` advances at most one decision;
``run()`` loops it with a sleep for the CLI/HTTP path. Every phase emits a
span into the gateway's trace store, so ``GET /debug/trace/<trace_id>``
shows the full promotion timeline, and dtx_experiment_* gauges/counters
track weight, phase and outcome.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics

CANARY = "canary"
SHIFTING = "shifting"
COMPLETED = "completed"
ROLLED_BACK = "rolled_back"
TERMINAL = (COMPLETED, ROLLED_BACK)


@dataclass
class PromotionConfig:
    schedule: tuple = (0.05, 0.25, 0.5, 1.0)
    step_s: float = 30.0          # max dwell per stage without verdict
    min_requests: int = 20        # canary attempts before judging a stage
    max_error_rate: float = 0.05
    max_latency_ratio: float = 2.0  # canary p95 vs fleet p95
    min_fleet_requests: int = 5     # below this the latency guard abstains
    # below this fleet p95 the latency guard also abstains: a RATIO of
    # sub-millisecond p95s is scheduling noise, not a regression signal
    # (in-process test fleets measure tens of µs — 2x jitter is routine)
    min_fleet_p95_ms: float = 1.0
    # SLO-verdict mode (obs/slo.py): spec dicts evaluated over the
    # GATEWAY's registry with each stage as the window — the same evaluator
    # /debug/slo serves, so canary judgment and fleet SLOs are one code
    # path. Additive to the error-rate/latency guards above.
    slos: tuple = ()
    # evidence floor for the SLO guard, mirroring min_requests: a stage
    # window whose SLI saw fewer total events than this abstains — one
    # transient fleet 5xx in a thin window must not kill a promotion
    slo_min_events: int = 10

    @classmethod
    def from_dict(cls, d: dict) -> "PromotionConfig":
        kw = {}
        if d.get("schedule"):
            sched = tuple(float(w) for w in d["schedule"])
            if not sched or any(not 0.0 < w <= 1.0 for w in sched) \
                    or list(sched) != sorted(sched) or sched[-1] != 1.0:
                raise ValueError(
                    "schedule must be ascending weights in (0, 1] ending "
                    "at 1.0")
            kw["schedule"] = sched
        for k, attr in (("step_s", "step_s"),
                        ("min_requests", "min_requests"),
                        ("max_error_rate", "max_error_rate"),
                        ("max_latency_ratio", "max_latency_ratio"),
                        ("min_fleet_p95_ms", "min_fleet_p95_ms"),
                        ("slo_min_events", "slo_min_events")):
            if d.get(k) is not None:
                kw[attr] = type(getattr(cls, attr, 0.0))(d[k]) \
                    if not isinstance(d[k], bool) else d[k]
        if d.get("slos"):
            from datatunerx_tpu_torch.obs.slo import parse_slos

            parse_slos(list(d["slos"]))  # fail loud on bad specs, HERE
            kw["slos"] = tuple(d["slos"])
        return cls(**kw)


@dataclass
class _StageWindow:
    started_at: float = 0.0
    canary_requests: int = 0
    canary_errors: int = 0


class PromotionController:
    """One promotion of one canary replica through a gateway's traffic."""

    def __init__(self, gateway, canary_name: str,
                 config: Optional[PromotionConfig] = None,
                 metrics: Optional[ExperimentMetrics] = None,
                 trace_id: str = ""):
        self.gateway = gateway
        self.canary_name = canary_name
        self.config = config or PromotionConfig()
        self.metrics = metrics
        self.trace_id = trace_id or f"dtx-promo-{uuid.uuid4().hex[:12]}"
        canary = gateway.pool.get(canary_name)
        if canary is None:
            raise ValueError(f"no replica {canary_name!r} in the pool")
        self.canary = canary
        if not self._fleet():
            raise ValueError("promotion needs at least one fleet replica "
                             "to shift traffic away from")
        self.state = CANARY
        self.stage = -1            # index into config.schedule
        self.reason = ""
        self._window = _StageWindow()
        # SLO-verdict mode: one evaluator over the gateway's registry for
        # the whole promotion; each stage begins with a sample() so the
        # guard judges exactly the stage's own traffic
        self.slo_eval = None
        if self.config.slos:
            from datatunerx_tpu_torch.obs.slo import SLOEvaluator, parse_slos

            self.slo_eval = SLOEvaluator(
                gateway.registry, parse_slos(list(self.config.slos)))
        self._lock = threading.Lock()
        self._root = gateway.tracer.start(
            "promotion", trace_id=self.trace_id,
            canary=canary_name, schedule=list(self.config.schedule))
        self._stage_span = None
        if self.metrics is not None:
            self.metrics.set_promotion_phase(CANARY)

    # ------------------------------------------------------------- weights
    def _fleet(self):
        """The CURRENT non-canary pool — resolved live, not snapshotted at
        construction: a replica added mid-shift (autoscale, /admin/scale)
        must be folded into the weight scheme at the next application, and
        rollback/completion must reset replicas that joined after the
        promotion started."""
        return [r for r in self.gateway.pool.replicas()
                if r.name != self.canary_name]

    def current_weight(self) -> float:
        if self.state == COMPLETED:
            return 1.0
        if 0 <= self.stage < len(self.config.schedule) \
                and self.state == SHIFTING:
            return self.config.schedule[self.stage]
        return 0.0

    def _apply_weights(self, w: float):
        self.canary.weight = w
        fleet = self._fleet()
        fleet_w = (1.0 - w) / len(fleet) if w < 1.0 and fleet else 0.0
        for r in fleet:
            r.weight = fleet_w
        if self.metrics is not None:
            self.metrics.set_canary_weight(w)

    # -------------------------------------------------------------- stages
    def _begin_stage(self, idx: int):
        w = self.config.schedule[idx]
        self.stage = idx
        self.state = SHIFTING
        self._apply_weights(w)
        if self.slo_eval is not None:
            self.slo_eval.sample()  # the stage IS the SLO window
        canary_stats = self.canary.outcome_stats()
        self._window = _StageWindow(
            started_at=time.monotonic(),
            canary_requests=canary_stats["requests"],
            canary_errors=canary_stats["errors"])
        self._stage_span = self.gateway.tracer.start(
            "promotion.stage", trace_id=self.trace_id, parent="promotion",
            stage=idx, weight=w)
        if self.metrics is not None:
            self.metrics.set_promotion_phase(SHIFTING)

    def _finish_stage(self, status: str, **attrs):
        if self._stage_span is not None:
            self._stage_span.set(**attrs)
            self.gateway.tracer.finish(self._stage_span, status=status)
            self._stage_span = None

    # --------------------------------------------------------------- guard
    def _stage_stats(self) -> dict:
        s = self.canary.outcome_stats()
        reqs = s["requests"] - self._window.canary_requests
        errs = s["errors"] - self._window.canary_errors
        # latency over THIS stage's samples only (the most recent `reqs`
        # in the rolling window) — warm-up requests served before the
        # stage must not roll back a now-healthy canary
        p95 = (self.canary.outcome_stats(last_n=reqs)["latency_p95_ms"]
               if reqs else 0.0)
        return {"requests": reqs, "errors": errs,
                "error_rate": errs / reqs if reqs else 0.0,
                "latency_p95_ms": p95}

    def _fleet_p95(self) -> tuple:
        stats = [r.outcome_stats() for r in self._fleet()]
        total = sum(s["requests"] for s in stats)
        windows = [s["latency_p95_ms"] for s in stats if s["requests"]]
        return (max(windows) if windows else 0.0, total)

    def _regressed(self, stats: dict) -> Optional[str]:
        # SLO verdicts first, BEFORE the canary-traffic gate: the SLOs
        # judge the gateway's whole registry over the stage window, so a
        # fleet-wide breach must roll back even a stage that routed zero
        # requests to the canary
        if self.slo_eval is not None:
            from datatunerx_tpu_torch.obs.slo import violations

            judgeable = [v for v in self.slo_eval.verdicts()
                         if v.get("total", 0) >= self.config.slo_min_events]
            broken = violations(judgeable)
            if broken:
                return broken[0]  # rollback reason NAMES the objective
        if stats["requests"] == 0:
            return None  # nothing else to judge
        if stats["error_rate"] > self.config.max_error_rate:
            return (f"canary error rate {stats['error_rate']:.2%} > "
                    f"{self.config.max_error_rate:.2%} over "
                    f"{stats['requests']} requests")
        fleet_p95, fleet_reqs = self._fleet_p95()
        if (fleet_reqs >= self.config.min_fleet_requests
                and fleet_p95 >= self.config.min_fleet_p95_ms
                and stats["latency_p95_ms"]
                > self.config.max_latency_ratio * fleet_p95):
            return (f"canary latency p95 {stats['latency_p95_ms']:.1f}ms > "
                    f"{self.config.max_latency_ratio:g}x fleet p95 "
                    f"{fleet_p95:.1f}ms")
        return None

    # ---------------------------------------------------------------- tick
    def tick(self) -> str:
        """Advance at most one decision; returns the current state."""
        with self._lock:
            return self._tick_locked()

    def abort(self, reason: str = "aborted") -> str:
        """Force-terminate a live promotion (rollback to fleet weights) —
        gateway shutdown mid-promotion calls this so the background run()
        loop goes terminal instead of ticking against a closed gateway."""
        with self._lock:
            if self.state not in TERMINAL:
                self._rollback(reason, self._stage_stats())
            return self.state

    def _tick_locked(self) -> str:
        if self.state in TERMINAL:
            return self.state
        if self.state == CANARY:
            self._begin_stage(0)
            return self.state
        stats = self._stage_stats()
        # the breaker is the one IMMEDIATE tripwire: it only opens on
        # consecutive failures (threshold 3 by default), which is already
        # multi-request evidence — everything else waits for the evidence
        # gate below, so one transient error can't kill a promotion
        if self.canary.breaker.state == "open":
            self._rollback("canary circuit breaker opened", stats)
            return self.state
        dwell = time.monotonic() - self._window.started_at
        if (stats["requests"] < self.config.min_requests
                and dwell < self.config.step_s):
            return self.state  # keep gathering evidence
        reason = self._regressed(stats)
        if reason is not None:
            self._rollback(reason, stats)
            return self.state
        self._finish_stage("ok", **stats)
        if self.stage + 1 < len(self.config.schedule):
            self._begin_stage(self.stage + 1)
        else:
            self._complete(stats)
        return self.state

    def _rollback(self, reason: str, stats: dict):
        self._finish_stage("error", error=reason, **stats)
        self._apply_weights(0.0)
        for r in self._fleet():
            r.weight = 1.0
        self.state = ROLLED_BACK
        self.reason = reason
        self._root.set(outcome=ROLLED_BACK, error=reason)
        self.gateway.tracer.finish(self._root, status="error")
        if self.metrics is not None:
            self.metrics.set_promotion_phase(ROLLED_BACK)
            self.metrics.promotion_finished(ROLLED_BACK)

    def _complete(self, stats: dict):
        self._apply_weights(1.0)
        self.state = COMPLETED
        self._root.set(outcome=COMPLETED, **stats)
        self.gateway.tracer.finish(self._root, status="ok")
        if self.metrics is not None:
            self.metrics.set_promotion_phase(COMPLETED)
            self.metrics.promotion_finished(COMPLETED)

    # ----------------------------------------------------------- blocking
    def run(self, poll_s: float = 0.25,
            timeout_s: Optional[float] = None) -> str:
        """Loop ``tick`` until terminal (the /admin/promote background
        thread and the CLI use this; tests drive ``tick`` directly)."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while self.tick() not in TERMINAL:
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    if self.state not in TERMINAL:
                        self._rollback("promotion timed out",
                                       self._stage_stats())
                break
            time.sleep(poll_s)
        return self.state

    # ------------------------------------------------------------- reports
    def status(self) -> dict:
        out = {
            "canary": self.canary_name,
            "state": self.state,
            "stage": self.stage,
            "weight": round(self.current_weight(), 4),
            "schedule": list(self.config.schedule),
            "reason": self.reason,
            "trace_id": self.trace_id,
        }
        if self.slo_eval is not None:
            out["slos"] = [
                {"name": v["name"], "compliant": v["compliant"],
                 "compliance": v["compliance"]}
                for v in self.slo_eval.verdicts()]
        return out
