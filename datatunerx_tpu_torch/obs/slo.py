"""Declarative SLOs + multi-window burn-rate evaluation over the shared
registry.

The port's copy of ``datatunerx_tpu/obs/slo.py``. The registry gives every
plane histograms and counters; this module judges them, turning those raw
series into verdicts every consumer shares — the serving server's ``GET
/debug/slo`` runs the same evaluator as the reference's gateway, promotion
guard and load-replay epilogue, so "the fleet is healthy" means one thing
everywhere.

An SLO binds an SLI to an objective over evaluation windows:

  {"name": "serving-ttft-p95", "objective": 0.95,
   "windows_s": [300, 3600],
   "sli": {"kind": "latency", "metric": "dtx_serving_ttft_ms",
           "threshold_ms": 250}}

Two SLI kinds, both defined as a good/total event ratio so the burn-rate
math (Google SRE workbook ch. 5) is uniform:

  latency      — good = observations at or under the threshold, read from
                 the histogram's cumulative buckets (the threshold snaps UP
                 to the nearest bucket edge; the effective edge is reported).
                 ``objective 0.95 + threshold_ms 250`` is exactly
                 "p95 <= 250ms".
  error_ratio  — bad = counter series whose labels match the ``bad``
                 regexes (e.g. {"code": "^5"}), total = all series of the
                 metric (optionally ``match``-filtered first).

The evaluator samples cumulative (good, total) pairs into a bounded ring;
a window's compliance is the delta between now and the sample one window
ago, and its burn rate is ``(1 - compliance) / (1 - objective)`` — burn 1.0
spends the error budget exactly at the objective's rate, burn > 1.0 in
EVERY populated window is the multi-window page condition (fast window
confirms it's happening now, slow window confirms it's material).

``dtx_slo_*`` gauges (objective / compliance / burn_rate{window} / error
budget remaining / compliant) are restated into the same registry the SLIs
read from, so the SLO plane is itself scrapable.

Hot-path discipline: nothing here runs on a request path. Sampling and
evaluation walk registry snapshots at /debug/slo time, on the background
sampler tick, or at a promotion stage boundary.
"""

from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from datatunerx_tpu_torch.obs.metrics import Histogram, Metric, Registry

DEFAULT_WINDOWS_S = (300.0, 3600.0)


@dataclass(frozen=True)
class SLO:
    """One declarative objective. Build via ``SLO.from_dict`` (validates)
    or the ``default_slos``/``parse_slos`` helpers."""

    name: str
    objective: float
    sli: dict
    windows_s: Tuple[float, ...] = DEFAULT_WINDOWS_S
    description: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "SLO":
        name = str(d.get("name") or "")
        if not name or not re.match(r"^[a-zA-Z0-9_.-]+$", name):
            raise ValueError(f"SLO needs a [a-zA-Z0-9_.-]+ name, got {name!r}")
        try:
            objective = float(d["objective"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"SLO {name!r}: objective must be a number")
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO {name!r}: objective must be in (0, 1) — 1.0 leaves "
                "no error budget to burn")
        sli = dict(d.get("sli") or {})
        kind = sli.get("kind")
        metric = sli.get("metric")
        if not metric:
            raise ValueError(f"SLO {name!r}: sli.metric is required")
        if kind == "latency":
            # threshold in the metric's native unit; threshold_ms is the
            # spelled-out alias for the *_ms histograms
            thr = sli.get("threshold", sli.get("threshold_ms"))
            if thr is None:
                raise ValueError(
                    f"SLO {name!r}: latency sli needs threshold (or "
                    "threshold_ms)")
            sli["threshold"] = float(thr)
        elif kind == "error_ratio":
            bad = sli.get("bad") or {}
            if not isinstance(bad, dict) or not bad:
                raise ValueError(
                    f"SLO {name!r}: error_ratio sli needs a bad "
                    "label-regex map, e.g. {\"code\": \"^5\"}")
            for k, v in bad.items():
                re.compile(str(v))  # fail loud on a bad regex
        else:
            raise ValueError(
                f"SLO {name!r}: sli.kind must be latency or error_ratio, "
                f"got {kind!r}")
        windows = tuple(float(w) for w in
                        (d.get("windows_s") or DEFAULT_WINDOWS_S))
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(f"SLO {name!r}: windows_s must be positive")
        return cls(name=name, objective=objective, sli=sli,
                   windows_s=tuple(sorted(windows)),
                   description=str(d.get("description") or ""))


def parse_slos(doc) -> List[SLO]:
    """A spec document (list of SLO dicts, or {"slos": [...]}) → SLOs."""
    if isinstance(doc, dict):
        doc = doc.get("slos")
    if not isinstance(doc, list) or not doc:
        raise ValueError("SLO config must be a non-empty list of SLO "
                         "objects (or {\"slos\": [...]})")
    slos = [SLO.from_dict(d) for d in doc]
    names = [s.name for s in slos]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO names in config: {sorted(names)}")
    return slos


def load_slos(path_or_json: str) -> List[SLO]:
    """Parse SLOs from a file path or an inline JSON string (starts with
    '[' or '{') — the CLI's --slo flag accepts both."""
    text = path_or_json.strip()
    if not text.startswith(("[", "{")):
        with open(path_or_json, encoding="utf-8") as f:
            text = f.read()
    return parse_slos(json.loads(text))


def default_slos(plane: str) -> List[SLO]:
    """The out-of-the-box objectives each plane judges itself against when
    no --slo_config is given. Deliberately loose — they exist so /debug/slo
    answers something useful from first boot, not to page anyone."""
    if plane == "gateway":
        return [
            SLO.from_dict({
                "name": "gateway-availability", "objective": 0.99,
                "description": "non-5xx answers / all answers (429 shed is "
                               "a served answer: the gateway protected the "
                               "fleet, it did not fail)",
                "sli": {"kind": "error_ratio",
                        "metric": "dtx_gateway_requests_total",
                        "bad": {"code": "^5"}}}),
            SLO.from_dict({
                "name": "gateway-fast-requests", "objective": 0.95,
                "description": "p95 end-to-end gateway latency under 2.5s",
                "sli": {"kind": "latency",
                        "metric": "dtx_gateway_request_latency_seconds",
                        "threshold": 2.5}}),
        ]
    if plane == "serving":
        return [
            SLO.from_dict({
                "name": "serving-availability", "objective": 0.99,
                "description": "non-5xx answers / all answers",
                "sli": {"kind": "error_ratio",
                        "metric": "dtx_serving_requests_total",
                        "bad": {"code": "^5"}}}),
            SLO.from_dict({
                "name": "serving-ttft-p95", "objective": 0.95,
                "description": "p95 time-to-first-token under 250ms",
                "sli": {"kind": "latency",
                        "metric": "dtx_serving_ttft_ms",
                        "threshold_ms": 250}}),
        ]
    if plane == "loadgen":
        return [
            SLO.from_dict({
                "name": "loadgen-availability", "objective": 0.99,
                "description": "replayed requests answered without a "
                               "server-side failure",
                "sli": {"kind": "error_ratio",
                        "metric": "dtx_loadgen_requests_total",
                        "bad": {"code": "^5"}}}),
            SLO.from_dict({
                "name": "loadgen-fast-ttft", "objective": 0.90,
                "description": "p90 first-token latency under 2.5s as the "
                               "client saw it",
                "sli": {"kind": "latency",
                        "metric": "dtx_loadgen_ttft_ms",
                        "threshold_ms": 2500}}),
        ]
    raise ValueError(f"no default SLOs for plane {plane!r}")


def evaluate_window(good: float, total: float, objective: float) -> dict:
    """The one window-verdict formula everyone shares: compliance,
    burn rate, and the compliant bit. No data = vacuously compliant
    (a dead service should page via an absence alert, not divide by
    zero here)."""
    if total <= 0:
        return {"good": 0, "total": 0, "compliance": None,
                "burn_rate": None, "compliant": True, "no_data": True}
    compliance = good / total
    burn = (1.0 - compliance) / (1.0 - objective)
    return {"good": int(good), "total": int(total),
            "compliance": round(compliance, 6),
            "burn_rate": round(burn, 4),
            "compliant": compliance >= objective, "no_data": False}


@dataclass
class _Sample:
    t: float
    cumulative: Dict[str, Tuple[float, float]] = field(default_factory=dict)


class SLOEvaluator:
    """Samples cumulative (good, total) pairs off a Registry and judges
    SLOs over windows. One instance per server/run; thread-safe.

    Three consumers, three entry points:

      report()          — /debug/slo: take a sample, evaluate every spec
                          window, restate the dtx_slo_* gauges.
      verdicts(...)     — judge each SLO from the most recent sample (or
                          the earliest sample at/after ``since_t``) to NOW:
                          the promotion guard's per-stage window (sample at
                          stage begin, judge at stage end) and the replay
                          epilogue's whole-run window.
      start()/stop()    — background sampler so the spec windows have
                          history without anyone polling /debug/slo.
    """

    def __init__(self, registry: Registry, slos: Sequence[SLO],
                 history_slack: float = 1.5):
        self.registry = registry
        self.slos = list(slos)
        if not self.slos:
            raise ValueError("SLOEvaluator needs at least one SLO")
        self._max_window = max(w for s in self.slos for w in s.windows_s)
        self._history_s = self._max_window * history_slack
        self._samples: "deque[_Sample]" = deque()
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_results: List[dict] = []
        self.sample()  # the time-zero baseline every window falls back to

    # --------------------------------------------------------- SLI reading
    def _cumulative(self, slo: SLO) -> Tuple[float, float]:
        m = self.registry.get(slo.sli["metric"])
        if m is None:
            return (0.0, 0.0)
        if slo.sli["kind"] == "latency":
            if not isinstance(m, Histogram):
                return (0.0, 0.0)
            counts = m.bucket_counts()
            total = counts[-1][1] if counts else 0
            thr = slo.sli["threshold"]
            good = 0
            for edge, cum in counts:
                if edge >= thr:
                    good = cum
                    break
            return (float(good), float(total))
        # error_ratio
        if not isinstance(m, Metric):
            return (0.0, 0.0)
        series = m.series()
        match = slo.sli.get("match") or {}
        bad_re = {k: re.compile(str(v))
                  for k, v in slo.sli["bad"].items()}
        match_re = {k: re.compile(str(v)) for k, v in match.items()}
        total = bad = 0.0
        for key, value in series.items():
            labels = dict(key)
            if any(not r.search(str(labels.get(k, "")))
                   for k, r in match_re.items()):
                continue
            total += value
            if all(r.search(str(labels.get(k, "")))
                   for k, r in bad_re.items()):
                bad += value
        return (total - bad, total)

    def effective_threshold(self, slo: SLO) -> Optional[float]:
        """The bucket edge a latency threshold actually snaps to (None for
        error-ratio SLIs or an unregistered metric)."""
        if slo.sli["kind"] != "latency":
            return None
        m = self.registry.get(slo.sli["metric"])
        if not isinstance(m, Histogram):
            return None
        for edge in m.buckets:
            if edge >= slo.sli["threshold"]:
                return edge
        return None

    # ------------------------------------------------------------ sampling
    def sample(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        cum = {s.name: self._cumulative(s) for s in self.slos}
        with self._lock:
            self._samples.append(_Sample(now, cum))
            # keep one sample older than the history horizon so the longest
            # window always has a baseline to subtract from
            while (len(self._samples) > 2
                   and now - self._samples[1].t > self._history_s):
                self._samples.popleft()

    def _baseline(self, floor_t: float) -> _Sample:
        """The earliest sample at/after ``floor_t`` (fallback: earliest) —
        under-covering a window beats inventing pre-history."""
        with self._lock:
            for s in self._samples:
                if s.t >= floor_t:
                    return s
            return self._samples[0]

    def _latest(self) -> _Sample:
        with self._lock:
            return self._samples[-1]

    # ---------------------------------------------------------- evaluation
    @staticmethod
    def _delta(cur: Tuple[float, float],
               past: Tuple[float, float]) -> Tuple[float, float]:
        # clamp: a swapped engine restarts its counters; a negative delta
        # would report phantom good events
        return (max(0.0, cur[0] - past[0]), max(0.0, cur[1] - past[1]))

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Every SLO over its spec windows, from live cumulative values
        against the sample ring. ``compliant`` follows the multi-window
        burn-rate rule: breaching only when EVERY populated window burns
        faster than budget."""
        now = time.monotonic() if now is None else now
        out = []
        for slo in self.slos:
            cur = self._cumulative(slo)
            windows = []
            for w in slo.windows_s:
                base = self._baseline(now - w)
                good, total = self._delta(cur, base.cumulative.get(
                    slo.name, (0.0, 0.0)))
                entry = evaluate_window(good, total, slo.objective)
                # covered_s is HONEST, not capped at the window: with no
                # sampler the baseline is the time-zero sample, and a
                # "300s window" actually covering two hours must say so
                entry.update(window_s=w, covered_s=round(now - base.t, 3))
                windows.append(entry)
            populated = [w for w in windows if not w["no_data"]]
            breaching = bool(populated) and all(
                w["burn_rate"] > 1.0 for w in populated)
            # budget remaining over the longest populated window
            budget = None
            if populated:
                budget = round(max(0.0, 1.0 - populated[-1]["burn_rate"]), 4)
            doc = {
                "name": slo.name,
                "objective": slo.objective,
                "description": slo.description,
                "sli": dict(slo.sli),
                "windows": windows,
                "compliant": not breaching,
                "budget_remaining": budget,
                "no_data": not populated,
            }
            thr = self.effective_threshold(slo)
            if thr is not None:
                doc["threshold_effective"] = thr
            out.append(doc)
        with self._lock:
            self._last_results = out
        return out

    def verdicts(self, since_t: Optional[float] = None) -> List[dict]:
        """One window per SLO: from the most recent sample (or the earliest
        sample at/after ``since_t``) to NOW. ``compliant`` here is the
        strict single-window rule — compliance >= objective — because the
        caller chose the window to BE the judgment period (a promotion
        stage, a whole replay run)."""
        now = time.monotonic()
        base = (self._latest() if since_t is None
                else self._baseline(since_t))
        out = []
        for slo in self.slos:
            cur = self._cumulative(slo)
            good, total = self._delta(
                cur, base.cumulative.get(slo.name, (0.0, 0.0)))
            entry = evaluate_window(good, total, slo.objective)
            entry.update(name=slo.name, objective=slo.objective,
                         window_s=round(now - base.t, 3))
            thr = self.effective_threshold(slo)
            if thr is not None:
                entry["threshold_effective"] = thr
            out.append(entry)
        return out

    # ------------------------------------------------------------- gauges
    def restate_gauges(self, results: Optional[List[dict]] = None) -> None:
        """State the dtx_slo_* series from the given (default: last)
        evaluation. Each gauge's series set is swapped ATOMICALLY
        (Metric.replace) so a scrape racing a restate — or two restaters
        racing each other — sees a complete old or new set, never a
        half-cleared one."""
        if results is None:
            with self._lock:
                results = list(self._last_results)
        if not results:
            return
        g = self.registry.gauge
        objective = g("dtx_slo_objective",
                      "Declared objective per SLO (good events / total).")
        compliance = g("dtx_slo_compliance",
                       "Measured compliance over each SLO's longest "
                       "populated window (1.0 when no data).")
        burn = g("dtx_slo_burn_rate",
                 "Error-budget burn rate per evaluation window (1.0 = "
                 "burning exactly at the objective's rate).")
        budget = g("dtx_slo_error_budget_remaining",
                   "Fraction of the error budget left over the longest "
                   "populated window (0 = budget spent).")
        compliant = g("dtx_slo_compliant",
                      "1 unless every populated window burns budget "
                      "faster than 1.0 (the multi-window page condition).")
        objective_v, compliance_v, burn_v, budget_v, compliant_v = \
            [], [], [], [], []
        for doc in results:
            labels = {"slo": doc["name"]}
            objective_v.append((labels, doc["objective"]))
            compliant_v.append((labels, 0 if not doc["compliant"] else 1))
            populated = [w for w in doc["windows"] if not w["no_data"]]
            compliance_v.append(
                (labels, populated[-1]["compliance"] if populated else 1.0))
            if doc["budget_remaining"] is not None:
                budget_v.append((labels, doc["budget_remaining"]))
            for w in doc["windows"]:
                if not w["no_data"]:
                    burn_v.append(({"slo": doc["name"],
                                    "window": f"{int(w['window_s'])}s"},
                                   w["burn_rate"]))
        objective.replace(objective_v)
        compliance.replace(compliance_v)
        burn.replace(burn_v)
        budget.replace(budget_v)
        compliant.replace(compliant_v)

    # -------------------------------------------------------------- report
    def report(self, plane: str = "") -> dict:
        """The /debug/slo body: sample, evaluate, restate, summarize."""
        self.sample()
        results = self.evaluate()
        self.restate_gauges(results)
        return {
            "plane": plane,
            "compliant": all(d["compliant"] for d in results),
            "slos": results,
        }

    # ---------------------------------------------------------- background
    def start(self, interval_s: float = 15.0) -> None:
        """Background sampler: keeps the spec windows populated without a
        /debug/slo poller. Samples ONLY — gauges are restated by the
        scrape/report paths, which serialize under their own locks.
        Idempotent."""
        if self._thread is not None or interval_s <= 0:
            return
        def _loop():
            while not self._shutdown.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 — sampling must not die
                    pass
        self._thread = threading.Thread(
            target=_loop, name="dtx-slo-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def violations(verdict_list: List[dict]) -> List[str]:
    """Human-readable violation lines from ``verdicts()`` output — the
    replay epilogue's exit message and the promotion guard's rollback
    reason both come from here, so a violated objective is always NAMED."""
    out = []
    for v in verdict_list:
        if v.get("no_data") or v.get("compliant", True):
            continue
        out.append(
            f"SLO {v['name']} violated: compliance "
            f"{v['compliance']:.4f} < objective {v['objective']:g} "
            f"over {v['total']} events in {v['window_s']:.1f}s")
    return out
