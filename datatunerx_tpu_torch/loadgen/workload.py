"""Workload model + record/replay trace format.

``WorkloadModel.generate()`` produces a deterministic (seeded) list of
request events shaped like production chat traffic rather than a uniform
probe stream:

  heavy tails    — prompt/output lengths are Pareto-distributed (a few
                   huge prompts among many small ones: the head-of-line
                   shape chunked prefill exists for), capped so a trace
                   can't exceed the fleet's context budget.
  multi-turn     — requests belong to sessions; every turn of a session
                   repeats the session's system prompt and grows the
                   history, so prefix caches and session-affinity routing
                   see realistic reuse.
  adapter churn  — the ``model`` field cycles a Zipf-weighted adapter
                   population (hot tenants dominate, a long tail keeps the
                   pool contested), with every k-th request on base.
  arrivals       — exponential inter-arrival times at a target RPS.

The trace is JSONL: a header line
``{"kind": "dtx-load-trace", "version": 1, "meta": {...}}`` then one event
per line, each ``{"t": seconds-from-start, "session", "turn", "messages",
"max_tokens", "model"}``. Traces recorded once replay bit-identically —
the chaos schedule, not the traffic, is the experiment variable.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, TextIO, Tuple

TRACE_KIND = "dtx-load-trace"
TRACE_VERSION = 1

_WORDS = ("the quick brown fox jumps over the lazy dog while tokens "
          "stream past attention heads and caches fill with state").split()


def _text(rng: random.Random, n_chars: int) -> str:
    """Deterministic filler text of roughly n_chars (word-granular)."""
    out: List[str] = []
    size = 0
    while size < n_chars:
        w = _WORDS[rng.randrange(len(_WORDS))]
        out.append(w)
        size += len(w) + 1
    return " ".join(out)


def _pareto_int(rng: random.Random, base: float, alpha: float,
                cap: int) -> int:
    """Heavy-tail length draw: base × Pareto(alpha), capped. alpha ~1.5
    gives the long-tail mass production prompt mixes show."""
    return max(1, min(cap, int(base * rng.paretovariate(alpha))))


class WorkloadModel:
    """Seeded generator of production-shaped request events."""

    def __init__(self, requests: int = 50, sessions: int = 8,
                 rps: float = 20.0, seed: int = 0,
                 adapters: Optional[List[str]] = None,
                 base_every: int = 4,
                 prompt_chars: int = 80, prompt_cap_chars: int = 2000,
                 output_tokens: int = 16, output_cap_tokens: int = 96,
                 tail_alpha: float = 1.5, temperature: float = 0.8,
                 tenants: Optional[Dict[str, dict]] = None):
        if requests < 1 or sessions < 1 or rps <= 0:
            raise ValueError("requests/sessions must be >= 1, rps > 0")
        self.requests = requests
        self.sessions = sessions
        self.rps = rps
        self.seed = seed
        self.adapters = list(adapters or [])
        self.base_every = max(0, base_every)
        # multi-tenant mix: tenant -> {"adapters": [...], "weight": w}.
        # Each event draws a tenant by arrival weight, then an adapter
        # Zipf-weighted WITHIN that tenant's set, and carries a "tenant"
        # tag the replay clients forward as X-DTX-Tenant. Empty = the
        # untagged single-tenant mix, bit-identical to older traces.
        self.tenants = {str(n): dict(e) for n, e in (tenants or {}).items()}
        self.prompt_chars = prompt_chars
        self.prompt_cap_chars = prompt_cap_chars
        self.output_tokens = output_tokens
        self.output_cap_tokens = output_cap_tokens
        self.tail_alpha = tail_alpha
        # sampled decode by default: greedy traffic on tiny models EOSes
        # instantly, which starves the TTFT/TPOT signal a replay exists
        # to measure
        self.temperature = temperature

    def _pick_adapter(self, rng: random.Random, i: int,
                      adapters: Optional[List[str]] = None) -> str:
        pool = self.adapters if adapters is None else adapters
        if not pool:
            return ""
        if self.base_every and i % self.base_every == 0:
            return ""  # every k-th request exercises the base model
        # Zipf-ish: weight 1/rank — hot tenants dominate, the tail churns
        weights = [1.0 / (r + 1) for r in range(len(pool))]
        return rng.choices(pool, weights=weights, k=1)[0]

    def _pick_tenant(self, rng: random.Random) -> Tuple[str, Optional[List[str]]]:
        if not self.tenants:
            return "", None
        names = sorted(self.tenants)
        weights = [max(0.0, float(self.tenants[n].get("weight", 1.0)))
                   for n in names]
        name = rng.choices(names, weights=weights, k=1)[0]
        return name, list(self.tenants[name].get("adapters") or [])

    def generate(self) -> List[dict]:
        rng = random.Random(self.seed)
        # per-session state: system prompt (the reused prefix) + history
        systems = [
            f"You are assistant s{j}. " + _text(rng, self.prompt_chars)
            for j in range(self.sessions)
        ]
        histories: List[List[dict]] = [[] for _ in range(self.sessions)]
        turns = [0] * self.sessions
        events: List[dict] = []
        t = 0.0
        for i in range(self.requests):
            t += rng.expovariate(self.rps)
            s = rng.randrange(self.sessions)
            user = _text(rng, _pareto_int(
                rng, self.prompt_chars, self.tail_alpha,
                self.prompt_cap_chars))
            messages = ([{"role": "system", "content": systems[s]}]
                        + histories[s]
                        + [{"role": "user", "content": user}])
            max_tokens = _pareto_int(rng, self.output_tokens,
                                     self.tail_alpha,
                                     self.output_cap_tokens)
            tenant, tenant_adapters = self._pick_tenant(rng)
            event = {
                "t": round(t, 4),
                "session": f"s{s}",
                "turn": turns[s],
                "messages": messages,
                "max_tokens": max_tokens,
                "temperature": self.temperature,
                "model": self._pick_adapter(rng, i, tenant_adapters),
            }
            if tenant:
                event["tenant"] = tenant
            events.append(event)
            turns[s] += 1
            # the assistant's (synthetic) reply joins the history, so the
            # next turn replays a strictly-grown prefix; histories are
            # bounded so late turns can't blow the context window
            histories[s].append({"role": "user", "content": user})
            histories[s].append({
                "role": "assistant",
                "content": _text(rng, max_tokens * 4)})
            if len(histories[s]) > 6:
                histories[s] = histories[s][-6:]
        return events

    def meta(self) -> dict:
        doc = {
            "requests": self.requests, "sessions": self.sessions,
            "rps": self.rps, "seed": self.seed,
            "adapters": list(self.adapters),
            "tail_alpha": self.tail_alpha,
        }
        if self.tenants:
            doc["tenants"] = {n: dict(e) for n, e in self.tenants.items()}
        return doc


# ------------------------------------------------- gateway trace-log import

def from_trace_log(path: str, prompt_chars: int = 80,
                   chars_per_token: float = 4.0,
                   temperature: float = 0.8) -> Tuple[dict, List[dict]]:
    """Convert a gateway ``--trace_log`` JSONL (one completed span per
    line, obs/trace.py format) into replay events — so replays are driven
    by REAL recorded traffic instead of the synthetic workload model.

    What the spans carry is what the replay gets: true arrival offsets
    (``start_ms``), the adapter mix (``attrs.adapter``), per-request
    output sizes (``attrs.chars``, streamed requests), and the trace id as
    the session key (affinity-stable across a multi-turn id). Spans do NOT
    record message content, so prompts are synthetic filler of
    ``prompt_chars`` — shape-true timing/mix, not content replay.

    Only gateway ROOT spans (``gateway.request`` / ``gateway.stream``)
    become events; replica/engine halves of the same trace are skipped.
    """
    rng = random.Random(0)
    rows: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for n, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                sp = json.loads(line)
            except json.JSONDecodeError:
                raise ValueError(f"{path}: line {n} is not JSON — is this "
                                 "a gateway --trace_log file?")
            if not isinstance(sp, dict):
                continue
            if sp.get("name") in ("gateway.request", "gateway.stream"):
                rows.append(sp)
    if not rows:
        raise ValueError(
            f"{path}: no gateway request spans found (expect "
            "gateway.request/gateway.stream lines from --trace_log)")
    rows.sort(key=lambda s: s.get("start_ms") or 0.0)
    t0 = rows[0].get("start_ms") or 0.0
    events: List[dict] = []
    for i, sp in enumerate(rows):
        attrs = sp.get("attrs") or {}
        chars = attrs.get("chars")
        if isinstance(chars, (int, float)) and chars > 0:
            max_tokens = max(1, int(round(chars / chars_per_token)))
        else:
            max_tokens = 16  # non-streamed spans don't record output size
        events.append({
            "t": round(max(0.0, ((sp.get("start_ms") or t0) - t0) / 1e3), 4),
            "session": sp.get("trace_id") or f"t{i}",
            "turn": 0,
            "messages": [{"role": "user",
                          "content": _text(rng, prompt_chars)}],
            "max_tokens": max_tokens,
            "temperature": temperature,
            "model": attrs.get("adapter") or "",
        })
    meta = {"source": "trace_log", "path": path,
            "requests": len(events), "prompt_chars": prompt_chars,
            "chars_per_token": chars_per_token}
    return meta, events


# ----------------------------------------------------------------- trace io

def write_trace(path_or_fp, events: List[dict],
                meta: Optional[dict] = None) -> None:
    """One header line + one event per line (JSONL)."""
    def _write(fp: TextIO):
        fp.write(json.dumps({"kind": TRACE_KIND, "version": TRACE_VERSION,
                             "meta": meta or {}}) + "\n")
        for ev in events:
            fp.write(json.dumps(ev) + "\n")

    if hasattr(path_or_fp, "write"):
        _write(path_or_fp)
    else:
        with open(path_or_fp, "w", encoding="utf-8") as f:
            _write(f)


def read_trace(path_or_fp) -> Tuple[dict, List[dict]]:
    """→ (meta, events). Validates the header and each event's shape so a
    stale or foreign file fails loudly before any traffic fires."""
    def _read(fp: TextIO):
        header_line = fp.readline()
        try:
            header = json.loads(header_line)
        except json.JSONDecodeError:
            raise ValueError("not a dtx-load-trace: bad header line")
        if header.get("kind") != TRACE_KIND:
            raise ValueError(
                f"not a dtx-load-trace (kind={header.get('kind')!r})")
        if header.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {header.get('version')!r}")
        events = []
        for n, line in enumerate(fp, 2):
            if not line.strip():
                continue
            ev = json.loads(line)
            if not isinstance(ev.get("t"), (int, float)) \
                    or not isinstance(ev.get("messages"), list) \
                    or not ev["messages"]:
                raise ValueError(f"line {n}: bad event {ev!r}")
            events.append(ev)
        events.sort(key=lambda e: e["t"])
        return header.get("meta") or {}, events

    if hasattr(path_or_fp, "read"):
        return _read(path_or_fp)
    with open(path_or_fp, encoding="utf-8") as f:
        return _read(f)


def summarize(events: List[dict]) -> Dict[str, float]:
    """Shape summary for reports/logs (counts, tail sizes, adapter mix)."""
    if not events:
        return {"requests": 0}
    chars = sorted(sum(len(m.get("content", "")) for m in e["messages"])
                   for e in events)
    adapters = {e.get("model") or "" for e in events}
    multi = sum(1 for e in events if e.get("turn", 0) > 0)
    out = {
        "requests": len(events),
        "duration_s": round(events[-1]["t"], 3),
        "prompt_chars_p50": chars[len(chars) // 2],
        "prompt_chars_max": chars[-1],
        "multi_turn": multi,
        "adapters": len(adapters - {""}),
    }
    tenants = {e.get("tenant") or "" for e in events} - {""}
    if tenants:
        out["tenants"] = len(tenants)
    return out
