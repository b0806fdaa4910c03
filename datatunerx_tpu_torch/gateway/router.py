"""Routing policies: which replica gets the next request.

Selection pipeline (every policy):

  1. candidates = healthy ∩ not-draining ∩ circuit-allows
  2. adapter RESIDENCY preference (cache-locality, not a hard filter):
     replicas whose adapter pool already holds the requested LoRA adapter
     win (no load latency); otherwise any replica that KNOWS the adapter
     (static stack or registered-for-load-on-miss) — routing there makes
     the engine load it at admission, and the replica becomes the
     preferred target for the adapter's next requests; if nothing reports
     the adapter (or stats are unknown), fall back to all candidates —
     the engine loads on demand / 400s an unknown name.
  3. session affinity: a request carrying a session key sticks to the
     replica that served the session before (its prefix cache holds the
     conversation's KV rows, so re-prefill becomes a suffix extension) —
     as long as that replica is still a candidate.
  4. traffic weights: replicas carry a ``weight`` (canary promotion,
     gateway/server.py /admin/promote). Weight 0 = no new requests (a
     rolled-back canary). When the candidate set's weights are
     NON-uniform, selection is smooth weighted round-robin — a
     deterministic rotation whose long-run shares equal the weights
     exactly (nginx's algorithm), so a 5% canary weight means 1 request
     in 20, observably. Uniform weights (the default 1.0 everywhere)
     fall through to the policy pick, preserving pre-weight behavior.
  5. policy pick: ``least_busy`` (lowest slot occupancy, gateway in-flight
     count as tiebreak/fallback) or ``round_robin``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional

from datatunerx_tpu_torch.gateway.replica_pool import (
    NoReplicaAvailable,
    Replica,
    ReplicaPool,
)

POLICIES = ("least_busy", "round_robin")


def session_key(messages: List[dict], explicit: Optional[str] = None) -> str:
    """Affinity key for a conversation. An explicit session id (body
    ``session_id`` / ``user`` field, X-DTX-Session-Id header) wins; else the
    first message anchors the conversation — every later turn of the same
    chat shares it, so turns land where the prefix cache is warm."""
    if explicit:
        return str(explicit)
    if not messages:
        return ""
    first = messages[0]
    seed = f"{first.get('role', '')}:{first.get('content', '')}"
    return hashlib.sha1(seed.encode("utf-8", "replace")).hexdigest()


class Router:
    def __init__(self, pool: ReplicaPool, policy: str = "least_busy",
                 affinity_capacity: int = 4096,
                 prefill_threshold: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.pool = pool
        self.policy = policy
        # disaggregation: prompts of >= this many tokens PREFER replicas
        # declaring role=prefill; shorter prompts prefer non-prefill
        # replicas. 0 disables the stage entirely (routing byte-identical
        # to a role-less fleet).
        self.prefill_threshold = int(prefill_threshold or 0)
        self._rr = 0
        self._wrr: dict = {}  # smooth-WRR current weights, by replica name
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        self._affinity_capacity = affinity_capacity
        self._lock = threading.Lock()
        # adapter-routing outcomes (gateway /metrics): how often the
        # residency preference paid off vs forced a load-on-miss
        self.adapter_routes = {"resident": 0, "load_miss": 0, "blind": 0}
        # adapter -> routed count. Only adapters some replica actually
        # reports (non-blind) are counted, and the key set is capped:
        # the 'model' field is client-controlled, and every key becomes a
        # Prometheus series — unvalidated names must not grow either
        # without bound.
        self.adapter_requests: dict = {}
        self._adapter_requests_cap = 1024
        # spec-routing outcomes: how often spec-friendly (greedy) traffic
        # found a healthy speculative-decode replica to prefer
        self.spec_routes = {"preferred": 0, "blind": 0}
        # role-routing outcomes: long prompts steered to prefill
        # specialists, short ones away from them, or no role signal
        self.role_routes = {"prefill": 0, "decode": 0, "blind": 0}
        # replicas whose acceptance EMA sits below this report as spec-
        # enabled but are NOT preferred — their controller has effectively
        # disabled drafting, so there is no TPOT win to chase there.
        # Matches AdaptiveK's stand-down floor (serving/speculative.py),
        # kept as a literal so the router stays importable without torch.
        self.spec_accept_floor = 0.35

    def route(self, messages: Optional[List[dict]] = None,
              adapter: str = "", session_id: Optional[str] = None,
              exclude: Optional[set] = None, on_event=None,
              prefer_spec: bool = False,
              prompt_tokens: Optional[int] = None) -> Replica:
        """Pick a replica. ``exclude`` names replicas already tried for this
        request (failover must not retry the replica that just died).
        ``on_event(name, **detail)`` receives routing decisions — the
        gateway wires it to the request's trace span so adapter
        residency/load-miss outcomes land in GET /debug/trace/<id>."""
        exclude = exclude or set()
        candidates = [r for r in self.pool.available()
                      if r.name not in exclude]
        # weight 0 = receives no NEW requests (rolled-back canary); if
        # every candidate is weighted out, weights are ignored — serving
        # degraded beats serving nothing
        weighted = [r for r in candidates
                    if getattr(r, "weight", 1.0) > 0.0]
        candidates = weighted or candidates
        if not candidates:
            raise NoReplicaAvailable(
                f"no available replica (total={len(self.pool.replicas())}, "
                f"excluded={sorted(exclude)})")

        if adapter:
            candidates = self._adapter_candidates(adapter, candidates,
                                                  on_event)
        if self.prefill_threshold > 0 and prompt_tokens is not None:
            candidates = self._role_candidates(prompt_tokens, candidates,
                                               on_event)
        if prefer_spec:
            candidates = self._spec_candidates(candidates, on_event)

        key = session_key(messages or [], session_id)
        if key:
            with self._lock:
                pinned = self._affinity.get(key)
            if pinned:
                for r in candidates:
                    if r.name == pinned:
                        self._touch(key, r.name)
                        return r

        chosen = self._pick(candidates)
        if key:
            self._touch(key, chosen.name)
        return chosen

    def _adapter_candidates(self, adapter: str,
                            candidates: List[Replica], on_event) -> list:
        """Narrow candidates by adapter CACHE LOCALITY: resident replicas
        first (the request decodes immediately), else replicas that can
        load-on-miss (static stack or registered in their pool — routing
        there warms the adapter for its next requests), else everyone (no
        signal; the engine answers authoritatively). Never a hard filter:
        an adapter nowhere resident still gets served."""
        resident_set: List[Replica] = []
        capable: List[Replica] = []
        no_signal: List[Replica] = []
        for r in candidates:
            st = r.stats()
            res = st.get("resident_adapters")
            known = st.get("adapters")
            if res is not None and adapter in res:
                resident_set.append(r)
            if known is None:
                # stats unknown (scrape failed / pre-first-fetch): not
                # evidence the replica must load — counting it as a
                # load_miss would report missing stats as cold adapters
                no_signal.append(r)
            elif adapter in known:
                capable.append(r)
        if resident_set:
            outcome, picked = "resident", resident_set
        elif capable:
            outcome, picked = "load_miss", capable
        else:
            outcome, picked = "blind", no_signal or candidates
        with self._lock:
            self.adapter_routes[outcome] += 1
            if outcome != "blind" and (
                    adapter in self.adapter_requests
                    or len(self.adapter_requests)
                    < self._adapter_requests_cap):
                self.adapter_requests[adapter] = \
                    self.adapter_requests.get(adapter, 0) + 1
        if on_event is not None:
            on_event("adapter_route", adapter=adapter, outcome=outcome,
                     resident=[r.name for r in resident_set],
                     candidates=len(picked))
        return picked

    def _spec_candidates(self, candidates: List[Replica], on_event) -> list:
        """Spec-friendly traffic (greedy/low-temperature — the workloads
        whose drafts verify best) PREFERS replicas running speculative
        decoding with a healthy acceptance rate, read from replica stats
        (``dtx_serving_spec_enabled`` / ``_accept_rate`` on remote
        replicas). A preference, never a filter — a fleet with no spec
        replica, or one whose acceptance collapsed below the floor, routes
        exactly as before."""
        preferred: List[Replica] = []
        for r in candidates:
            try:
                st = r.stats_snapshot()
            except Exception:  # noqa: BLE001 — stats are advisory
                continue
            if not st.get("spec_enabled"):
                continue
            rate = st.get("spec_accept_rate")
            if rate is None or rate >= self.spec_accept_floor:
                preferred.append(r)
        with self._lock:
            if preferred and len(preferred) < len(candidates):
                self.spec_routes["preferred"] += 1
            else:
                self.spec_routes["blind"] += 1
        if preferred and len(preferred) < len(candidates):
            if on_event is not None:
                on_event("spec_route", outcome="preferred",
                         replicas=[r.name for r in preferred])
            return preferred
        return candidates

    def _role_candidates(self, prompt_tokens: int,
                         candidates: List[Replica], on_event) -> list:
        """Disaggregated routing: prompts at/above the threshold PREFER
        prefill specialists (their chunked-prefill budget is the product
        there — the handoff coordinator re-homes them for decode);
        everything else prefers non-prefill replicas so specialists stay
        free for prompt work. A preference, never a filter — a fleet with
        no matching role routes exactly as before (mixed replicas satisfy
        both sides)."""
        long_prompt = prompt_tokens >= self.prefill_threshold
        if long_prompt:
            preferred = [r for r in candidates
                         if getattr(r, "role", "mixed") == "prefill"]
            outcome = "prefill"
        else:
            preferred = [r for r in candidates
                         if getattr(r, "role", "mixed") != "prefill"]
            outcome = "decode"
        if not preferred or len(preferred) == len(candidates):
            with self._lock:
                self.role_routes["blind"] += 1
            return candidates
        with self._lock:
            self.role_routes[outcome] += 1
        if on_event is not None:
            on_event("role_route", outcome=outcome,
                     prompt_tokens=prompt_tokens,
                     replicas=[r.name for r in preferred])
        return preferred

    def _pick(self, candidates: List[Replica]) -> Replica:
        weights = {r.name: max(0.0, getattr(r, "weight", 1.0))
                   for r in candidates}
        if len(set(weights.values())) > 1:
            return self._pick_weighted(candidates, weights)
        if self.policy == "round_robin":
            with self._lock:
                # stable order so the rotation actually rotates
                ordered = sorted(candidates, key=lambda r: r.name)
                chosen = ordered[self._rr % len(ordered)]
                self._rr += 1
            return chosen
        return min(candidates, key=lambda r: (r.busy_fraction(), r.inflight,
                                              r.name))

    def _pick_weighted(self, candidates: List[Replica],
                       weights: dict) -> Replica:
        """Smooth weighted round-robin: each pick adds every candidate's
        weight to its running credit, the highest credit wins and pays the
        total back. Deterministic, and over any window the share of picks
        converges to weight/sum(weights) — the property the canary shift
        test asserts."""
        with self._lock:
            total = sum(weights.values())
            best: Optional[Replica] = None
            for r in sorted(candidates, key=lambda r: r.name):
                cur = self._wrr.get(r.name, 0.0) + weights[r.name]
                self._wrr[r.name] = cur
                if best is None or cur > self._wrr[best.name]:
                    best = r
            self._wrr[best.name] -= total
            return best

    def _touch(self, key: str, name: str):
        with self._lock:
            self._affinity[key] = name
            self._affinity.move_to_end(key)
            while len(self._affinity) > self._affinity_capacity:
                self._affinity.popitem(last=False)

    def forget_replica(self, name: str):
        """Drop affinity pins to a removed/dead replica so stale sessions
        rebalance instead of pinning to a ghost.

        Deliberately does NOT clear the replica's smooth-WRR credit: this
        is called on EVERY replica failure, and erasing the debt a just-
        picked replica owes would hand a failing canary the next pick
        again (over-weighting exactly the replica that is erroring). A
        stale credit entry for a removed replica is inert — it only moves
        when the replica is a candidate again."""
        with self._lock:
            for k in [k for k, v in self._affinity.items() if v == name]:
                del self._affinity[k]
