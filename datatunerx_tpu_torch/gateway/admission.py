"""Admission control: bounded queue + prefill-token budget backpressure,
plus FLEET-TRUE block admission when the replicas report a paged KV pool.

Overload on a GPU replica is not graceful: an unbounded admission queue
turns into unbounded prefill work and eventually an HBM OOM that kills every
in-flight request on the chip. The gateway instead bounds BOTH the request
count and the estimated queued prefill tokens; past either limit it sheds
with 429 + Retry-After, so clients back off and in-flight requests finish
untouched (the degradation mode Ray Serve's max_concurrent_queries provides
in the reference).

Fleet-true mode (``fleet_blocks_fn`` wired by the gateway): the static
token budget is a calibration guess, but paged replicas publish their LIVE
free-block sum — the resource that actually caps concurrent sessions. Each
admit is priced in blocks (tokenized-prompt estimate + a decode headroom,
the overcommit-aware blocks-per-admit: engines running ``--kv_overcommit
on`` grow past the headroom on demand, so pricing the full ``max_tokens``
here would re-create the eager pessimism server-side), and admission sheds
when the price exceeds what the fleet has free, net of admits so recent the
replicas' gauges cannot reflect them yet. Dense fleets (or missing stats)
return no block signal and the static budget remains the only gate.

Retry-After is BLOCK-denominated when the fleet reports a paged pool:
successive ``fleet_blocks_fn`` samples yield a freed-blocks/s EWMA, and a
shed client waits roughly until the fleet has freed the blocks its admit
needs — the same currency admission itself is priced in. When that rate
is unpopulated (dense fleet, no frees observed yet) it falls back to the
token-drain EWMA (completed prefill tokens/s), so a shed client still
waits roughly one queue-drain, not a fixed guess. ``calibrate()`` lets the gateway feed REAL replica-side
tokenized prompt counts back (the serving response's ``usage``), so the
chars-per-token heuristic converges on the deployment's actual ratio when
no local tokenizer is available.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class Overloaded(Exception):
    def __init__(self, reason: str, retry_after_s: int):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


def estimate_prompt_tokens(
    messages: List[dict],
    chars_per_token: float = 4.0,
    count_tokens: Optional[Callable[[str], int]] = None,
) -> int:
    """Prefill-cost estimate for admission.

    With ``count_tokens`` (a real tokenizer's text→token-count function,
    wired when the gateway has the model's tokenizer) the estimate is exact
    up to template overhead. Without one, ~``chars_per_token`` chars/token
    (default 4, the BPE English average — configurable because CJK text runs
    ~1.5 chars/token and code ~3, which under/over-admits by 2x+) + a few
    tokens of template overhead per message. Only relative magnitude matters
    — the budget is calibrated in the same units."""
    total = 0
    for m in messages or []:
        content = str(m.get("content", ""))
        if count_tokens is not None:
            try:
                total += int(count_tokens(content)) + 4
                continue
            except Exception:  # noqa: BLE001 — estimator must never shed 500s
                pass
        total += int(len(content) / max(chars_per_token, 0.1)) + 4
    return max(1, total)


class Ticket:
    """An admitted request's reservation; release exactly once."""

    def __init__(self, controller: "AdmissionController", tokens: int,
                 tenant: str = "", blocks: int = 0):
        self._controller = controller
        self.tokens = tokens
        self.tenant = tenant
        self.blocks = blocks
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self._controller._release(self.tokens, tenant=self.tenant,
                                      blocks=self.blocks)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdmissionController:
    def __init__(self, max_queue: int = 64, token_budget: int = 32768,
                 min_retry_after_s: int = 1, max_retry_after_s: int = 30,
                 chars_per_token: float = 4.0,
                 count_tokens: Optional[Callable[[str], int]] = None,
                 fleet_blocks_fn: Optional[Callable[[], Optional[dict]]] = None,
                 decode_headroom_tokens: int = 64,
                 pending_window_s: float = 2.0,
                 share_enforce_util: float = 0.8):
        self.max_queue = max_queue
        self.token_budget = token_budget
        self.min_retry_after_s = min_retry_after_s
        self.max_retry_after_s = max_retry_after_s
        self.chars_per_token = chars_per_token
        self.count_tokens = count_tokens
        # fleet-true block admission: () -> {"free", "total", "block_size"}
        # summed over available paged replicas, or None (no block signal)
        self.fleet_blocks_fn = fleet_blocks_fn
        self.decode_headroom_tokens = decode_headroom_tokens
        # admits so recent the replicas' scraped free-block gauges cannot
        # reflect their engine-side reservation yet — counted against the
        # fleet sum for one stats-refresh window, then auto-expired (the
        # live gauge carries them from there; keeping the reserve for the
        # whole request lifetime would double-count every running session)
        self.pending_window_s = pending_window_s
        self._pending_blocks: List[tuple] = []  # (t_admit, blocks)
        # weighted-fair shares only bite once the GLOBAL budget is this
        # contended — an idle gateway lets any tenant burst past its share
        # (work-conserving, the smooth-WRR property the router already has)
        self.share_enforce_util = share_enforce_util
        self._tenant_tokens: dict = {}  # tenant -> in-flight prefill tokens
        self._tenant_blocks: dict = {}  # tenant -> in-flight priced blocks
        self._depth = 0
        self._tokens = 0
        self._shed = 0
        self._lock = threading.Lock()
        # drain-rate EWMA (tokens/s) for the Retry-After estimate
        self._rate = 0.0
        self._last_release = time.monotonic()
        # block-drain EWMA (freed blocks/s) from successive fleet samples:
        # the Retry-After currency once admission is priced in blocks.
        # Only POSITIVE free-count deltas feed it (a growing free count is
        # the fleet draining; admissions shrinking it are not a drain).
        self._blocks_rate = 0.0
        self._last_fleet: Optional[tuple] = None  # (t, free)

    # ------------------------------------------------------------ admission
    def estimate(self, messages: List[dict]) -> int:
        return estimate_prompt_tokens(messages,
                                      chars_per_token=self.chars_per_token,
                                      count_tokens=self.count_tokens)

    def calibrate(self, chars: int, tokens: int):
        """Fold one observed (prompt chars, replica-side tokenized count)
        pair into the chars-per-token estimate — truthful token counts
        over the wire replace the static heuristic as traffic flows. A
        wired ``count_tokens`` still wins at estimate time; this keeps the
        fallback honest for gateways without the model's tokenizer."""
        if tokens <= 0 or chars <= 0:
            return
        ratio = max(0.1, chars / tokens)
        with self._lock:
            self.chars_per_token = (0.8 * self.chars_per_token
                                    + 0.2 * ratio)

    def blocks_for_admit(self, tokens: int, block_size: int) -> int:
        """Overcommit-aware blocks-per-admit estimate: the tokenized
        prompt plus a decode headroom, in blocks — what one admission
        costs an overcommitted engine up front (lazy growth covers the
        rest; an eager fleet simply sheds a little later than its own
        FIFO would queue)."""
        bs = max(1, int(block_size))
        return -(-(tokens + self.decode_headroom_tokens) // bs)

    def try_admit(self, messages: List[dict],
                  tokens: Optional[int] = None,
                  tenant: Optional[dict] = None) -> Ticket:
        """Admit or shed. ``tenant`` (when the gateway runs a tenant
        directory) is ``{"name", "share", "share_total", "kv_block_quota"}``
        — the resolved tenant's pricing row. ``None`` takes exactly the
        pre-tenancy path, byte for byte."""
        n = tokens if tokens is not None else self.estimate(messages)
        fleet = None
        if self.fleet_blocks_fn is not None:
            try:
                fleet = self.fleet_blocks_fn()
            except Exception:  # noqa: BLE001 — a stats fault must not shed 500s
                fleet = None
        t_name = str(tenant.get("name", "")) if tenant else ""
        with self._lock:
            if fleet and fleet.get("total"):
                self._note_fleet_locked(fleet)
            if self._depth + 1 > self.max_queue:
                self._shed += 1
                raise Overloaded(
                    f"queue full ({self._depth}/{self.max_queue} requests)",
                    self._retry_after_locked())
            if self._tokens + n > self.token_budget:
                self._shed += 1
                raise Overloaded(
                    f"prefill token budget exhausted ({self._tokens}+{n}"
                    f">{self.token_budget})",
                    self._retry_after_locked())
            if tenant:
                # weighted-fair share: once the global budget is contended,
                # tenant i holds at most share_i/Σshares of it. Below the
                # contention watermark any tenant may burst (work-conserving).
                share = float(tenant.get("share", 1) or 1)
                total = float(tenant.get("share_total", share) or share)
                contended = (self._tokens + n
                             > self.share_enforce_util * self.token_budget)
                cap = int(self.token_budget * share / max(total, share))
                held = self._tenant_tokens.get(t_name, 0)
                if contended and held + n > cap:
                    self._shed += 1
                    raise Overloaded(
                        f"tenant {t_name} over fair share "
                        f"({held}+{n}>{cap} tokens, share {share:g}/"
                        f"{total:g})",
                        self._retry_after_locked())
            t_blocks = 0
            if tenant:
                # KV-block quota is enforced whether or not the fleet
                # publishes a block signal — without one the default block
                # size prices the admit, so a quota'd tenant is still
                # capped on a dense fleet
                quota = int(tenant.get("kv_block_quota", 0) or 0)
                bs = (fleet.get("block_size") or 16) if fleet else 16
                t_blocks = self.blocks_for_admit(n, bs)
                t_held = self._tenant_blocks.get(t_name, 0)
                if quota > 0 and t_held + t_blocks > quota:
                    self._shed += 1
                    raise Overloaded(
                        f"tenant {t_name} KV block quota exhausted "
                        f"({t_held}+{t_blocks}>{quota} blocks)",
                        self._retry_after_locked(
                            block_deficit=t_held + t_blocks - quota))
            if fleet and fleet.get("total"):
                now = time.monotonic()
                self._pending_blocks = [
                    (t, b) for t, b in self._pending_blocks
                    if now - t < self.pending_window_s]
                pending = sum(b for _, b in self._pending_blocks)
                need = self.blocks_for_admit(
                    n, fleet.get("block_size") or 16)
                free = int(fleet.get("free", 0))
                if need + pending > free:
                    self._shed += 1
                    raise Overloaded(
                        f"fleet KV blocks exhausted (need {need}, "
                        f"free {free}, pending {pending})",
                        self._retry_after_locked(
                            block_deficit=need + pending - free))
                self._pending_blocks.append((now, need))
            self._depth += 1
            self._tokens += n
            if tenant:
                self._tenant_tokens[t_name] = (
                    self._tenant_tokens.get(t_name, 0) + n)
                self._tenant_blocks[t_name] = (
                    self._tenant_blocks.get(t_name, 0) + t_blocks)
        return Ticket(self, n, tenant=t_name if tenant else "",
                      blocks=t_blocks)

    def _release(self, tokens: int, tenant: str = "", blocks: int = 0):
        now = time.monotonic()
        with self._lock:
            self._depth = max(0, self._depth - 1)
            self._tokens = max(0, self._tokens - tokens)
            if tenant in self._tenant_tokens:
                left = self._tenant_tokens[tenant] - tokens
                if left > 0:
                    self._tenant_tokens[tenant] = left
                else:
                    self._tenant_tokens.pop(tenant, None)
            if tenant in self._tenant_blocks:
                left = self._tenant_blocks[tenant] - blocks
                if left > 0:
                    self._tenant_blocks[tenant] = left
                else:
                    self._tenant_blocks.pop(tenant, None)
            dt = max(1e-3, now - self._last_release)
            self._last_release = now
            inst = tokens / dt
            self._rate = inst if self._rate == 0 else (
                0.8 * self._rate + 0.2 * inst)

    def _note_fleet_locked(self, fleet: dict):
        """Fold one fleet free-block sample into the freed-blocks/s EWMA.
        Only positive deltas count: a rising free count is the fleet
        draining; admissions pulling it down are not drain throughput.
        Unchanged samples (the replicas' stats TTL cache) are skipped so
        they neither decay nor inflate the rate."""
        now = time.monotonic()
        free = int(fleet.get("free", 0))
        if self._last_fleet is not None:
            t0, f0 = self._last_fleet
            dt = now - t0
            freed = free - f0
            if dt >= 1e-3 and freed > 0:
                inst = freed / dt
                self._blocks_rate = inst if self._blocks_rate == 0 else (
                    0.8 * self._blocks_rate + 0.2 * inst)
        self._last_fleet = (now, free)

    def _retry_after_locked(self, block_deficit: int = 0) -> int:
        if block_deficit > 0 and self._blocks_rate > 0:
            # block-denominated: wait until the fleet has freed the
            # blocks this admit is short by, at the observed drain rate
            est = block_deficit / self._blocks_rate
        elif self._rate > 0:
            est = self._tokens / self._rate
        else:
            est = float(self.max_retry_after_s)
        return int(min(self.max_retry_after_s,
                       max(self.min_retry_after_s, round(est))))

    # -------------------------------------------------------------- reports
    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def queued_tokens(self) -> int:
        with self._lock:
            return self._tokens

    @property
    def shed_count(self) -> int:
        with self._lock:
            return self._shed

    def tenant_usage(self) -> dict:
        """Per-tenant in-flight reservations (tokens and priced blocks)
        — the gateway restates these as dtx_gateway_tenant_* gauges."""
        with self._lock:
            return {"tokens": dict(self._tenant_tokens),
                    "blocks": dict(self._tenant_blocks)}
