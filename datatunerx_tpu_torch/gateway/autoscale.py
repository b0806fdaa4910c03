"""Autoscale signal: queue depth + p95 latency → replica-count hint.

The gateway only OBSERVES; deciding replica count is the operator's job
(operator/capacity.py ``serving_replicas_for`` clamps the hint against
min/max and free slice inventory, and finetunejob_controller applies it).
The hint is exposed at GET /autoscale as JSON so any consumer — the
FinetuneJob controller's serving reconciler, an HPA adapter, a human with
curl — reads the same numbers.
"""

from __future__ import annotations

from typing import Optional


def autoscale_hint(
    *,
    replicas: int,
    available_replicas: int,
    queue_depth: int,
    queued_tokens: int,
    shed_count: int,
    p95_latency_s: float,
    shed_recent: Optional[int] = None,
    queue_high_per_replica: int = 4,
    latency_target_s: float = 30.0,
    slo_burn: Optional[dict] = None,
    fleet_blocks: Optional[dict] = None,
    block_low_watermark: float = 0.1,
) -> dict:
    """Pure function of current observations → desired-replica hint.

    Scale up when the queue backs up past ``queue_high_per_replica`` waiting
    requests per available replica, when requests are being shed, or when
    the latency signal breaches. Scale down only on a fully idle gateway
    (empty queue, comfortable latency). One step per poll: the controller
    re-polls, so ramping is feedback-driven rather than jumpy.

    ``shed_count`` is the lifetime total (reported); the scale-up trigger
    uses ``shed_recent`` — sheds since the previous poll — so one overload
    blip long past doesn't demand scale-up forever. Callers without a
    since-last-poll delta may omit it, accepting the ratchet.

    ``slo_burn`` (``{"name", "burn_rate"}`` — the gateway's worst-burning
    configured objective) REPLACES the raw-p95 signal when present: burn
    rate > 1.0 spends error budget faster than the objective allows, which
    is the scaling contract an operator actually declared; a raw p95
    threshold is a guess about one. Without it (no ``--slo_config``), the
    p95 branch behaves exactly as before.

    ``fleet_blocks`` (``{"free", "total"}`` — the fleet's live paged-KV
    inventory) makes the hint derive from BLOCKS rather than slots: when
    the free fraction drops below ``block_low_watermark`` the fleet is
    about to shed/queue on KV capacity regardless of how latency looks,
    so scale-up fires on the same signal admission sheds on. The block
    numbers are echoed in the output either way.
    """
    n = max(1, replicas)
    desired = n
    reason = "steady"
    if available_replicas < n:
        # dead/draining replicas: first priority is restoring capacity,
        # not adding more — the operator redeploys on FAILED status
        reason = f"degraded: {available_replicas}/{n} replicas available"
    backlog_high = queue_high_per_replica * max(1, available_replicas)
    shedding = shed_count if shed_recent is None else shed_recent
    blocks_low = (fleet_blocks is not None
                  and fleet_blocks.get("total", 0) > 0
                  and (fleet_blocks.get("free", 0)
                       / fleet_blocks["total"]) < block_low_watermark)
    if shedding > 0 and queue_depth > 0:
        desired = n + 1
        reason = f"shedding load ({shedding} shed, queue={queue_depth})"
    elif queue_depth > backlog_high:
        desired = n + 1
        reason = f"queue depth {queue_depth} > {backlog_high}"
    elif blocks_low:
        desired = n + 1
        reason = (f"fleet KV blocks low ({fleet_blocks.get('free', 0)}/"
                  f"{fleet_blocks['total']} free < "
                  f"{block_low_watermark:.0%})")
    elif slo_burn is not None:
        if slo_burn["burn_rate"] > 1.0:
            desired = n + 1
            reason = (f"SLO {slo_burn['name']} burn rate "
                      f"{slo_burn['burn_rate']:.2f} > 1.0")
        elif (queue_depth == 0 and n > 1
              and slo_burn["burn_rate"] < 0.25):
            desired = n - 1
            reason = "idle"
    elif p95_latency_s > latency_target_s:
        desired = n + 1
        reason = (f"p95 latency {p95_latency_s:.2f}s > "
                  f"{latency_target_s:.2f}s target")
    elif (queue_depth == 0 and n > 1
          and p95_latency_s < latency_target_s / 4):
        desired = n - 1
        reason = "idle"
    out = {
        "replicas": n,
        "availableReplicas": available_replicas,
        "desiredReplicas": desired,
        "queueDepth": queue_depth,
        "queuedTokens": queued_tokens,
        "shedCount": shed_count,
        "p95LatencySeconds": round(p95_latency_s, 4),
        "reason": reason,
    }
    if slo_burn is not None:
        out["sloBurnRate"] = slo_burn["burn_rate"]
        out["sloObjective"] = slo_burn["name"]
    if fleet_blocks is not None:
        out["fleetKvBlocksFree"] = int(fleet_blocks.get("free", 0))
        out["fleetKvBlocksTotal"] = int(fleet_blocks.get("total", 0))
    return out


def parse_hint(doc: Optional[dict]) -> Optional[dict]:
    """Validate a hint document polled over HTTP (operator side): any
    missing/garbled field voids the hint rather than scaling on junk."""
    if not isinstance(doc, dict):
        return None
    try:
        return {
            "replicas": int(doc["replicas"]),
            "availableReplicas": int(doc.get("availableReplicas",
                                             doc["replicas"])),
            "desiredReplicas": int(doc["desiredReplicas"]),
            "queueDepth": int(doc.get("queueDepth", 0)),
            "queuedTokens": int(doc.get("queuedTokens", 0)),
            "shedCount": int(doc.get("shedCount", 0)),
            "p95LatencySeconds": float(doc.get("p95LatencySeconds", 0.0)),
            "reason": str(doc.get("reason", "")),
        }
    except (KeyError, TypeError, ValueError):
        return None
