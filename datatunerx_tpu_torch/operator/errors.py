"""Sentinel errors + requeue policy (reference pkg/domain/valueobject/err.go,
pkg/util/handlererr/handler.go)."""

from __future__ import annotations

import os

from typing import Optional, Tuple


class ErrRecalibrate(Exception):
    """'waiting for dependent resources' — requeue quietly
    (reference valueobject/err.go:5-7)."""


# reference handlererr/handler.go:13,16 parity defaults; env-tunable for
# fast test suites (see tests/conftest.py)
RECALIBRATE_REQUEUE_S = float(os.environ.get("DTX_RECALIBRATE_REQUEUE_S", "10.0"))
ERROR_REQUEUE_S = float(os.environ.get("DTX_ERROR_REQUEUE_S", "30.0"))


def handle_err(err: Optional[BaseException]) -> Tuple[Optional[float], Optional[BaseException]]:
    """(requeue_after_seconds, error_to_surface) — reference
    handlererr/handler.go:11-19 semantics: ErrRecalibrate → 10s silent requeue;
    any other error → 30s requeue + surfaced error."""
    if err is None:
        return None, None
    if isinstance(err, ErrRecalibrate):
        return RECALIBRATE_REQUEUE_S, None
    return ERROR_REQUEUE_S, err
