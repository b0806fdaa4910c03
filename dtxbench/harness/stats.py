"""The arithmetic of tails. A rate is the work of the
whole window over the whole window; a tail is the percentile of every
request due in it, with a missing request counted as infinitely late."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks; ``inf`` in the values stays (a missing request)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_ms(due: Sequence[float], first: Sequence[Optional[float]]) -> list:
    """Each request's time to its first token from its due time (ms);
    ``inf`` for a request that never produced one."""
    return [math.inf if f is None else (f - d) * 1e3
            for d, f in zip(due, first)]


def tpot_ms(first: Sequence[Optional[float]], last: Sequence[Optional[float]],
            count: Sequence[int]) -> list:
    """(last token − first token) / (tokens − 1), for requests of two or
    more tokens; ``inf`` for one that never started."""
    out = []
    for f, l, n in zip(first, last, count):
        if f is None:
            out.append(math.inf)
        elif n >= 2:
            out.append((l - f) * 1e3 / (n - 1))
    return out
