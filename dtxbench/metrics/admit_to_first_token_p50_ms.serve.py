"""Prefill latency without the queue: the 50th percentile over the
requests whose first token came in the measured window of the time from
their first ``admit`` mark in the engine's timeline to that token (ms):
the chunked prefill, interleaved with decode chunks, and the first draw."""

from dtxbench.harness import stats


def read(lc):
    xs = lc.get("admit_to_first_token_ms")
    return stats.percentile(xs, 50) if xs else None
