"""The decode time a token in the slow tail: the 90th percentile over the
requests that ended in the measured window of (last token − first token)
/ (tokens − 1), from the engine's token stamps (ms)."""

from dtxbench.harness import stats


def read(lc):
    xs = lc.get("tpot_ms")
    return stats.percentile(xs, 90) if xs else None
