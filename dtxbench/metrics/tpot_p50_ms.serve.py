"""The decode time a token as requests see it: the median over the
requests that ended in the measured window of (last token − first token)
/ (tokens − 1), from the engine's token stamps (ms)."""

from dtxbench.harness import stats


def read(lc):
    xs = lc.get("tpot_ms")
    return stats.percentile(xs, 50) if xs else None
