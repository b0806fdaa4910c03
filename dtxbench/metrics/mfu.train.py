"""The training window's share of the card's bf16 peak: the operations the
algorithm needs for every step of the measured window
(``harness/flops.train_step_flops``, no recomputation) over the window's
length times the published peak, in percent. The window is untraced."""

from dtxbench.harness import flops


def read(lc):
    if lc.get("window_s", 0) <= 0 or not lc.get("window_flops"):
        return None
    return 100.0 * lc["window_flops"] / (lc["window_s"] * flops.BF16)
