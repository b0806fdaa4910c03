"""The serving step's share of the card's bf16 peak: the operations of
every decode token emitted and every prompt token prefilled in the device
window (``harness/flops``: projections, head for decode, attention over
each context) over the window's length times the peak, in percent."""

from dtxbench.harness import flops


def read(lc):
    seconds = lc["window"].seconds
    work = lc["decode_flops"] + lc["prefill_flops"]
    if seconds <= 0 or work <= 0:
        return None
    return 100.0 * work / (seconds * flops.BF16)
