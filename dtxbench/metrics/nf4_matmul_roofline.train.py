"""The nf4 projections' share of their roofline in the device window's
steps: the least time of each projection's forward and input gradient
over its packed weights (``harness/flops.train_nf4``) over the device time
of the kernels of ``kernels/nf4.json``, in percent."""


def read(lc):
    if not lc.get("nf4_least_s"):
        return None
    ns = lc["window"].kernel_ns(lc["kernels"]("nf4"))
    if ns <= 0:
        return None
    return 100.0 * lc["nf4_least_s"] / (ns / 1e9)
