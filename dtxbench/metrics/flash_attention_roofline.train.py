"""Flash attention's share of its roofline in the device window's steps:
the least time of the steps' attention work (forward and backward over
each packed document's causal extent, ``harness/flops.train_attention``)
over the device time of the kernels of ``kernels/attention.json``, in
percent."""


def read(lc):
    ns = lc["window"].kernel_ns(lc["kernels"]("attention"))
    if ns <= 0:
        return None
    return 100.0 * lc["attention_least_s"] / (ns / 1e9)
