"""Paged prefill attention's share of its roofline: the least time of each
prefill chunk's attention over its cached and new positions
(``harness/flops.prefill_chunk``) over the device time of the kernels of
``kernels/prefill_attention.json`` in the device window, in percent."""


def read(lc):
    ns = lc["window"].kernel_ns(lc["kernels"]("prefill_attention"))
    if ns <= 0 or lc["prefill_attention_least_s"] <= 0:
        return None
    return 100.0 * lc["prefill_attention_least_s"] / (ns / 1e9)
