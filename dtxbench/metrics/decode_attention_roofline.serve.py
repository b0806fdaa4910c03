"""Paged decode attention's share of its roofline: each decode token's K
and V read once (``harness/flops.decode_kv_bytes``) over HBM's bandwidth,
over the device time of the kernels of ``kernels/decode_attention.json``
in the device window, in percent."""


def read(lc):
    ns = lc["window"].kernel_ns(lc["kernels"]("decode_attention"))
    if ns <= 0 or lc["decode_attention_least_s"] <= 0:
        return None
    return 100.0 * lc["decode_attention_least_s"] / (ns / 1e9)
