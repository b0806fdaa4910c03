"""The prefill step's share of the card's bf16 peak: the operations of the
prompt tokens prefilled in the host window over the device time their
``dtx_engine_prefill_chunk`` ranges took (first kernel's start to last
kernel's end, range by range), in percent."""

from dtxbench.harness import flops


def read(lc):
    per = lc["host"].under_range("dtx_engine_prefill_chunk")
    ns = sum(max(k[1] for k in ks) - min(k[0] for k in ks)
             for ks in per if ks)
    if ns <= 0 or lc["host_prefill_flops"] <= 0:
        return None
    return 100.0 * lc["host_prefill_flops"] / (ns / 1e9 * flops.BF16)
