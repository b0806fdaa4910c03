"""The benchmark's own count of the work a layer needs, from the published
config and the shapes of the inputs, and the least time that work could
take on the card: the larger of operations over the bf16 peak and bytes
over HBM's bandwidth. The counts are of the algorithm, not of a kernel:
remat's recomputation, padding and the rows of idle serving slots are not
work, so a share reads the same whatever later implements the layer.

A matrix product of [n, a] by [a, b] is 2·n·a·b operations. Bytes count
each input read once and each output written once, in bf16 (2 bytes)
unless named.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
BF16 = PEAKS["bf16_flops_per_s"]
HBM = PEAKS["hbm_bytes_per_s"]


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16, nbytes / HBM)


class Shapes:
    """The sizes of a published config that the counts need."""

    def __init__(self, c: dict):
        self.D = c["hidden_size"]
        self.F = c["intermediate_size"]
        self.L = c["num_hidden_layers"]
        self.H = c["num_attention_heads"]
        self.KV = c.get("num_key_value_heads", self.H)
        self.d = c.get("head_dim") or self.D // self.H
        self.V = c["vocab_size"]
        q, kv = self.H * self.d, self.KV * self.d
        self.proj = {"q_proj": (self.D, q), "k_proj": (self.D, kv),
                     "v_proj": (self.D, kv), "o_proj": (q, self.D),
                     "gate_proj": (self.D, self.F),
                     "up_proj": (self.D, self.F),
                     "down_proj": (self.F, self.D)}
        self.layer_params = sum(a * b for a, b in self.proj.values())


# ---------------------------------------------------------------- training
FIRST_LAYER_NO_DX = ("q_proj", "k_proj", "v_proj")  # input: the embedding


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def train_attention(s: Shapes, segments) -> tuple:
    """(flops, bytes) of the step's attention, forward and backward, over
    each packed document's causal extent, every layer."""
    pairs = sum(causal_pairs(n) for n in segments)
    N = sum(segments)
    flops = 12 * s.H * s.d * pairs * s.L  # fwd 2 products, bwd 4
    qo, kv = N * s.H * s.d, N * s.KV * s.d
    # fwd: read q, k, v; write o and the f32 lse. bwd: read q, k, v, o,
    # do and lse; write dq, dk, dv
    nbytes = (2 * (qo + 2 * kv + qo) + 4 * N * s.H
              + 2 * (3 * qo + 2 * kv) + 4 * N * s.H
              + 2 * (qo + 2 * kv)) * s.L
    return flops, nbytes


def train_step_flops(s: Shapes, segments, lora_targets=(), rank=0) -> float:
    """Operations a LoRA step needs: every projection's and the head's
    forward and input gradient (none for the first layer's q/k/v, whose
    input is the frozen embedding), the adapters' forward and both their
    gradients, and attention over each document's causal extent."""
    N = sum(segments)
    first = sum(s.proj[p][0] * s.proj[p][1] for p in FIRST_LAYER_NO_DX)
    proj = 2 * N * s.layer_params * s.L + 2 * N * (s.layer_params * s.L
                                                    - first)
    head = 4 * N * s.D * s.V
    lora = 0
    for t in lora_targets:
        a, b = s.proj[t]
        per = 2 * N * rank * (a + b)  # forward: x·A, then ·B
        per += 2 * N * rank * b + 2 * N * a * rank + 2 * N * rank * b
        lora += per * s.L + 2 * N * rank * a * (s.L - 1)  # dx but layer 0
    return proj + head + lora + train_attention(s, segments)[0]


def train_nf4(s: Shapes, N: int) -> tuple:
    """(flops, least seconds) of the step's nf4 projections: each
    projection's forward once and its input gradient (not layer 0's
    q/k/v), each call reading its packed weights (half a byte a weight,
    an int8 scale a 64-block) and its activations."""
    flops = 0.0
    least = 0.0
    for p, (a, b) in s.proj.items():
        w = a * b * 0.5 + a * b / 64
        f = 2.0 * N * a * b
        t = least_s(f, w + 2 * N * (a + b))
        calls = 2 * s.L - (1 if p in FIRST_LAYER_NO_DX else 0)
        flops += f * calls
        least += t * calls
    return flops, least


# ---------------------------------------------------------------- serving
def decode_token_flops(s: Shapes, context: int) -> float:
    """One decode token attending to ``context`` positions (itself
    included): every projection, the head, q·K and p·V."""
    return (2 * s.layer_params * s.L + 2 * s.D * s.V
            + 4 * s.H * s.d * context * s.L)


def decode_kv_bytes(s: Shapes, context: int) -> float:
    """The K and V one decode token reads, in a bf16 pool, every layer."""
    return 2 * 2 * context * s.KV * s.d * s.L


def decode_attention_flops(s: Shapes, context: int) -> float:
    return 4 * s.H * s.d * context * s.L


def prefill_chunk(s: Shapes, n: int, cursor: int) -> tuple:
    """(all flops, attention flops, attention bytes) of a prefill chunk of
    ``n`` tokens after ``cursor`` cached ones."""
    pairs = n * cursor + causal_pairs(n)
    attn = 4 * s.H * s.d * pairs * s.L
    nbytes = 2 * (2 * n * s.H * s.d + 2 * (cursor + n) * s.KV * s.d) * s.L
    return 2 * n * s.layer_params * s.L + attn, attn, nbytes
