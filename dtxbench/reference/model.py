"""The plain reference of the Qwen1.5 (Qwen2 architecture) decoder, in
float32 PyTorch with TF32 off: RMSNorm, q/k/v projections with biases,
rotary embeddings ("rotate half", theta from the config), causal softmax
attention (confined to each packed document when segments are given),
SwiGLU, a final norm and an untied head. LoRA adds ``(drop(h) A) B ·
scale`` to its target projections, with inverted dropout from the
threefry key chain the trainer states. It imports nothing of the program.

``prec="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 (one scale a tensor, its absolute maximum at 448)
and accumulates in float32.

Weights come from ``Weights``: the benchmark's seeded draw, one layer at a
time, optionally worked out again as nf4 (``reference/nf4.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dtxbench.harness import weights as bw
from dtxbench.reference import nf4, threefry

IGNORE = -100
E4M3_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    # the rounding is the control's; its gradient passes straight through
    return t + (q - t).detach()


def mm(x, w, prec: str):
    if prec == "fp8":
        return _fp8(x) @ _fp8(w)
    return x @ w


class Weights:
    """A config's weights for the reference, drawn again from the seed:
    every layer kept in bf16 (or as nf4 codes and scales) on the device,
    handed out in float32 one layer at a time."""

    def __init__(self, c: dict, name: str, seed: int, device,
                 quant: str = ""):
        self.c, self.quant = c, quant
        self.layers = []
        for i in range(c["num_hidden_layers"]):
            lw = bw.layer(c, name, seed, i, device)
            if quant == "nf4":
                lw = {p: (nf4.quantize(k), b) for p, (k, b) in lw.items()}
            self.layers.append(lw)
        self.embed = bw.embedding(c, name, seed, device)
        self.head = bw.head(c, name, seed, device)

    def layer(self, i: int) -> dict:
        out = {}
        for p, (k, b) in self.layers[i].items():
            k = nf4.dequant(*k) if self.quant == "nf4" else k.float()
            out[p] = (k, None if b is None else b.float())
        return out


def rms_norm(x, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def rope(x, positions, theta: float):
    """x [B, T, H, d]; rotate-half with angles position · theta^(-2i/d)."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = positions.double()[..., None] * inv  # [B, T, half]
    cos = torch.cos(ang).float()[:, :, None, :]
    sin = torch.sin(ang).float()[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, allow, prec):
    """q [B, T, H, d], k/v [B, S, KV, d], allow [B, T, S] bool."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2), prec) / math.sqrt(d)
    s = s.masked_fill(~allow[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, vh, prec).transpose(1, 2)


def causal_allow(positions_q, segments=None):
    """[B, T, T]: key j visible to query i when j <= i (and, with packed
    segments, both lie in the same non-pad document)."""
    T = positions_q.shape[1]
    i = torch.arange(T, device=positions_q.device)
    allow = (i[None, :, None] >= i[None, None, :]).expand(
        positions_q.shape[0], T, T)
    if segments is not None:
        same = segments[:, :, None] == segments[:, None, :]
        allow = allow & same & (segments[:, :, None] > 0)
        # a pad row attends to itself, so its softmax is defined
        allow = allow | torch.eye(T, dtype=torch.bool,
                                  device=allow.device)[None]
    return allow


def layer_forward(x, lw, c, positions, allow, prec, lora=None,
                  keep=None, scale=0.0):
    """One decoder layer. ``lora``: {proj: (A [in, r], B [r, out])};
    ``keep``: {proj: bool mask [B, T, D]} of LoRA dropout (kept lanes are
    divided by the keep rate)."""
    B, T, D = x.shape
    H = c["num_attention_heads"]
    KV = c.get("num_key_value_heads", H)
    d = D // H
    eps = c["rms_norm_eps"]

    def proj(h, name):
        k, b = lw[name]
        out = mm(h, k, prec)
        if b is not None:
            out = out + b
        if lora and name in lora:
            a_, b_ = lora[name]
            hl = h
            if keep is not None and name in keep:
                m, rate = keep[name]
                hl = torch.where(m, h / rate, torch.zeros_like(h))
            out = out + mm(mm(hl, a_, prec), b_, prec) * scale
        return out

    h = rms_norm(x, eps)
    q = rope(proj(h, "q_proj").view(B, T, H, d), positions,
             c["rope_theta"])
    k = rope(proj(h, "k_proj").view(B, T, KV, d), positions,
             c["rope_theta"])
    v = proj(h, "v_proj").view(B, T, KV, d)
    a = attention(q, k, v, allow, prec).reshape(B, T, H * d)
    x = x + proj(a, "o_proj")
    h = rms_norm(x, eps)
    g = proj(h, "gate_proj")
    u = proj(h, "up_proj")
    return x + proj(F.silu(g) * u, "down_proj")


def logits(x, W: Weights, prec: str):
    return mm(rms_norm(x, W.c["rms_norm_eps"]), W.head.float(), prec)


# ---------------------------------------------------------------- training
def train_loss(W: Weights, tokens, positions, segments, labels, lora,
               scale: float, drop_rate: float, step_key, prec: str):
    """(sum of the next-token NLL over labelled positions, their count).
    ``lora``: {proj: (A [L, in, r], B [L, r, out])} float32 leaves.
    Dropout keys: ``fold_in(fold_in(step_key, layer), projection index)``
    over q, k, v, o, gate, up, down; each mask ``bernoulli(1 - p)`` over
    the projection input's [B, T, D]."""
    c = W.c
    order = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
             "up_proj", "down_proj")
    x = W.embed[tokens.long()].float()
    allow = causal_allow(positions, segments)
    rate = torch.tensor(1.0 - drop_rate, dtype=torch.float32,
                        device=x.device)

    def run(x, i, *ab):
        lw = W.layer(i)
        lo = {n: (ab[2 * j], ab[2 * j + 1]) for j, n in enumerate(lora)}
        keep = None
        if drop_rate > 0.0:
            lk = threefry.fold_in(step_key, i)
            keep = {n: (threefry.bernoulli(
                threefry.fold_in(lk, order.index(n)), 1.0 - drop_rate,
                tuple(x.shape), x.device), rate) for n in lora}
        return layer_forward(x, lw, c, positions, allow, prec, lo, keep,
                             scale)

    for i in range(c["num_hidden_layers"]):
        ab = [t for n in lora for t in (lora[n][0][i], lora[n][1][i])]
        x = checkpoint(run, x, i, *ab, use_reentrant=False)
    lg = logits(x, W, prec)[:, :-1]
    tgt = labels[:, 1:].long()
    valid = tgt != IGNORE
    logz = torch.logsumexp(lg, dim=-1)
    tok = torch.gather(lg, -1, torch.where(valid, tgt, 0)[..., None])[..., 0]
    nll = torch.where(valid, logz - tok, torch.zeros_like(logz))
    return nll.sum(), valid.sum()


# ----------------------------------------------------------------- serving
@torch.no_grad()
def sequence_logits(W: Weights, seqs, wanted, prec: str = "f32"):
    """Full forwards over whole sequences (no cache), layer by layer for
    all of them: ``seqs`` token lists, ``wanted[j]`` the positions of
    ``seqs[j]`` whose next-token logits are returned ([n_j, V] float32)."""
    c = W.c
    dev = W.embed.device
    xs = [W.embed[torch.tensor(s, device=dev)].float()[None] for s in seqs]
    pos = [torch.arange(len(s), device=dev)[None] for s in seqs]
    allows = [causal_allow(p) for p in pos]
    for i in range(c["num_hidden_layers"]):
        lw = W.layer(i)
        xs = [layer_forward(x, lw, c, p, a, prec)
              for x, p, a in zip(xs, pos, allows)]
    return [logits(x[0, torch.tensor(w, device=dev)], W, prec)
            for x, w in zip(xs, wanted)]
