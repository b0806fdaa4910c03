"""Fused sampling epilogue for the decode path: the port of
``datatunerx_tpu/ops/pallas_sampling.py``.

The decode step consumes the unembed output where it lives and emits just
the ``[S]`` token ids, in three static per-batch modes:

  greedy — argmax (first maximum wins).
  simple — temperature sampling with ``top_p == 1`` for every sampled row:
           inverse CDF over ``softmax(logits / max(t, 1e-6))``.
  topp   — the exact nucleus path; needs a full-vocab sort, so it stays
           plain PyTorch, as it stays XLA in the reference.

K9 (greedy and simple) is hand-written CUDA in ``csrc/sampling.cu``.
``kernel_sample`` launches it for CUDA tensors (or raises) and runs its
plain version ``_plain_sample`` — the twin of the reference's
``_xla_sample``, the same tile walk — only for CPU tensors.
``kernel_sample.launches`` counts kernel launches.

Randomness: the reference splits JAX threefry keys per slot; the port cannot
reproduce those bits. Every mode takes the per-row uniforms ``us [S]`` as an
operand instead (the engine draws them from each slot's own seeded
``torch.Generator``), so tests hand both implementations the same numbers.
Sampled streams therefore differ from the JAX engine's; greedy ones match.
"""

from __future__ import annotations

import torch

from datatunerx_tpu_torch.ops import _build
from datatunerx_tpu_torch.ops._build import pick_block_n

NEG_INF = -1e30
_BLOCK_CAP = 512

MODES = ("greedy", "simple", "topp")


def _prep(logits, temps, *, mode):
    """Shared pre-scale + lane-pad: kernel and plain version consume the SAME
    padded f32 array. Padding is NEG_INF *after* scaling — dead lanes lose
    every argmax and add ``exp(NEG_INF - m) == 0`` to the sums."""
    x = logits.to(torch.float32)
    if mode != "greedy":
        x = x / temps.to(torch.float32).clamp(min=1e-6)[:, None]
    v = x.shape[-1]
    vp = -(-v // 128) * 128
    if vp != v:
        x = torch.nn.functional.pad(x, (0, vp - v), value=NEG_INF)
    return x.contiguous(), pick_block_n(vp, _BLOCK_CAP)


def _plain_sample(x, temps, us, *, bn, greedy):
    """K9's plain version: the reference's blocked tile walk verbatim
    (bn-wide tiles, sequential carries, first-max-wins and first-crossing
    tie rules)."""
    s, vp = x.shape
    nt = vp // bn
    lane = torch.arange(bn, device=x.device)[None, :]
    big = torch.full_like(lane, bn)
    m = torch.full((s,), NEG_INF, dtype=torch.float32, device=x.device)
    idx = torch.zeros((s,), dtype=torch.int64, device=x.device)
    for t in range(nt):
        tile = x[:, t * bn:(t + 1) * bn]
        tmax = tile.amax(dim=1)
        targ = torch.where(tile == tmax[:, None], lane, big).amin(dim=1)
        better = tmax > m
        idx = torch.where(better, t * bn + targ, idx)
        m = torch.where(better, tmax, m)
    if greedy:
        return idx.to(torch.int32)
    z = torch.zeros((s,), dtype=torch.float32, device=x.device)
    for t in range(nt):
        tile = x[:, t * bn:(t + 1) * bn]
        z = z + torch.exp(tile - m[:, None]).sum(dim=1)
    thresh = us.to(torch.float32) * z
    c = torch.zeros((s,), dtype=torch.float32, device=x.device)
    token = torch.zeros((s,), dtype=torch.int64, device=x.device)
    found = torch.zeros((s,), dtype=torch.bool, device=x.device)
    for t in range(nt):
        tile = x[:, t * bn:(t + 1) * bn]
        e = torch.exp(tile - m[:, None])
        cum = c[:, None] + torch.cumsum(e, dim=1)
        hit = cum > thresh[:, None]
        first = torch.where(hit, lane, big).amin(dim=1)
        got = first < bn
        token = torch.where(got & ~found, t * bn + first, token)
        found = found | got
        c = c + e.sum(dim=1)
    sampled = torch.where(found, token, idx)
    return torch.where(temps.to(torch.float32) <= 0.0, idx,
                       sampled).to(torch.int32)


def kernel_sample(x, temps, us, *, greedy: bool):
    """K9 over prepped ``x [S, Vp]`` f32 (``_prep``'s output): token ids
    ``[S]`` int32. CPU tensors take the plain version."""
    s, vp = x.shape
    if x.device.type == "cpu":
        return _plain_sample(x, temps, us, bn=pick_block_n(vp, _BLOCK_CAP),
                             greedy=greedy)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"the sampling kernel takes CUDA f32 logits, got "
                         f"{x.device} {x.dtype}")
    if vp % 128:
        raise ValueError(f"padded vocab {vp} is not a multiple of 128")
    if tuple(temps.shape) != (s,) or (us is not None
                                     and tuple(us.shape) != (s,)):
        raise ValueError(f"temps and us must be [S={s}]")
    x = x.contiguous()
    temps = temps.to(device=x.device, dtype=torch.float32).contiguous()
    if us is None:
        us = torch.zeros((s,), dtype=torch.float32, device=x.device)
    us = us.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((s,), dtype=torch.int32, device=x.device)
    code = _build.library().dtx_fused_sample(
        x.data_ptr(), temps.data_ptr(), us.data_ptr(), out.data_ptr(),
        s, vp, int(bool(greedy)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "fused sampling kernel (K9)")
    kernel_sample.launches += 1
    return out


kernel_sample.launches = 0


def _topp_sample(logits, temps, top_ps, us):
    """The exact nucleus path: sorted-space inverse CDF over the truncated
    distribution (the reference's ``_topp_sample``, same tie order: an
    ascending stable sort, reversed)."""
    temps = temps.to(torch.float32)
    scaled = logits.to(torch.float32) / temps.clamp(min=1e-6)[:, None]
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    svals = torch.gather(scaled, -1, order)
    probs = torch.softmax(svals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_ps.to(torch.float32)[:, None]
    cut = (cum - probs > tp) & (tp < 1.0)
    probs = torch.where(cut, torch.zeros_like(probs), probs)
    total = probs.sum(dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    hit = cdf > (us.to(torch.float32) * total)[:, None]
    # all-False can only mean the float tail; argmax of a False row is 0,
    # the sorted-top token, which is always in the nucleus
    first = torch.argmax(hit.to(torch.int8), dim=-1)
    tok = torch.gather(order, -1, first[:, None])[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps <= 0.0, greedy, tok).to(torch.int32)


def fused_sample(logits, temps, top_ps, us, *, mode):
    """Sample one token per row from ``logits [S, V]``. ``mode`` is the
    static per-batch mode ("greedy" | "simple" | "topp"); ``us`` are the
    per-row uniforms ``[S]`` (ignored — may be None — for greedy). Returns
    token ids ``[S] int32``."""
    if mode not in MODES:
        raise ValueError(f"unknown sampling mode {mode!r} (want {MODES})")
    if mode == "greedy":
        x, _ = _prep(logits, temps, mode=mode)
        return kernel_sample(x, temps, None, greedy=True)
    if mode == "topp":
        return _topp_sample(logits, temps, top_ps, us)
    x, _ = _prep(logits, temps, mode=mode)
    return kernel_sample(x, temps, us, greedy=False)


def sample_rows(logits, temps, top_ps, us, *, mode):
    """The decode step's sampling call. The reference's ``sample_rows``
    splits one JAX key per row here; the port's engine draws each row's
    uniform from that slot's seeded generator instead and passes ``us``."""
    return fused_sample(logits, temps, top_ps, us, mode=mode)
