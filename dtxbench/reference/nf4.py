"""NormalFloat4 with double quantization, as QLoRA defines it, worked out
again from the full-precision weights: 64-element blocks along each output
channel's input dimension, each scaled by its absolute maximum and
snapped to the nearest of 16 normal quantiles; the block scales stored as
int8 against one per-tensor scale. ``dequant`` gives the weight the
quantized base stands for, in float32."""

from __future__ import annotations

import torch

BLOCK = 64
CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def quantize(w: torch.Tensor) -> tuple:
    """w [in, out] → (codes uint8 [out, in], block scales f32
    [out, in / 64])."""
    d_in, d_out = w.shape
    blocks = w.float().t().reshape(d_out, d_in // BLOCK, BLOCK)
    absmax = blocks.abs().amax(dim=-1).clamp(min=1e-12)
    code = torch.tensor(CODE, dtype=torch.float32, device=w.device)
    mids = (code[1:] + code[:-1]) / 2
    idx = torch.searchsorted(mids, (blocks / absmax[..., None]).contiguous())
    meta = (absmax.max() / 127.0).clamp(min=1e-12)
    scale = torch.clamp(torch.round(absmax / meta), 1, 127) * meta
    return idx.to(torch.uint8).reshape(d_out, d_in), scale


def dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(codes, scales) → the float32 weight [in, out]."""
    d_out, d_in = codes.shape
    code = torch.tensor(CODE, dtype=torch.float32, device=codes.device)
    w = code[codes.long()].reshape(d_out, d_in // BLOCK, BLOCK)
    return (w * scale[..., None]).reshape(d_out, d_in).t()
