"""Rotary position embeddings with linear / dynamic-NTK scaling (the port of
``datatunerx_tpu/ops/rope.py``).

Convention: HF-llama "rotate half" — for x = [x1 | x2] split down the middle of
the head dim, rope(x) = [x1*cos - x2*sin | x2*cos + x1*sin]. The angles are
computed in float32 and cast to ``x.dtype`` before the rotation, as the
reference does.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope_cos_sin(
    positions: torch.Tensor,  # [B, T] int
    head_dim: int,
    *,
    theta: float = 10000.0,
    scaling_type: Optional[str] = None,
    scaling_factor: float = 1.0,
    max_seq_len: int = 4096,
    seq_len: Optional[int] = None,
    dtype=torch.float32,
):
    """Returns (cos, sin) each of shape [B, T, head_dim//2]."""
    half = head_dim // 2
    if scaling_type == "dynamic" and seq_len is not None and seq_len > max_seq_len:
        # Dynamic NTK: inflate the base theta as the window grows past training
        # length (same formula transformers uses for rope_scaling="dynamic").
        theta = theta * (
            (scaling_factor * seq_len / max_seq_len) - (scaling_factor - 1)
        ) ** (head_dim / (head_dim - 2))
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        exponent)
    pos = positions.to(torch.float32)
    if scaling_type == "linear":
        pos = pos / scaling_factor
    freqs = pos[..., None] * inv_freq  # [B, T, half]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rope_tables(cos: torch.Tensor, sin: torch.Tensor, dtype):
    """Per-call tables for ``apply_rope_tables``: ``[c | c]`` and
    ``[-s | s]`` as ``[B, T, 1, head_dim]`` in ``dtype``. A forward builds
    them once and reuses them in every layer."""
    c = cos[:, :, None, :].to(dtype)
    s = sin[:, :, None, :].to(dtype)
    return torch.cat([c, c], dim=-1), torch.cat([-s, s], dim=-1)


def apply_rope_tables(x: torch.Tensor, cc: torch.Tensor,
                      ss: torch.Tensor) -> torch.Tensor:
    """``[x1 | x2] * [c | c] + [x2 | x1] * [-s | s]``: the same products and
    sums as ``[x1*c - x2*s | x2*c + x1*s]``, rounded at the same points
    (negation is exact), in four ops."""
    half = x.shape[-1] // 2
    swapped = torch.cat([x[..., half:], x[..., :half]], dim=-1)
    return x * cc + swapped * ss


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, head_dim]; cos/sin: [B, T, head_dim//2], cast to
    x.dtype before the rotation."""
    return apply_rope_tables(x, *rope_tables(cos, sin, x.dtype))
