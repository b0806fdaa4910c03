"""Fused LoRA matmul ``y = x·W + (x·A)·B·scale`` in one kernel: the port of
``datatunerx_tpu/ops/pallas_lora.py``.

K10 (``lora_matmul``) is hand-written CUDA in ``csrc/lora.cu``; the design
note there says what bounds it and how a thread block carries the base tile
and the rank-r strip through one loop over K. The adapter delta ``[M, N]``
and the strip ``x·A`` ``[M, r]`` never reach device memory.

The arithmetic is the reference kernel's: W, A and B are cast to x's dtype;
``x·W`` and ``xa = x·A`` accumulate in f32; ``xa`` rounds once to x's dtype;
``xa·B`` accumulates in f32 and is scaled in f32; the sum rounds once to x's
dtype. ``lora_matmul`` launches the kernel for CUDA tensors (or raises) and
runs ``_plain_lora_matmul`` — the same rounding points on f32 matmuls — only
for CPU tensors. ``lora_matmul.launches`` counts kernel launches.

As in the reference, the function carries no gradient and no model path
calls it: ``models/llama._proj`` keeps the composite LoRA branch for
training and serving.
"""

from __future__ import annotations

import torch

from datatunerx_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
MAX_RANK = 64  # the kernel's rank strip lives in registers

_require, _operand, _stream = _build.require, _build.operand, _build.stream


def _plain_lora_matmul(x2: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, scale: float) -> torch.Tensor:
    """K10's plain version on rows ``x2 [M, K]``: operands already in x's
    dtype, f32 products, xa rounded through x's dtype, one final rounding."""
    xf = x2.to(torch.float32)
    acc = xf @ w.to(torch.float32)
    xa = (xf @ a.to(torch.float32)).to(x2.dtype)
    acc = acc + (xa.to(torch.float32) @ b.to(torch.float32)) * scale
    return acc.to(x2.dtype)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """K10: x ``[..., K]``, W ``[K, N]``, A ``[K, r]``, B ``[r, N]`` (r ≤ 64)
    → ``[..., N]`` in x's dtype."""
    K, N = w.shape
    r = a.shape[1]
    _require(x.shape[-1] == K and tuple(a.shape) == (K, r)
             and tuple(b.shape) == (r, N),
             f"lora_matmul shapes do not fit: x {tuple(x.shape)}, W "
             f"{tuple(w.shape)}, A {tuple(a.shape)}, B {tuple(b.shape)}")
    _require(1 <= r <= MAX_RANK, f"LoRA rank {r} is outside 1..{MAX_RANK}")
    _require(K >= 1, "lora_matmul needs K >= 1")
    for name, t in (("W", w), ("A", a), ("B", b)):
        _require(t.device == x.device,
                 f"{name} must be on {x.device}, got {t.device}")
    w, a, b = (t.to(x.dtype) for t in (w, a, b))
    x2 = x.reshape(-1, K)
    if x.device.type == "cpu":
        return _plain_lora_matmul(x2, w, a, b, float(scale)).reshape(
            *x.shape[:-1], N)
    _require(x.device.type == "cuda",
             f"the LoRA matmul kernel runs on CUDA tensors, got {x.device}")
    _require(x.dtype in _KERNEL_DTYPES,
             f"the LoRA matmul kernel takes bf16/f32, got {x.dtype}")
    x2 = _operand(x2, "x", x.dtype, x.device)
    w = _operand(w, "W", x.dtype, x.device)
    a = _operand(a, "A", x.dtype, x.device, False)
    b = _operand(b, "B", x.dtype, x.device, False)
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    fn = getattr(_build.library(),
                 f"dtx_lora_matmul_{_KERNEL_DTYPES[x.dtype]}")
    code = fn(x2.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
              out.data_ptr(), x2.shape[0], K, N, r, float(scale), _stream(x))
    _build.check(code, "fused LoRA matmul kernel (K10)")
    lora_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


lora_matmul.launches = 0
