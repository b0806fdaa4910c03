"""Fused quantized matmuls (int8 w8a16, nf4 QLoRA): the port of
``datatunerx_tpu/ops/pallas_quant.py``.

K4 (``nf4_matmul``: ``x @ dequant_nf4(W)``), K5 (``nf4_matmul_t``:
``g @ dequant_nf4(W)ᵀ``, the dx product of the backward, with W kept packed)
and K6 (``int8_matmul``: ``(x @ q) * scale``) are hand-written CUDA: in bf16
TMA + ``wgmma`` kernels (K4/K5 in ``csrc/nf4_gemm.cu``, K6 in
``csrc/int8_gemm.cu``; their TMA descriptors are encoded per call), in f32
``csrc/quant.cu``'s CUDA-core skeleton. The design notes there say what
bounds them. Each
wrapper launches its kernel for CUDA tensors (or raises) and runs the
kernel's plain PyTorch version — dequantize, then one f32-accumulated
``torch.matmul``, in the reference's rounding order — only for CPU tensors.
``<wrapper>.launches`` counts kernel launches.

``cuda_matmul_nf4`` and ``cuda_matmul_int8`` are the differentiable entry
points (two ``torch.autograd.Function``s in place of the reference's
``custom_vjp``s): nf4's backward is K5; int8's backward is
``dx = ((g·scale) → g.dtype) @ q.to(g.dtype)ᵀ`` in ``torch.matmul``, a
product the reference also leaves outside its kernels. The quantized base
is frozen: neither returns a gradient for ``packed``, ``scale_q``,
``meta``, ``q`` or ``scale``, and dx is computed only when the input needs
it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from datatunerx_tpu_torch.ops import _build
from datatunerx_tpu_torch.ops.quant import (
    NF4_BLOCK,
    _product,
    dequant_nf4,
    matmul_int8,
    matmul_nf4,
)

_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


# ------------------------------------------------------------------- plain
def _plain_nf4_t(g: torch.Tensor, qw: Dict[str, torch.Tensor],
                 shape: Tuple[int, int]) -> torch.Tensor:
    """K5's plain version: g [..., N] @ Wᵀ → [..., K], W rounded to
    g.dtype."""
    return _product(g, dequant_nf4(qw, shape, dtype=g.dtype).T)


# ----------------------------------------------------------------- wrappers
_require, _operand, _stream = _build.require, _build.operand, _build.stream


def _rows(x: torch.Tensor, width: int, name: str) -> torch.Tensor:
    """[..., width] → the kernels' [M, width] activation operand."""
    _require(x.device.type == "cuda",
             f"quantized matmul kernels run on CUDA tensors, got {x.device}")
    _require(x.dtype in _KERNEL_DTYPES,
             f"quantized matmul kernels take bf16/f32, got {x.dtype}")
    _require(x.shape[-1] == width,
             f"{name} last dim {x.shape[-1]} != {width}")
    _require(width % 8 == 0,
             f"{name} width {width} is not a multiple of 8 (16-byte rows)")
    return _operand(x.reshape(-1, width), name, x.dtype, x.device)


def _nf4_operands(qw, shape, device):
    K, N = shape
    _require(K % NF4_BLOCK == 0, f"nf4 needs K % {NF4_BLOCK} == 0, got {K}")
    nb = N * K // NF4_BLOCK
    packed = qw["packed"].reshape(-1, NF4_BLOCK // 2)
    _require(tuple(packed.shape) == (nb, NF4_BLOCK // 2)
             and qw["scale_q"].numel() == nb,
             f"nf4 W {shape} needs packed [{nb}, 32] and scale_q [{nb}], got "
             f"{tuple(qw['packed'].shape)} and {tuple(qw['scale_q'].shape)}")
    return (_operand(packed, "packed", torch.uint8, device),
            _operand(qw["scale_q"], "scale_q", torch.int8, device, False),
            _operand(qw["meta"], "meta", torch.float32, device, False))


def nf4_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor],
               shape: Tuple[int, int]) -> torch.Tensor:
    """K4: x [..., K] @ dequant_nf4(W) [K, N] → [..., N] in x.dtype."""
    if x.device.type == "cpu":
        return matmul_nf4(x, qw, shape)
    K, N = shape
    x2 = _rows(x, K, "x")
    _require(x.dtype != torch.bfloat16 or N % 8 == 0,
             f"bf16 nf4 output width {N} is not a multiple of 8 (16-byte "
             "rows)")
    packed, scale_q, meta = _nf4_operands(qw, shape, x.device)
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    fn = getattr(_build.library(), f"dtx_nf4_matmul_{_KERNEL_DTYPES[x.dtype]}")
    code = fn(x2.data_ptr(), packed.data_ptr(), scale_q.data_ptr(),
              meta.data_ptr(), out.data_ptr(), x2.shape[0], K, N, _stream(x))
    _build.check(code, "nf4 matmul kernel (K4)")
    nf4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


nf4_matmul.launches = 0


def nf4_matmul_t(g: torch.Tensor, qw: Dict[str, torch.Tensor],
                 shape: Tuple[int, int]) -> torch.Tensor:
    """K5: g [..., N] @ dequant_nf4(W)ᵀ [N, K] → [..., K] in g.dtype, from
    the same packed bytes (W is never materialised)."""
    if g.device.type == "cpu":
        return _plain_nf4_t(g, qw, shape)
    K, N = shape
    g2 = _rows(g, N, "g")
    packed, scale_q, meta = _nf4_operands(qw, shape, g.device)
    dx = torch.empty((g2.shape[0], K), dtype=g.dtype, device=g.device)
    fn = getattr(_build.library(),
                 f"dtx_nf4_matmul_t_{_KERNEL_DTYPES[g.dtype]}")
    code = fn(g2.data_ptr(), packed.data_ptr(), scale_q.data_ptr(),
              meta.data_ptr(), dx.data_ptr(), g2.shape[0], K, N, _stream(g))
    _build.check(code, "nf4 transposed matmul kernel (K5)")
    nf4_matmul_t.launches += 1
    return dx.reshape(*g.shape[:-1], K)


nf4_matmul_t.launches = 0


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K6: (x [..., K] @ q [K, N]) * scale [N] → [..., N] in x.dtype."""
    if x.device.type == "cpu":
        return matmul_int8(x, q, scale)
    K, N = q.shape
    _require(N % 16 == 0, f"int8 W needs N % 16 == 0 (16-byte rows), got {N}")
    _require(tuple(scale.shape) == (N,),
             f"scale must be [{N}], got {tuple(scale.shape)}")
    x2 = _rows(x, K, "x")
    q = _operand(q, "q", torch.int8, x.device)
    scale = _operand(scale, "scale", torch.float32, x.device, False)
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    fn = getattr(_build.library(),
                 f"dtx_int8_matmul_{_KERNEL_DTYPES[x.dtype]}")
    code = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
              x2.shape[0], K, N, _stream(x))
    _build.check(code, "int8 matmul kernel (K6)")
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0


# ------------------------------------------------------------ autograd
class _Nf4Matmul(torch.autograd.Function):
    """K4 forward; K5 backward (the reference's ``_nf4_mm`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, packed, scale_q, meta, shape):
        ctx.save_for_backward(packed, scale_q, meta)
        ctx.shape = shape
        return nf4_matmul(x, {"packed": packed, "scale_q": scale_q,
                              "meta": meta}, shape)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            packed, scale_q, meta = ctx.saved_tensors
            dx = nf4_matmul_t(g, {"packed": packed, "scale_q": scale_q,
                                  "meta": meta}, ctx.shape)
        return dx, None, None, None, None


class _Int8Matmul(torch.autograd.Function):
    """K6 forward; a plain dx product backward (the reference's
    ``_int8_mm`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return int8_matmul(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            q, scale = ctx.saved_tensors
            gs = (g.float() * scale.float()).to(g.dtype)
            dx = torch.matmul(gs, q.to(g.dtype).T)
        return dx, None, None


def cuda_matmul_nf4(x: torch.Tensor, qw: Dict[str, torch.Tensor],
                    shape: Tuple[int, int]) -> torch.Tensor:
    """Differentiable x @ W for a frozen nf4 W (``pallas_matmul_nf4``)."""
    return _Nf4Matmul.apply(x, qw["packed"], qw["scale_q"], qw["meta"],
                            tuple(shape))


def cuda_matmul_int8(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Differentiable x @ q * scale for a frozen int8 W
    (``pallas_matmul_int8``)."""
    return _Int8Matmul.apply(x, q, scale)
