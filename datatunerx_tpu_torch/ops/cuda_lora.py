"""Fused LoRA matmul ``y = x·W + (x·A)·B·scale`` in one kernel: the port of
``datatunerx_tpu/ops/pallas_lora.py``.

K10 (``lora_matmul``) is hand-written CUDA in two designs, picked by
``_route(M, N, dtype)``:

- ``"split"`` — few rows (a decode step), bf16 and f32: ``csrc/lora.cu``'s
  split over K, each output-column tile's splits one thread-block cluster
  that merges its partials in split order (``_split_plan`` picks the splits
  and the tile width from the card's SM count, and only a plan whose shared
  memory fits a block);
- ``"gemm"`` — many bf16 rows: ``csrc/lora_gemm.cu``, TMA + ``wgmma``, the
  xa strip as a narrow ``wgmma`` on the staged x tile and the rank product
  as a register-sourced one in the epilogue (it takes Aᵀ, which the wrapper
  makes, and K, N multiples of 8, which the wrapper pads to with zeros);
- ``"tiles"`` — many f32 rows: ``csrc/lora.cu``'s CUDA-core tile kernel.

The design notes there say what bounds each. The adapter delta ``[M, N]``
and the strip ``x·A`` ``[M, r]`` never reach device memory.

The arithmetic is the reference kernel's: W, A and B are cast to x's dtype;
``x·W`` and ``xa = x·A`` accumulate in f32; ``xa`` rounds once to x's dtype;
``xa·B`` accumulates in f32 and is scaled in f32; the sum rounds once to x's
dtype. ``lora_matmul`` launches a kernel for CUDA tensors (or raises) and
runs ``_plain_lora_matmul`` — the same rounding points on f32 matmuls — only
for CPU tensors. ``lora_matmul.launches`` counts kernel launches and
``lora_matmul.last`` holds the last launch's ``(route, splits, column
vectors)`` (the last two None off the split kernel).

As in the reference, the function carries no gradient and no model path
calls it: ``models/llama._proj`` keeps the composite LoRA branch for
training and serving.
"""

from __future__ import annotations

import torch

from datatunerx_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
MAX_RANK = 64  # the kernels' rank strip lives in registers
MAX_SPLITS = 16  # blocks a cluster (above 8 non-portable)
# dynamic shared bytes a split block may take (lora.cu's SPLIT_SMEM_MAX)
SPLIT_SMEM_MAX = 232448 - 1024


def _split_rows(N: int, dtype: torch.dtype) -> int:
    """The most rows of N outputs in ``dtype`` that go to the split kernel,
    as measured on the H100 at K = 2048, r = 8 (PERF.md §6): the wgmma
    kernel's time is flat at these row counts (its few row tiles stream all
    of W), the split kernel's grows with M x N, so it keeps up to 16 rows of
    a narrow W (N <= 1024) and 4 of a wide one; f32 rows up to 32 (the f32
    tile kernel takes 0.30 ms at any row count up to 128)."""
    if dtype != torch.bfloat16:
        return 32
    return 16 if N <= 1024 else 4


def _split_smem(M: int, K: int, r: int, S: int, bn: int, tsize: int) -> int:
    """Dynamic shared bytes of a split block: ``csrc/lora.cu``'s
    ``SplitSmem`` (W's piece in whole TMA boxes of up to 256 rows, then f32
    slices of x, A and B, the xa partials, every split's xa and output
    partials and the warps' partials)."""
    mg, threads, warps = 4, 256, 8
    mp, ks, mr = -(-M // mg) * mg, -(-K // S), M * r
    kp = threads // mr if mr < threads else 1
    boxr = min(ks, 256)
    wbytes = -(-ks // boxr) * boxr * bn * tsize
    floats = (mp * ks + ks * r + r * bn + kp * mr + S * mr
              + S * -(-(M * bn) // S) + warps * mg * bn)
    return wbytes + 4 * floats


def _split_plan(M: int, K: int, N: int, r: int, dtype: torch.dtype,
                sms: int):
    """(splits S, column vectors CV) of the split kernel for N (a multiple
    of 16 bytes) outputs, or None when no plan fits a block's shared memory.
    As measured best on the H100 at q_proj and v_proj: a split per 128 rows
    of W up to a 16-block cluster; a tile of CV 16-byte column vectors
    halved from 16 only while the grid has fewer than 64 blocks (narrower
    tiles cost more in shuffles than the extra blocks gain); splits halved
    while the grid has more than two blocks an SM (a second wave) and the
    halved plan still fits."""
    size = dtype.itemsize
    vec = 16 // size

    def fits(S, cv):
        return _split_smem(M, K, r, S, cv * vec, size) <= SPLIT_SMEM_MAX

    splits = max(1, min(MAX_SPLITS, -(-K // 128)))
    cv = 16
    while cv > 1 and -(-N // (cv * vec)) * splits < 64:
        cv //= 2
    while (splits > 1 and -(-N // (cv * vec)) * splits > 2 * sms
           and fits(splits // 2, cv)):
        splits //= 2
    return (splits, cv) if fits(splits, cv) else None


def _route(M: int, K: int, N: int, r: int, dtype: torch.dtype, sms: int):
    """Which K10 kernel takes ``M`` rows of ``x [M, K] · W [K, N]`` at rank
    ``r`` in ``dtype`` on a card of ``sms`` SMs: ``("split", S, CV)`` for few
    rows whose split plan fits, else ``("gemm", None, None)`` for bf16 and
    ``("tiles", None, None)`` for f32."""
    if M <= _split_rows(N, dtype):
        vec = 16 // dtype.itemsize
        plan = _split_plan(M, K, -(-N // vec) * vec, r, dtype, sms)
        if plan is not None:
            return ("split", *plan)
    return ("gemm" if dtype == torch.bfloat16 else "tiles", None, None)


def _pad(t: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """``t`` with zeros appended along ``dim`` up to a multiple of
    ``mult`` (zero rows of K add nothing; zero columns of N are cut off)."""
    extra = -t.shape[dim] % mult
    if not extra:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return torch.nn.functional.pad(t, pad)

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
    M, dev, dt = x2.shape[0], x.device, x.dtype
    route, splits, cv = _route(
        M, K, N, r, dt,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _build.library()
    if route == "split":
        vec = 16 // x.element_size()
        w, b = _pad(w, 1, vec), _pad(b, 1, vec)
        Np = w.shape[1]
        args = (_operand(x2, "x", dt, dev, False), _operand(w, "W", dt, dev),
                _operand(a, "A", dt, dev, False),
                _operand(b, "B", dt, dev, False))
        out = torch.empty((M, Np), dtype=dt, device=dev)
        code = getattr(lib, f"dtx_lora_split_{_KERNEL_DTYPES[dt]}")(
            *(t.data_ptr() for t in args), out.data_ptr(), M, K, Np, r,
            float(scale), splits, cv, _stream(x))
    elif route == "gemm":
        x2, w, a = _pad(x2, 1, 8), _pad(w, 0, 8), _pad(a, 0, 8)
        w, b = _pad(w, 1, 8), _pad(b, 1, 8)
        Kp, Np = w.shape
        args = (_operand(x2, "x", dt, dev), _operand(w, "W", dt, dev),
                _operand(a.t(), "Aᵀ", dt, dev), _operand(b, "B", dt, dev))
        out = torch.empty((M, Np), dtype=dt, device=dev)
        code = lib.dtx_lora_gemm_bf16(
            *(t.data_ptr() for t in args), out.data_ptr(), M, Kp, Np, r,
            float(scale), _stream(x))
    else:
        args = (_operand(x2, "x", dt, dev), _operand(w, "W", dt, dev),
                _operand(a, "A", dt, dev, False),
                _operand(b, "B", dt, dev, False))
        out = torch.empty((M, N), dtype=dt, device=dev)
        code = lib.dtx_lora_matmul_f32(
            *(t.data_ptr() for t in args), out.data_ptr(), M, K, N, r,
            float(scale), _stream(x))
    _build.check(code, f"fused LoRA matmul kernel (K10, {route})")
    lora_matmul.launches += 1
    lora_matmul.last = (route, splits, cv)
    return out[:, :N].reshape(*x.shape[:-1], N)


lora_matmul.launches = 0
lora_matmul.last = None  # (route, splits, column vectors), last launch
