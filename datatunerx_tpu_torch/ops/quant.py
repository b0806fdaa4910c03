"""Weight quantization: int8 (per-channel) and int4-nf4 (per-block, QLoRA),
the port of ``datatunerx_tpu/ops/quant.py``.

Formats, byte for byte the JAX package's (a tree quantized by either
package loads into the other through ``models/convert.params_from_jax``):

- int8: symmetric per-output-channel absmax.
  ``{"q": int8 [in, out], "scale": f32 [out]}``
- nf4 (QLoRA): per-block (64) absmax-normalised weights snapped to the
  16-level NormalFloat4 codebook, channel-contiguous blocks (the block is
  ``w.T`` flattened), two nibbles per byte in the PLANAR layout: byte j of a
  block holds element j in its low nibble and element j + 32 in its high
  nibble. Double quantization: block scales stored int8 against a
  per-tensor meta scale.
  ``{"packed": uint8 [n_blocks, 32], "scale_q": int8 [n_blocks],
  "meta": f32 [2] = [per-tensor scale, nibble-layout version]}``

Stacked over layers (``quantize_model_params``) nf4 keeps ``packed`` as
flat bytes ``[L, n_blocks * 32]``; ``quantized_matmul`` reshapes one
layer's slice back to ``[n_blocks, 32]``.

``quantized_matmul(..., use_pallas=True)`` (``quant_impl="pallas"``, the
name kept so ``config.json`` stays interchangeable between the packages)
routes to the hand-written CUDA kernels of ``ops/cuda_quant.py`` (K4/K5 for
nf4, K6 for int8); ``use_pallas=False`` (``"xla"``) dequantizes and runs a
plain ``torch.matmul``, in the reference's rounding order: W rounded to the
input dtype, f32 accumulation, one rounding of the product.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

NF4_BLOCK = 64
NF4_LAYOUT_VERSION = 2  # 2 = planar nibble halves

# QLoRA NF4 codebook (16 quantiles of N(0,1), normalized to [-1, 1]).
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)
_NF4_MIDS = (NF4_CODE[1:] + NF4_CODE[:-1]) / np.float32(2.0)

QUANT_KERNELS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, rounded once to x.dtype (the
    reference's ``preferred_element_type=float32`` product)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


# ----------------------------------------------------------------- int8
def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w: [in, out] → per-out-channel symmetric int8."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[None, :]).to(dtype)


def matmul_int8(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: [..., in] @ int8 weights → [..., out]; the scale multiplies the
    f32 product, not W (int8 → x.dtype is exact)."""
    return (torch.matmul(x.float(), q.float()) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------ nf4
def _nearest_nf4(normed: torch.Tensor) -> torch.Tensor:
    """Nearest NF4 code index: searchsorted on the codebook midpoints (side
    left, as ``jnp.searchsorted``)."""
    mids = torch.from_numpy(_NF4_MIDS).to(normed.device)
    return torch.searchsorted(mids, normed.contiguous(), right=False,
                              out_int32=True)


def _pack_nf4(blocks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[n_blocks, block] f32 → packed planar nibbles, int8 block scales and
    the per-tensor meta."""
    absmax = torch.clamp(blocks.abs().amax(dim=1), min=1e-12)
    idx = _nearest_nf4(blocks / absmax[:, None])
    half = blocks.shape[1] // 2
    packed = (idx[:, :half] | (idx[:, half:] << 4)).to(torch.uint8)
    meta = torch.clamp(absmax.max() / 127.0, min=1e-12)
    scale_q = torch.clamp(torch.round(absmax / meta), 1, 127).to(torch.int8)
    meta = torch.stack([meta, torch.full_like(meta, NF4_LAYOUT_VERSION)])
    return {"packed": packed, "scale_q": scale_q, "meta": meta}


def quantize_nf4(w: torch.Tensor,
                 block_size: int = NF4_BLOCK) -> Dict[str, torch.Tensor]:
    """w: [in, out] → packed nf4 (channel-contiguous blocks: the tensor is
    transposed to [out, in] and flattened)."""
    in_dim, _ = w.shape
    if in_dim % block_size != 0:
        raise ValueError(
            f"nf4 requires in_dim % block_size == 0 (got {in_dim} % "
            f"{block_size}): blocks must not straddle output channels")
    return _pack_nf4(w.float().T.reshape(-1, block_size))


def nf4_scales(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    return qw["scale_q"].float() * qw["meta"][0]


def dequant_nf4(qw: Dict[str, torch.Tensor], shape: Tuple[int, int],
                dtype=torch.float32) -> torch.Tensor:
    in_dim, out_dim = shape
    packed = qw["packed"]
    idx = torch.cat([packed & 0x0F, packed >> 4], dim=-1).long()
    code = torch.from_numpy(NF4_CODE).to(packed.device)
    vals = code[idx] * nf4_scales(qw)[:, None]
    return vals.reshape(out_dim, in_dim).T.to(dtype)


def matmul_nf4(x: torch.Tensor, qw: Dict[str, torch.Tensor],
               shape: Tuple[int, int]) -> torch.Tensor:
    """Dequantize (W rounded to x.dtype), then one f32-accumulated product."""
    return _product(x, dequant_nf4(qw, shape, dtype=x.dtype))


# ------------------------------------------------------- param-tree level
def _quantize_int8_stacked(kern: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[L, in, out] → stacked int8, one layer at a time (the transient is
    one layer's f32 copy)."""
    per = [quantize_int8(kern[i]) for i in range(kern.shape[0])]
    return {k: torch.stack([p[k] for p in per]) for k in ("q", "scale")}


def _quantize_nf4_stacked(kern: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[L, in, out] → stacked planar-nibble nf4 (layerwise identical to
    quantize_nf4); ``packed`` is flat bytes per layer [L, nb * 32]."""
    per = [quantize_nf4(kern[i]) for i in range(kern.shape[0])]
    return {"packed": torch.stack([p["packed"].reshape(-1) for p in per]),
            "scale_q": torch.stack([p["scale_q"] for p in per]),
            "meta": torch.stack([p["meta"] for p in per])}


def quantize_model_params(params, mode: str):
    """Quantize the stacked [L, in, out] transformer kernels in-tree, on the
    params' device. Embeddings, norms and lm_head stay full-precision.
    int8 → q [L, in, out] + scale [L, out]; nf4 → packed [L, nb * 32] +
    scale_q [L, nb] + meta [L, 2]."""
    if mode not in ("int8", "int4", "nf4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    layers = dict(params["layers"])
    for name in QUANT_KERNELS:
        proj = dict(layers[name])
        kern = proj.pop("kernel")
        if mode == "int8":
            proj["quant"] = _quantize_int8_stacked(kern)
        else:  # quantize_nf4 refuses blocks that straddle channels
            proj["quant"] = _quantize_nf4_stacked(kern)
        layers[name] = proj
    out = dict(params)
    out["layers"] = layers
    return out


def dequantize_model_params(params, mode: str, dims_fn):
    """Inverse of quantize_model_params (for export): f32 kernels;
    ``dims_fn(name) -> (in, out)``."""
    layers = dict(params["layers"])
    for name in QUANT_KERNELS:
        proj = dict(layers[name])
        quant = proj.pop("quant")
        if mode == "int8":
            per = [dequant_int8(q, s) for q, s in zip(quant["q"],
                                                      quant["scale"])]
        else:
            nb = quant["scale_q"].shape[1]
            per = [dequant_nf4({"packed": p.reshape(nb, NF4_BLOCK // 2),
                                "scale_q": s, "meta": m}, dims_fn(name))
                   for p, s, m in zip(quant["packed"], quant["scale_q"],
                                      quant["meta"])]
        proj["kernel"] = torch.stack(per)
        layers[name] = proj
    out = dict(params)
    out["layers"] = layers
    return out


def quantized_matmul(x: torch.Tensor, quant: Dict[str, torch.Tensor],
                     mode: str, shape: Tuple[int, int],
                     use_pallas: bool = False) -> torch.Tensor:
    if mode == "int8":
        if use_pallas:
            from datatunerx_tpu_torch.ops.cuda_quant import cuda_matmul_int8

            return cuda_matmul_int8(x, quant["q"], quant["scale"])
        return matmul_int8(x, quant["q"], quant["scale"])
    if quant["packed"].dim() == 1:
        # layer slice of the stacked flat-byte layout → per-block view
        quant = dict(quant, packed=quant["packed"].reshape(
            quant["scale_q"].shape[0], NF4_BLOCK // 2))
    if use_pallas:
        from datatunerx_tpu_torch.ops.cuda_quant import cuda_matmul_nf4

        return cuda_matmul_nf4(x, quant, shape)
    return matmul_nf4(x, quant, shape)
