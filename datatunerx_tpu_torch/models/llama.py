"""Llama-family decoder (Llama-2, Mistral, Qwen1.5) in PyTorch: the port of
``datatunerx_tpu/models/llama.py``.

Params are a plain nested dict of tensors with the reference's stacked
leaf names, so the weights of either package load into the other without
remapping (``models/convert.params_from_jax``):

  embed_tokens.embedding [V, D]
  layers.{input_layernorm,post_attention_layernorm}.scale [L, D]
  layers.{q,k,v,o}_proj.kernel  [L, in, out] (+ .bias for Qwen q/k/v)
  layers.{gate,up,down}_proj.kernel
  norm.scale [D];  lm_head.kernel [D, V] (absent when tied)

A Python loop over layers replaces the reference's ``lax.scan``. The paged
cache is updated IN PLACE (the JAX forward returns new pools): the pos pool
and each layer's K/V pools are written with ``index_put_``, and the returned
cache dict shares those tensors. This slice carries the base-weight path of
``_proj``; LoRA, quantized weights, dropout and NEFTune come with the
training slices.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.ops.attention import (
    attention_allow,
    cache_positions_update,
    kv_cache_update,
    kv_cache_width,
    kv_cache_write_paged,
    make_causal_bias,
    xla_attention,
)
from datatunerx_tpu_torch.ops.cuda_paged_attention import (
    paged_attention_decode_step,
    paged_attention_multitoken_step,
)
from datatunerx_tpu_torch.ops.paged_attention import write_targets
from datatunerx_tpu_torch.ops.rope import (
    apply_rope_tables,
    rope_cos_sin,
    rope_tables,
)

Params = Any  # nested dict of tensors


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 normalisation, cast back to x.dtype (as the reference)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cpu") -> Params:
    """Random init from a seeded ``torch.Generator`` on ``device``: normal
    with std 0.02 for every matrix, ones for the norm scales (the reference's
    scheme; the draws themselves differ from jax.random's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, scale=0.02):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "input_layernorm": {"scale": ones((L, D))},
        "post_attention_layernorm": {"scale": ones((L, D))},
        "q_proj": {"kernel": dense((L, D, cfg.q_dim))},
        "k_proj": {"kernel": dense((L, D, cfg.kv_dim))},
        "v_proj": {"kernel": dense((L, D, cfg.kv_dim))},
        "o_proj": {"kernel": dense((L, cfg.q_dim, D))},
        "gate_proj": {"kernel": dense((L, D, F))},
        "up_proj": {"kernel": dense((L, D, F))},
        "down_proj": {"kernel": dense((L, F, D))},
    }
    if cfg.attention_bias:
        for name, width in (("q_proj", cfg.q_dim), ("k_proj", cfg.kv_dim),
                            ("v_proj", cfg.kv_dim)):
            layers[name]["bias"] = torch.zeros((L, width), dtype=dtype,
                                               device=device)
    params = {
        "embed_tokens": {"embedding": dense((cfg.vocab_size, D))},
        "layers": layers,
        "norm": {"scale": ones((D,))},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense((D, cfg.vocab_size))}
    return params


def _proj(h: torch.Tensor, p: dict) -> torch.Tensor:
    """Dense projection: ``h W (+ b)`` in h's dtype."""
    out = h @ p["kernel"].to(h.dtype)
    if "bias" in p:
        out = out + p["bias"].to(h.dtype)
    return out


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm hidden states → vocabulary logits, computed in x's dtype and
    upcast to float32 (so bf16 serving logits are bf16-rounded)."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = x @ params["embed_tokens"]["embedding"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(x.dtype)
    return logits.to(torch.float32)


def _layer(params: Params, i: int) -> dict:
    """Layer i's leaves, peeled off the stacked [L, ...] tree."""
    return {name: {leaf: t[i] for leaf, t in sub.items()}
            for name, sub in params["layers"].items()}


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, T]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid, 0=pad
    cache: Optional[dict] = None,
    compute_dtype=None,
):
    """Returns (logits [B, T, V] float32, new_cache | None).

    Dispatch follows the reference: over a paged cache with
    ``cfg.paged_kernel``, single-token steps take the paged decode kernel
    (K7) and multi-token steps the multi-token kernel (K8) with the
    ``attention_allow`` mask operand; with ``paged_kernel`` False they take
    the biased gather path (the kernels' oracle). Without a cache, plain
    causal attention."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP Queue 1, "
            "forward pass)")
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, T)

    x = params["embed_tokens"]["embedding"][tokens.long()]
    if compute_dtype is not None:
        x = x.to(compute_dtype)

    seq_len = T if cache is None else kv_cache_width(cache)
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, theta=cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type,
        scaling_factor=cfg.rope_scaling_factor,
        max_seq_len=cfg.max_seq_len, seq_len=seq_len)
    # built once, used by every layer (the per-layer op count bounds decode)
    rope_cc, rope_ss = rope_tables(cos, sin, x.dtype)

    paged = (cache is not None and "block_tables" in cache
             and getattr(cfg, "paged_kernel", False))
    paged_kernel = paged and T == 1
    paged_kernel_mt = paged and not paged_kernel
    targets = None
    if cache is None:
        kv_positions = positions
        kv_valid = (attention_mask.to(torch.bool)
                    if attention_mask is not None else None)
        cache_pos = None
    else:
        # record each new token's rope position in the pos pool (in place);
        # pads get the sentinel. The decode kernel masks the pool through
        # the tables, so it needs no gathered view. The write targets serve
        # every layer's K/V pools too.
        targets = write_targets(cache, T)
        cache_pos, kv_positions = cache_positions_update(
            cache, positions, attention_mask, gather=not paged_kernel,
            targets=targets)
        kv_valid = None
    bias = allow = None
    if paged_kernel_mt:
        allow = attention_allow(positions, kv_positions, kv_valid)
    elif not paged_kernel:
        bias = make_causal_bias(positions, kv_positions, kv_valid)

    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_layernorm"]["scale"], cfg.rms_norm_eps)
        q = _proj(h, lp["q_proj"]).reshape(B, T, H, d)
        k = _proj(h, lp["k_proj"]).reshape(B, T, KV, d)
        v = _proj(h, lp["v_proj"]).reshape(B, T, KV, d)
        q = apply_rope_tables(q, rope_cc, rope_ss)
        k = apply_rope_tables(k, rope_cc, rope_ss)

        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        if cache is not None and paged_kernel:
            kv_cache_write_paged(cache, ck, cv, k, v, targets)
            attn = paged_attention_decode_step(
                q, ck, cv, None, None, cache, cache_pos, positions)
        elif cache is not None and paged_kernel_mt:
            kv_cache_write_paged(cache, ck, cv, k, v, targets)
            attn = paged_attention_multitoken_step(
                q, ck, cv, None, None, cache, allow)
        else:
            if cache is not None:
                _, _, k_att, v_att = kv_cache_update(cache, ck, cv, k, v,
                                                     targets)
            else:
                k_att, v_att = k, v
            attn = xla_attention(q, k_att, v_att, bias)
        x = x + _proj(attn.reshape(B, T, cfg.q_dim), lp["o_proj"])

        h = rms_norm(x, lp["post_attention_layernorm"]["scale"],
                     cfg.rms_norm_eps)
        gate = _proj(h, lp["gate_proj"])
        up = _proj(h, lp["up_proj"])
        # silu as the reference spells it (x * sigmoid(x), rounded per op)
        x = x + _proj(gate * torch.sigmoid(gate) * up, lp["down_proj"])

    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = lm_logits(params, x, cfg)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + T
        new_cache["pos"] = cache_pos
    return logits, new_cache
