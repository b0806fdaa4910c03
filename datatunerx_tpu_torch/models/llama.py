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

A quantized tree (``ops/quant.quantize_model_params``) replaces each
projection's ``kernel`` with a ``quant`` collection (int8 ``q``/``scale`` or
nf4 ``packed``/``scale_q``/``meta``, stacked over layers).

A Python loop over layers replaces the reference's ``lax.scan``. The cache
(paged block pool or dense rows, ``init_cache``; bf16/f32 or int8 with
``k_scale``/``v_scale`` leaves) is updated IN PLACE (the JAX forward returns
new arrays): the position table and each layer's K/V leaves are written with
``index_put_``, and the returned cache dict shares those tensors.

Training (no cache): ``lora=(lora_params, scaling)`` adds ``(drop(h) A) B *
scaling`` inside each targeted projection; ``segment_ids`` confine packed
sequences; ``cfg.attention_impl == "flash"`` routes attention through the
K1-K3 kernels (``ops/flash_attention.py``) under the reference's condition;
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` (``full``) or a
selective checkpoint that saves only the 2-D projection matmuls (``dots``,
the counterpart of ``checkpoint_dots_with_no_batch_dims``: the flash
forward and the quantized-matmul kernels are recomputed in the backward
pass, as the Pallas calls are).
LoRA dropout masks and NEFTune noise come from the threefry twin
(``ops/cuda_prng.py``, one kernel launch a draw on the card) over the
reference's key chain: ``fold_in(dropout_rng, layer)``, then
``fold_in(·, projection)``, and ``fold_in(dropout_rng, 0x4EF)`` for the
noise. The keys evolve on the host; a checkpoint's recompute draws the
same bits, and they are ``jax.random``'s. Projections with a
``quant`` collection multiply through ``ops/quant.quantized_matmul``:
``cfg.quant_impl == "pallas"`` takes the K4/K5 (nf4) and K6 (int8)
kernels, ``"xla"`` dequantizes and runs a plain matmul. Dispatch keys on the
tree, not on ``cfg.quantization``, as the reference does: a QLoRA export
records ``quantization`` in its ``config.json`` and holds full kernels.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.lora import target_dims
from datatunerx_tpu_torch.ops.attention import (
    attention,
    attention_allow,
    cache_positions_update,
    cache_write_targets,
    kv_cache_update,
    kv_cache_width,
    kv_cache_write_paged,
    make_causal_bias,
)
from datatunerx_tpu_torch.ops import cuda_prng, prng
from datatunerx_tpu_torch.ops.cuda_paged_attention import (
    paged_attention_decode_step,
    paged_attention_multitoken_step,
)
from datatunerx_tpu_torch.ops.paged_attention import POS_SENTINEL
from datatunerx_tpu_torch.ops.quant import NF4_BLOCK, quantized_matmul
from datatunerx_tpu_torch.ops.rope import (
    apply_rope_tables,
    rope_cos_sin,
    rope_tables,
)
from datatunerx_tpu_torch.parallel.sharding import (
    all_gather_dim,
    copy_to_group,
    gather_dim,
    reduce_from_group,
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
    meta = torch.device(device).type == "meta"  # shapes only (memory.py)
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=dtype, device=device)
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, per_slot: bool = False,
               quantize: Optional[str] = None, device="cpu") -> dict:
    """Dense KV cache: ``k``/``v`` ``[L, batch, max_len, KV, d]``, ``pos``
    ``[batch, max_len]`` (the rope position of each written lane; the
    sentinel marks unwritten lanes and pads) and the write cursor ``len`` —
    a scalar, or ``[batch]`` with ``per_slot=True`` (continuous batching
    keeps rows at different depths in one decode step).
    ``quantize="int8"`` stores K/V as int8 with an f32 scale per head vector
    (``k_scale``/``v_scale`` ``[L, batch, max_len, KV]``), dequantized on
    read. The paged alternative is ``ops/paged_attention.init_paged_cache``;
    both serve the cache interface of ``ops/attention.py``."""
    L = cfg.num_layers
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "len": torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
        "pos": torch.full((batch, max_len), POS_SENTINEL, dtype=torch.int32,
                          device=device),
    }
    if quantize == "int8":
        dtype = torch.int8
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    elif quantize:
        raise ValueError(f"unsupported cache quantization {quantize!r}")
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


_KEEP_RATES: dict = {}


def _keep_rate(drop_rate: float, h: torch.Tensor) -> torch.Tensor:
    """``1 - drop_rate`` as a 0-d tensor of h's dtype on h's device, made
    once: a true division by it rounds as the reference's weakly typed
    scalar does (CUDA turns a host scalar divisor into a product with its
    reciprocal)."""
    key = (drop_rate, h.dtype, h.device)
    if key not in _KEEP_RATES:
        _KEEP_RATES[key] = torch.full((), 1.0 - drop_rate, dtype=h.dtype,
                                      device=h.device)
    return _KEEP_RATES[key]


def block_draw(draw, shape, local=None, width=None, col0: int = 0):
    """A [b, t, w] draw taken as this rank's block of the draw over the
    global array: rows by ``local``'s runs (``parallel/sharding.
    LocalSlice``), positions from its ``t0``, columns ``[col0, col0 + w)``
    of ``width``. ``draw(shape, index)`` makes one block. Without a slice
    and at full width it is the plain draw."""
    b, t, w = shape
    width = w if width is None else width
    if local is None and col0 == 0 and width == w:
        return draw(tuple(shape), None)
    rows = local.rows if local is not None else ((0, b, 0),)
    B = local.batch if local is not None else b
    T = local.seq if local is not None else t
    t0 = local.t0 if local is not None else 0
    parts = [draw((n, t, w), prng.slice_index((B, T, width), (g0, t0, col0)))
             for _, n, g0 in rows]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _proj(h: torch.Tensor, p: dict, lora_p: Optional[dict] = None,
          lora_scale=0.0, drop_key=None,
          drop_rate: float = 0.0, quant_mode: Optional[str] = None,
          dims: Optional[tuple] = None, use_pallas: bool = False,
          lora_idx: Optional[torch.Tensor] = None, drop_where=None,
          tp=None) -> torch.Tensor:
    """Dense projection with optional LoRA delta: ``h W (+ b) +
    (drop(h) A) B * scale`` in h's dtype. The base weight is a
    full-precision ``kernel`` or a frozen ``quant`` collection
    (``ops/quant.py``; QLoRA = quantized base + full-precision adapters),
    multiplied by ``quantized_matmul`` with W's ``dims`` (in, out).
    Dropout applies to the adapter branch input only (peft's
    ``lora_dropout``): ``drop_key`` (a host threefry key) draws
    ``bernoulli(1-p)`` over h's shape, and kept lanes divide by ``1-p``
    rounded to h's dtype, as the reference's weakly typed scalar is.

    Multi-adapter serving: with ``lora_idx`` ([B] integer), the adapter
    leaves are STACKED over adapters (``[E, d_in, r]`` / ``[E, r, d_out]``)
    and ``lora_scale`` is an ``[E]`` tensor; each batch row gathers its own
    adapter, so one decode step serves a mixed-adapter batch. Row 0 of a
    stack is the all-zero base adapter. The scale is rounded to h's dtype
    before the product on both branches, as the reference does.

    Tensor parallelism: ``tp = ("col" | "row", group)`` with this rank's
    shards of W (and of A/B, by ``parallel/sharding``'s rules). A column
    module takes the whole h (identity forward, all-reduce backward) and
    gives its output columns; its adapter runs ``x·A`` whole and enters
    ``·B`` through the same copy. A row module takes its input columns,
    and both its ``x·W`` and its adapter's ``x·A`` are summed over the
    group (all-reduce forward, identity backward) before ``+`` and ``·B``.
    ``drop_where = (local, width, col0)`` places h in the global array for
    the dropout draw (``block_draw``)."""
    mode, group = tp if tp is not None else (None, None)
    h_in = copy_to_group(h, group) if mode == "col" else h
    if "quant" in p:
        out = quantized_matmul(h_in, p["quant"], quant_mode, dims,
                               use_pallas=use_pallas)
    else:
        out = h_in @ p["kernel"].to(h.dtype)
    if mode == "row":
        out = reduce_from_group(out, group)
    if "bias" in p:
        out = out + p["bias"].to(h.dtype)
    if lora_p is not None:
        hl = h
        if drop_key is not None and drop_rate > 0.0:
            local, width, col0 = drop_where or (None, None, 0)
            keep = block_draw(
                lambda shape, index: cuda_prng.bernoulli(
                    drop_key, 1.0 - drop_rate, shape, h.device, index),
                h.shape, local, width, col0)
            hl = torch.where(keep, h / _keep_rate(drop_rate, h), 0.0)
        if lora_idx is not None:
            # gather first, then cast: the same values as casting the whole
            # stack, at a row's cost
            a_sel = lora_p["a"][lora_idx].to(h.dtype)  # [B, d_in, r]
            b_sel = lora_p["b"][lora_idx].to(h.dtype)  # [B, r, d_out]
            scale = lora_scale.to(h.dtype)[lora_idx][:, None, None]
            out = out + torch.bmm(torch.bmm(hl, a_sel), b_sel) * scale
        else:
            # a host-side rounding: a device scalar would cost a copy a call
            scale = float(torch.tensor(float(lora_scale), dtype=h.dtype))
            a = lora_p["a"].to(h.dtype)
            b = lora_p["b"].to(h.dtype)
            u = hl @ a
            if mode == "col":
                u = copy_to_group(u, group)
            elif mode == "row":
                u = reduce_from_group(u, group)
            out = out + (u @ b) * scale
    return out


def nf4_tp_shard(quant: dict, dims: tuple, role: str, tp: int,
                 idx: int) -> dict:
    """One layer's nf4 collection cut to this rank's tp shard of W [in,
    out]. The sharding rules keep nf4 leaves whole over tp (their blocks
    run along ``in`` within an output channel); a column module keeps its
    output channels' blocks (a contiguous run), a row module its input
    range's blocks of every channel (``in / tp`` a multiple of the block)."""
    d_in, d_out = dims
    per_row = d_in // NF4_BLOCK  # blocks an output channel
    packed = quant["packed"].reshape(d_out, per_row, NF4_BLOCK // 2)
    scale_q = quant["scale_q"].reshape(d_out, per_row)
    if role == "col":
        w = d_out // tp
        packed, scale_q = (t[idx * w:(idx + 1) * w] for t in (packed,
                                                               scale_q))
    else:
        if (d_in // tp) % NF4_BLOCK:
            raise ValueError(f"tp={tp}: a row shard of in={d_in} must hold "
                             f"whole nf4 blocks of {NF4_BLOCK}")
        w = per_row // tp
        packed, scale_q = (t[:, idx * w:(idx + 1) * w] for t in (packed,
                                                                  scale_q))
    return dict(quant, packed=packed.reshape(-1, NF4_BLOCK // 2),
                scale_q=scale_q.reshape(-1))


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm hidden states → vocabulary logits, computed in x's dtype and
    upcast to float32 (so bf16 serving logits are bf16-rounded)."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = x @ params["embed_tokens"]["embedding"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(x.dtype)
    return logits.to(torch.float32)


def _layer(tree: dict, i: int) -> dict:
    """Layer i's leaves, peeled off a stacked [L, ...] tree at any depth
    (a projection's ``quant`` collection nests one level further)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# a projection's index in the dropout key chain (ref models/llama.py:343-402)
_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")

_SAVED_BY_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the 2-D projection matmuls, recompute everything else."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    "full": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy),
}


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, T]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid, 0=pad
    segment_ids: Optional[torch.Tensor] = None,  # [B, T] packed sequences
    cache: Optional[dict] = None,
    lora: Optional[tuple] = None,  # (lora_params, scaling)
    lora_adapter_idx: Optional[torch.Tensor] = None,  # [B]: stacked adapters
    compute_dtype=None,
    lora_dropout: float = 0.0,
    dropout_rng=None,  # host threefry key ([2] uint32), training only
    neftune_alpha: float = 0.0,
    return_hidden: bool = False,
    skip_logits: bool = False,
    window_mask: Optional[torch.Tensor] = None,  # [B, T, WN] bool
    window_start: Optional[torch.Tensor] = None,  # [B]
    mesh=None,  # parallel/mesh.Mesh: tp shards, the sp ring
    local=None,  # parallel/sharding.LocalSlice: this rank's block
):
    """Returns (logits [B, T, V] float32, new_cache | None); with
    ``return_hidden`` also the final-norm hidden states [B, T, D], and
    with ``skip_logits`` (which needs ``return_hidden``) logits None, so a
    value head (rm) pays no vocabulary projection.

    Dispatch follows the reference: over a paged cache with
    ``cfg.paged_kernel``, single-token steps take the paged decode kernel
    (K7) and multi-token steps the multi-token kernel (K8) with the
    ``attention_allow`` mask operand; with ``paged_kernel`` False, and over
    a dense cache, they take the biased full-width read (the kernels'
    oracle). An int8 cache hands its scale leaves along. Without a cache,
    ``attention_impl="flash"`` takes the flash kernels when ``T % 128 == 0
    or T < 128`` (the reference's ``_flash_ok``), else the biased path. A
    ``cfg.sliding_window`` model takes the biased path everywhere (no
    paged kernel, no flash), with the window in the bias.
    ``dropout_rng`` (training only) turns on LoRA dropout and NEFTune.
    With ``lora_adapter_idx``, ``lora``'s leaves are stacked over adapters
    (``[L, E, ...]``, scales ``[E]``) and row b applies adapter
    ``lora_adapter_idx[b]`` (``_proj``). ``window_mask``/``window_start``
    (a speculative tree step; the start defaults to the cache cursors)
    restrict the step's own lanes (``ops/attention.attention_allow``) in
    the ``allow`` tensor K8 takes and in the gather path's bias; such a
    step never takes K7.

    Under a ``mesh`` (training, no cache) ``params`` hold this rank's tp
    shards of the projections (whole embedding, norms and head), tokens are
    this rank's rows and sequence chunk, and ``local`` places them in the
    global batch: rope takes global positions, dropout and NEFTune draw the
    rank's block of the global draws. ``attention_impl="ring"`` runs the
    sp ring when sp > 1 and no ``segment_ids`` are given (the ring is
    causal only), else the biased path; with sp > 1 every other path
    gathers q/k/v over sp, attends over the whole sequence and keeps this
    rank's chunk."""
    if skip_logits and not return_hidden:
        raise ValueError("skip_logits without return_hidden returns nothing")
    B, T = tokens.shape
    t0 = local.t0 if local is not None else 0
    T_all = local.seq if local is not None else T  # the global length
    if positions is None:
        positions = (t0 + torch.arange(T, dtype=torch.int32,
                                       device=tokens.device))[None].expand(
                                           B, T)
    tp = mesh.shape["tp"] if mesh is not None else 1
    sp = mesh.shape["sp"] if mesh is not None else 1
    if cache is not None and (tp > 1 or sp > 1):
        raise ValueError("a KV cache runs on one device (no mesh)")

    x = params["embed_tokens"]["embedding"][tokens.long()]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if neftune_alpha > 0.0 and dropout_rng is not None:
        # NEFTune (reference cmd/tuning/parser.py:190-193): uniform noise on
        # the embedding output, magnitude alpha / sqrt(T * D) in f32,
        # training only
        mag = float(np.float32(neftune_alpha)
                    / np.sqrt(np.float32(T_all * x.shape[-1])))
        nkey = prng.fold_in(dropout_rng, 0x4EF)
        noise = block_draw(
            lambda shape, index: cuda_prng.uniform(nkey, shape, -1.0, 1.0,
                                                   x.device, index),
            x.shape, local)
        x = x + (noise * mag).to(x.dtype)

    seq_len = T_all if cache is None else kv_cache_width(cache)
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, theta=cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type,
        scaling_factor=cfg.rope_scaling_factor,
        max_seq_len=cfg.max_seq_len, seq_len=seq_len)
    # built once, used by every layer (the per-layer op count bounds decode)
    rope_cc, rope_ss = rope_tables(cos, sin, x.dtype)

    # a sliding window keeps the paged kernels and flash off: the window
    # rides the gather path's bias, as in the reference
    paged = (cache is not None and "block_tables" in cache
             and getattr(cfg, "paged_kernel", False)
             and cfg.sliding_window is None)
    paged_kernel = paged and T == 1 and window_mask is None
    paged_kernel_mt = paged and not paged_kernel
    targets = None
    if cache is None:
        kv_positions = positions
        kv_valid = (attention_mask.to(torch.bool)
                    if attention_mask is not None else None)
        kv_seg = segment_ids
        cache_pos = None
    else:
        # record each new token's rope position in the cache's position
        # table (in place); pads get the sentinel. The decode kernel masks
        # the pos pool through the tables, so it needs no gathered view.
        # The write targets serve every layer's K/V leaves too.
        targets = cache_write_targets(cache, T)
        cache_pos, kv_positions = cache_positions_update(
            cache, positions, attention_mask, gather=not paged_kernel,
            targets=targets)
        kv_valid = None
        kv_seg = None
    # flash handles causal + packed segments in-kernel and skips the
    # [B, T, S] bias entirely; cache decode keeps the biased path. The
    # ring (causal only) takes no segments; at sp 1 it is the biased path.
    flash = (cfg.attention_impl == "flash" and cache is None
             and cfg.sliding_window is None
             and (T_all % 128 == 0 or T_all < 128))
    ring = (cfg.attention_impl == "ring" and cache is None
            and cfg.sliding_window is None and segment_ids is None
            and sp > 1)
    gather_seq = sp > 1 and not ring
    q_positions, att_seg = positions, segment_ids
    if gather_seq:
        # every other path attends over the whole sequence: the masks'
        # inputs are gathered here, q/k/v in each layer
        grp = mesh.group(("sp",))
        q_positions = kv_positions = all_gather_dim(positions, 1, grp, sp)
        if kv_valid is not None:
            kv_valid = all_gather_dim(kv_valid, 1, grp, sp)
        if segment_ids is not None:
            att_seg = kv_seg = all_gather_dim(segment_ids, 1, grp, sp)
    bias = allow = None
    if window_mask is not None and window_start is None:
        if cache is None:
            raise ValueError("window_mask without a cache needs window_start")
        window_start = cache["len"].expand(B)
    if paged_kernel_mt:
        allow = attention_allow(positions, kv_positions, kv_valid,
                                window_mask=window_mask,
                                window_start=window_start)
    elif not paged_kernel and not flash and not ring:
        bias = make_causal_bias(q_positions, kv_positions, kv_valid,
                                sliding_window=cfg.sliding_window,
                                q_segment_ids=att_seg,
                                kv_segment_ids=kv_seg,
                                window_mask=window_mask,
                                window_start=window_start)

    lora_layers, lora_scale = None, 0.0
    if lora is not None:
        lora_params, lora_scale = lora
        lora_layers = lora_params.get("layers", lora_params)
    drop = lora_dropout if (dropout_rng is not None
                            and lora is not None) else 0.0
    lora_idx = (lora_adapter_idx.long() if lora_adapter_idx is not None
                else None)

    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tp > 1:
        if H % tp or KV % tp:
            raise ValueError(f"tp={tp} must divide the heads ({H}) and the "
                             f"KV heads ({KV})")
        H, KV = H // tp, KV // tp
    tp_idx = mesh.coords["tp"] if mesh is not None else 0
    tp_group = mesh.group(("tp",)) if tp > 1 else None
    # (module → its tp role, its input's global width, its columns' start)
    place = {}
    for name in _PROJECTIONS:
        if name in ("o_proj", "down_proj"):
            width = cfg.q_dim if name == "o_proj" else cfg.intermediate_size
            place[name] = ("row", width, tp_idx * width // tp)
        else:
            place[name] = ("col", cfg.hidden_size, 0)
    use_pallas = cfg.quant_impl == "pallas"
    quant_kv = cache is not None and "k_scale" in cache
    # the dropout keys of the adapted projections, once a forward (a remat
    # recompute reuses them): fold_in(fold_in(rng, layer), projection)
    drop_keys = [{} for _ in range(cfg.num_layers)]
    if drop > 0.0:
        for i in range(cfg.num_layers):
            lkey = prng.fold_in(dropout_rng, i)
            drop_keys[i] = {j: prng.fold_in(lkey, j)
                            for j, name in enumerate(_PROJECTIONS)
                            if name in lora_layers}

    def layer(x, i):
        lp = _layer(params["layers"], i)
        ll = _layer(lora_layers, i) if lora_layers else {}
        keys = drop_keys[i]

        def proj(h, name, j):
            role, width, col0 = place[name]
            dims = target_dims(cfg, name)
            p = lp[name]
            if tp > 1:
                if "packed" in p.get("quant", {}):
                    p = dict(p, quant=nf4_tp_shard(p["quant"], dims, role,
                                                   tp, tp_idx))
                dims = ((dims[0] // tp, dims[1]) if role == "row"
                        else (dims[0], dims[1] // tp))
            return _proj(h, p, ll.get(name), lora_scale, keys.get(j),
                         drop, cfg.quantization, dims, use_pallas, lora_idx,
                         drop_where=(local, width, col0),
                         tp=(role, tp_group) if tp > 1 else None)

        h = rms_norm(x, lp["input_layernorm"]["scale"], cfg.rms_norm_eps)
        q = proj(h, "q_proj", 0).reshape(B, T, H, d)
        k = proj(h, "k_proj", 1).reshape(B, T, KV, d)
        v = proj(h, "v_proj", 2).reshape(B, T, KV, d)
        q = apply_rope_tables(q, rope_cc, rope_ss)
        k = apply_rope_tables(k, rope_cc, rope_ss)

        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
            cks = cache["k_scale"][i] if quant_kv else None
            cvs = cache["v_scale"][i] if quant_kv else None
        if cache is not None and paged_kernel:
            kv_cache_write_paged(cache, ck, cv, cks, cvs, k, v, targets)
            attn = paged_attention_decode_step(
                q, ck, cv, cks, cvs, cache, cache_pos, positions)
        elif cache is not None and paged_kernel_mt:
            kv_cache_write_paged(cache, ck, cv, cks, cvs, k, v, targets)
            attn = paged_attention_multitoken_step(
                q, ck, cv, cks, cvs, cache, allow)
        else:
            if cache is not None:
                *_, k_att, v_att = kv_cache_update(cache, ck, cv, cks, cvs,
                                                   k, v, targets)
            else:
                k_att, v_att = k, v
            q_att = q
            if gather_seq:
                q_att, k_att, v_att = (gather_dim(t_, 1, mesh, "sp")
                                       for t_ in (q, k_att, v_att))
            attn = attention(q_att, k_att, v_att, bias,
                             impl=("ring" if ring else
                                   "flash" if flash else "xla"),
                             segment_ids=att_seg if flash else None,
                             mesh=mesh)
            if gather_seq:
                attn = attn.narrow(1, mesh.coords["sp"] * T, T)
        x = x + proj(attn.reshape(B, T, H * d), "o_proj", 3)

        h = rms_norm(x, lp["post_attention_layernorm"]["scale"],
                     cfg.rms_norm_eps)
        gate = proj(h, "gate_proj", 4)
        up = proj(h, "up_proj", 5)
        # silu as the reference spells it (x * sigmoid(x), rounded per op)
        return x + proj(gate * torch.sigmoid(gate) * up, "down_proj", 6)

    remat = (cache is None and torch.is_grad_enabled()
             and cfg.remat in _REMAT_CONTEXT)
    for i in range(cfg.num_layers):
        if remat:
            context = _REMAT_CONTEXT[cfg.remat]
            extra = {} if context is None else {"context_fn": context}
            x = checkpoint(layer, x, i, use_reentrant=False, **extra)
        else:
            x = layer(x, i)

    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = None if skip_logits else lm_logits(params, x, cfg)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + T
        new_cache["pos"] = cache_pos
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache
