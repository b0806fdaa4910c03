"""The weight bridge: the JAX package's param tree → the port's params.

Both packages keep the same stacked ``[L, in, out]`` tree with the same leaf
names, so conversion is a leaf-for-leaf copy: no transposes, no renames. A
quantized tree crosses too: integer leaves (nf4 ``packed`` uint8,
``scale_q``/``q`` int8) keep their dtype and bits, and the float leaves of a
``quant`` collection (``meta``, ``scale``) stay float32. The caller hands
over the JAX tree as numpy (``jax.device_get``); this module imports
nothing of JAX.

``cache_from_jax`` carries a KV cache across the same way (dense or paged,
bf16/f32 or int8 with scales), so that both packages can start from one
cache state.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from datatunerx_tpu_torch.ops.quant import NF4_BLOCK


def _to_torch(tree: Mapping[str, Any], device, dtype):
    """Nested dict of numpy arrays → the same nested dict of tensors."""

    def walk(node, quant):
        if isinstance(node, Mapping):
            return {k: walk(v, quant or k == "quant") for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind in "iub":  # quantized codes: bits kept
            return torch.from_numpy(np.array(arr, order="C")).to(device)
        arr = np.array(arr, dtype=np.float32, order="C")  # an owned copy
        return torch.from_numpy(arr).to(
            device=device, dtype=torch.float32 if quant else dtype)

    return walk(tree, False)


def _q_proj_shape(q_proj: Mapping[str, Any], cfg):
    """(got, want) for the q projection of a full or quantized tree."""
    L, D, Q = cfg.num_layers, cfg.hidden_size, cfg.q_dim
    if "kernel" in q_proj:
        return tuple(q_proj["kernel"].shape), (L, D, Q)
    quant = q_proj["quant"]
    if "q" in quant:  # int8
        return tuple(quant["q"].shape), (L, D, Q)
    return tuple(quant["scale_q"].shape), (L, D * Q // NF4_BLOCK)  # nf4


def params_from_jax(tree: Mapping[str, Any], cfg=None, device="cpu",
                    dtype=torch.float32):
    """Nested dict of numpy arrays (the JAX param tree after
    ``jax.device_get``, full or quantized) → the same nested dict of
    tensors on ``device``, float leaves in ``dtype``. ``cfg``, when given,
    is checked against the tree's shapes."""
    params = _to_torch(tree, device, dtype)
    if cfg is not None:
        emb = tuple(params["embed_tokens"]["embedding"].shape)
        want_emb = (cfg.vocab_size, cfg.hidden_size)
        q, want_q = _q_proj_shape(params["layers"]["q_proj"], cfg)
        if emb != want_emb or q != want_q:
            raise ValueError(
                f"param tree does not fit {cfg.name}: embedding {emb} vs "
                f"{want_emb}, q_proj {q} vs {want_q}")
    return params


def lora_from_jax(tree: Mapping[str, Any], cfg=None, device="cpu",
                  dtype=torch.float32):
    """The JAX adapter tree (``init_lora_params``' ``{"layers": {target:
    {"a": [L, d_in, r], "b": [L, r, d_out]}}}`` after ``jax.device_get``) →
    the port's, leaf for leaf. ``cfg``, when given, is checked against the
    adapters' shapes."""
    lora = _to_torch(tree, device, dtype)
    if cfg is not None:
        from datatunerx_tpu_torch.models.lora import target_dims

        for name, ab in lora["layers"].items():
            d_in, d_out = target_dims(cfg, name)
            r = ab["a"].shape[-1]
            if (tuple(ab["a"].shape) != (cfg.num_layers, d_in, r)
                    or tuple(ab["b"].shape) != (cfg.num_layers, r, d_out)):
                raise ValueError(
                    f"adapter {name} does not fit {cfg.name}: a "
                    f"{tuple(ab['a'].shape)}, b {tuple(ab['b'].shape)}")
    return lora


def cache_from_jax(tree: Mapping[str, Any], device="cpu"):
    """A JAX KV cache dict (numpy leaves after ``jax.device_get``: dense
    ``init_cache`` or paged ``init_paged_cache``, with or without
    ``k_scale``/``v_scale``) → the port's cache dict on ``device``. Every
    leaf keeps its dtype and bits (bf16 leaves arrive as ml_dtypes arrays
    and are reinterpreted, not rounded). A paged cache (one with
    ``block_tables``) gains the port's scratch block: one more block at the
    end of ``k``/``v``/the scale pools (zeros) and of ``pos`` (sentinel)."""
    from datatunerx_tpu_torch.ops.paged_attention import POS_SENTINEL

    def leaf(arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(arr.view(np.uint16), order="C"))
            return t.view(torch.bfloat16)
        return torch.from_numpy(np.array(arr, order="C"))

    cache = {name: leaf(arr) for name, arr in tree.items()}
    if "block_tables" in cache:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in cache:
                t = cache[name]  # [L, NB, bs, ...] → [L, NB + 1, bs, ...]
                cache[name] = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        pos = cache["pos"]
        cache["pos"] = torch.cat(
            [pos, torch.full_like(pos[:1], POS_SENTINEL)], dim=0)
    return {name: t.to(device) for name, t in cache.items()}
