"""The weight bridge: the JAX package's param tree → the port's params.

Both packages keep the same stacked ``[L, in, out]`` tree with the same leaf
names, so conversion is a leaf-for-leaf copy: no transposes, no renames. The
caller hands over the JAX tree as numpy (``jax.device_get``); this module
imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], cfg=None, device="cpu",
                    dtype=torch.float32):
    """Nested dict of numpy arrays (the JAX param tree after
    ``jax.device_get``) → the same nested dict of ``dtype`` tensors on
    ``device``. ``cfg``, when given, is checked against the tree's shapes."""

    def leaf(x):
        arr = np.array(x, dtype=np.float32, order="C")  # an owned copy
        return torch.from_numpy(arr).to(
            device=device, dtype=dtype)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    params = walk(tree)
    if cfg is not None:
        emb = params["embed_tokens"]["embedding"]
        q = params["layers"]["q_proj"]["kernel"]
        want_emb = (cfg.vocab_size, cfg.hidden_size)
        want_q = (cfg.num_layers, cfg.hidden_size, cfg.q_dim)
        if tuple(emb.shape) != want_emb or tuple(q.shape) != want_q:
            raise ValueError(
                f"param tree does not fit {cfg.name}: embedding "
                f"{tuple(emb.shape)} vs {want_emb}, q_proj {tuple(q.shape)} "
                f"vs {want_q}")
    return params
