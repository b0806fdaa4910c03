"""Seeded random weights, made by the benchmark on the device.

Each layer is one normal draw from a ``torch.Generator`` seeded by (run
seed, config, layer), split into the layer's matrices and biases; the
embedding and the head are one draw each. Every matrix and bias has
standard deviation 0.02 (the published ``initializer_range``), the norm
scales are ones. The same seed gives the same bits on the same kind of
card, so the reference draws any layer again on its own after the program
has been freed, and both sides start from the same numbers.

The program gets the weights in its own layout (stacked ``[L, ...]``
leaves, ``models/llama.py``'s names); the reference takes one layer at a
time (``layer``).
"""

from __future__ import annotations

import hashlib

import torch

STD = 0.02


def part_seed(seed: int, config: str, part: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{config}/{part}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def dims(c: dict) -> dict:
    """The matrix shapes of one layer, from a published config."""
    D, F = c["hidden_size"], c["intermediate_size"]
    H = c["num_attention_heads"]
    KV = c.get("num_key_value_heads", H)
    d = c.get("head_dim") or D // H
    q, kv = H * d, KV * d
    return {"q_proj": (D, q), "k_proj": (D, kv), "v_proj": (D, kv),
            "o_proj": (q, D), "gate_proj": (D, F), "up_proj": (D, F),
            "down_proj": (F, D)}


BIASED = ("q_proj", "k_proj", "v_proj")


def _normal(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, dtype=torch.float32, device=device)


def layer(c: dict, name: str, seed: int, i: int, device,
          dtype=torch.bfloat16) -> dict:
    """Layer ``i``'s weights: ``{proj: (kernel [in, out], bias | None)}``
    in ``dtype``, from one draw."""
    shapes = dims(c)
    bias = c.get("attention_bias", c.get("model_type") == "qwen2")
    sizes = []
    for p, (a, b) in shapes.items():
        sizes.append(a * b)
        if bias and p in BIASED:
            sizes.append(b)
    flat = _normal(sum(sizes), part_seed(seed, name, f"layer{i}"), device)
    flat.mul_(STD)
    out, at = {}, 0
    for p, (a, b) in shapes.items():
        k = flat[at:at + a * b].view(a, b).to(dtype)
        at += a * b
        bvec = None
        if bias and p in BIASED:
            bvec = flat[at:at + b].to(dtype)
            at += b
        out[p] = (k, bvec)
    return out


def embedding(c: dict, name: str, seed: int, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    V, D = c["vocab_size"], c["hidden_size"]
    w = _normal(V * D, part_seed(seed, name, "embed"), device)
    return w.mul_(STD).view(V, D).to(dtype)


def head(c: dict, name: str, seed: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    V, D = c["vocab_size"], c["hidden_size"]
    w = _normal(V * D, part_seed(seed, name, "head"), device)
    return w.mul_(STD).view(D, V).to(dtype)


def model_params(c: dict, name: str, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """The whole tree in the program's layout (stacked leaves)."""
    L, D = c["num_hidden_layers"], c["hidden_size"]
    shapes = dims(c)
    layers = {"input_layernorm": {"scale": torch.ones((L, D), dtype=dtype,
                                                      device=device)},
              "post_attention_layernorm": {
                  "scale": torch.ones((L, D), dtype=dtype, device=device)}}
    for p, (a, b) in shapes.items():
        layers[p] = {"kernel": torch.empty((L, a, b), dtype=dtype,
                                           device=device)}
    for i in range(L):
        for p, (k, bias) in layer(c, name, seed, i, device, dtype).items():
            layers[p]["kernel"][i].copy_(k)
            if bias is not None:
                if "bias" not in layers[p]:
                    layers[p]["bias"] = torch.empty((L, bias.shape[0]),
                                                    dtype=dtype,
                                                    device=device)
                layers[p]["bias"][i].copy_(bias)
        del k
    params = {"embed_tokens": {"embedding": embedding(c, name, seed, device,
                                                      dtype)},
              "layers": layers,
              "norm": {"scale": torch.ones((D,), dtype=dtype,
                                           device=device)}}
    if not c.get("tie_word_embeddings", False):
        params["lm_head"] = {"kernel": head(c, name, seed, device, dtype)}
    return params
