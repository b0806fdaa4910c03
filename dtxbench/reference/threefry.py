"""A frozen copy of the parts of the threefry twin that LoRA dropout, the
LoRA init and the serving sampler draw from: ``jax.random``'s threefry2x32
with the partitionable bit layout, ``PRNGKey``, ``split``, ``fold_in``,
``uniform`` and ``bernoulli``. Keys are ``[2]`` words (numpy ``uint32`` on
the host, or ``int64`` tensors); draws run as torch ``int64`` operations on
any device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _words(key):
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64) & _M32
    else:
        k = np.asarray(key, dtype=np.uint32).astype(np.uint64)
    return k[..., 0], k[..., 1]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on 32-bit words held in wider integers."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def split(key) -> np.ndarray:
    """``jax.random.split(key)``: the pairs of counters (0, 0) and (0, 1),
    as two keys ``[2, 2]``."""
    k0, k1 = _words(key)
    w0, w1 = threefry2x32(k0, k1, np.zeros(2, np.uint64),
                          np.arange(2, dtype=np.uint64))
    return np.stack((w0, w1), axis=-1).astype(np.uint32)


def sampling_uniforms(seed: int, n: int) -> np.ndarray:
    """The uniforms a sampled stream's first ``n`` tokens are drawn with:
    from ``PRNGKey(seed)``, each token splits the key, keeps the first
    half and draws one float32 uniform from the second."""
    key, out = PRNGKey(seed), np.empty(n, np.float32)
    for j in range(n):
        key, sub = split(key)
        k0, k1 = _words(sub)
        w0, w1 = threefry2x32(k0, k1, np.uint64(0), np.uint64(0))
        bits = np.uint32((w0 ^ w1) >> 9 | 0x3F800000)
        out[j] = bits.view(np.float32) - np.float32(1.0)
    return out


def fold_in(key, data: int) -> np.ndarray:
    k0, k1 = _words(key)
    zero = np.zeros_like(k0)
    w0, w1 = threefry2x32(k0, k1, zero, zero + np.uint64(int(data) & _M32))
    return np.stack((w0, w1), axis=-1).astype(np.uint32)


def random_bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as int64 words on ``device``: the
    threefry pair of each element's flattened index (high, low words),
    XORed."""
    k0, k1 = (int(w) for w in _words(key))
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(torch.full_like(i, k0), torch.full_like(i, k1),
                          i >> 32, i & _M32)
    return (w0 ^ w1).reshape(tuple(shape))


def uniform(key, shape, lo: float, hi: float, device) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of [1, 2), minus one, scaled with one rounding."""
    bits = random_bits(key, shape, device)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo32 = np.float32(lo)
    span = float(np.float32(np.float32(hi) - lo32))
    return torch.clamp((f.double() * span + float(lo32)).float(),
                       min=float(lo32))


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """``uniform(key, shape) < p``."""
    return uniform(key, shape, 0.0, 1.0, device) < float(np.float32(p))
