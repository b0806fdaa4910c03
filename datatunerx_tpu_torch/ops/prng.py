"""A bit-exact twin of the ``jax.random`` functions the serving engines
draw from: threefry2x32 keys with JAX's partitionable bit layout
(``jax_threefry_partitionable`` True, the default since JAX 0.5; the tests
pin it against JAX 0.9.0).

A key is two 32-bit words, the last axis of an array ``[..., 2]``: a numpy
``uint32`` array on the host, or a ``torch.int64`` tensor holding the words
(each in [0, 2^32)) on any device. Every function takes either and returns
the same kind, so a key's evolution (``split``, ``fold_in``), which never
depends on a sampled value, runs on the host, and only draws over a
vocabulary (``categorical`` of a ``[S, V]`` row batch) need their bits on
the device. Leading axes of a key are batch axes (``jax.vmap`` over
keys): ``uniform(keys [S, 2], (k,))`` is ``[S, k]``, one draw per key.

The layout, as JAX builds it:

- ``random_bits(key, shape)``: threefry2x32 over the flattened index
  ``i`` of ``shape`` split into its high and low 32-bit words; the two
  output words XORed.
- ``split(key, n)``: the same over ``shape = (n,)``, the output words
  stacked as the ``n`` new keys.
- ``fold_in(key, d)``: threefry2x32 of the counter pair ``(0, d)``.
- ``PRNGKey(seed)``: ``(0, seed mod 2^32)``: with 64-bit types off, JAX
  truncates the seed to 32 bits (negative seeds wrap), so the high word is
  0.
- ``uniform``: ``(bits >> 9) | 0x3F800000`` read as a float32 in [1, 2),
  minus 1, scaled to ``[minval, maxval)`` with one fused multiply-add.
- ``gumbel``: ``-log(-log(uniform(tiny, 1)))``, with the natural log
  computed as XLA's CPU backend computes it (``xla_log``: the Cephes
  polynomial with fused multiply-adds, denormals flushed to zero), which is
  not the correctly rounded log of numpy or torch.
- ``categorical``: the first index of the largest ``logits + gumbel``.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Key = Union[np.ndarray, torch.Tensor]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _words(key):
    """The two key words as uint64 (numpy) / int64 (torch) arrays."""
    if _is_torch(key):
        k = key.to(torch.int64) & _M32
    else:
        k = np.asarray(key, dtype=np.uint32).astype(np.uint64)
    return k[..., 0], k[..., 1]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123), elementwise over broadcast
    operands holding 32-bit words in uint64 (numpy) or int64 (torch)."""
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


def slice_index(global_shape: Sequence[int], starts: Sequence[int]):
    """The ``index`` of a block of a draw over ``global_shape`` whose first
    element sits at ``starts``: (offset, row-major strides of the global
    shape). A rank that holds that block of a sharded array draws exactly
    its elements of the global draw (partitionable threefry: an element's
    bits depend only on its flattened global index)."""
    strides = []
    acc = 1
    for n in reversed(tuple(global_shape)):
        strides.append(acc)
        acc *= int(n)
    strides = tuple(reversed(strides))
    offset = sum(int(s) * st for s, st in zip(starts, strides))
    return offset, strides


def _counters(shape: Sequence[int], like, index=None):
    """The counter of every element of ``shape`` as (high, low) 32-bit
    words: its flattened index, or with ``index = (offset, strides)``
    ``offset + sum(i_k * strides[k])``."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    if _is_torch(like):
        ar = lambda m: torch.arange(m, dtype=torch.int64,  # noqa: E731
                                    device=like.device)
    else:
        ar = lambda m: np.arange(m, dtype=np.uint64)  # noqa: E731
    if index is None:
        i = ar(n).reshape(shape)
    else:
        offset, strides = index
        i = ar(1).reshape((1,) * len(shape)) * 0 + offset
        for k, (m, st) in enumerate(zip(shape, strides)):
            view = [1] * len(shape)
            view[k] = m
            i = i + ar(m).reshape(view) * st
        i = i.reshape(shape)
    return i >> 32, i & _M32


def _bits_pair(key, shape, index=None):
    """threefry's two output words for every index of ``shape``, one set
    per key: ``[*key.shape[:-1], *shape]`` each."""
    k0, k1 = _words(key)
    batch = tuple(k0.shape)
    hi, lo = _counters(shape, k0, index)
    extra = (None,) * len(shape)
    k0 = k0[(Ellipsis,) + extra]
    k1 = k1[(Ellipsis,) + extra]
    lead = (None,) * len(batch)
    return threefry2x32(k0, k1, hi[lead], lo[lead])


def _out_key(key, w0, w1):
    if _is_torch(key):
        return torch.stack((w0, w1), dim=-1)
    return np.stack((w0, w1), axis=-1).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the host key ``[2]`` uint32."""
    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split``: ``[..., 2]`` → ``[..., num, 2]``."""
    w0, w1 = _bits_pair(key, (int(num),))
    return _out_key(key, w0, w1)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` (data taken mod 2^32)."""
    k0, k1 = _words(key)
    d = int(data) & _M32
    if _is_torch(key):
        zero = torch.zeros_like(k0)
        w0, w1 = threefry2x32(k0, k1, zero, zero + d)
    else:
        zero = np.zeros_like(k0)
        w0, w1 = threefry2x32(k0, k1, zero, zero + np.uint64(d))
    return _out_key(key, w0, w1)


def random_bits(key: Key, shape: Sequence[int] = (), index=None):
    """``jax.random.bits(key, shape)`` (uint32): numpy uint32 on the host,
    int64 words in [0, 2^32) for a torch key. With ``index`` (from
    ``slice_index``), the block of a larger draw it names."""
    w0, w1 = _bits_pair(key, tuple(shape), index)
    out = w0 ^ w1
    return out if _is_torch(key) else out.astype(np.uint32)


def _to_f32(bits):
    """uint32 words → float32 by reinterpretation."""
    if _is_torch(bits):
        return bits.to(torch.int32).view(torch.float32)
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64, the sum rounds once there and once to float32; the two
    roundings agree with one except in cases of vanishing measure)."""
    if _is_torch(a):
        return (a.double() * b + c).float()
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def uniform(key: Key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0, index=None):
    """``jax.random.uniform`` in float32 (``index``: as ``random_bits``)."""
    bits = random_bits(key, shape, index)
    one = 0x3F800000
    floats = _to_f32((bits >> 9) | one) - 1.0
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    out = _fma32(floats, float(span), float(lo))
    if _is_torch(out):
        return torch.clamp(out, min=float(lo))
    return np.maximum(out, lo)


def bernoulli(key: Key, p: float = 0.5, shape: Sequence[int] = (),
              index=None):
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p``."""
    return uniform(key, shape, index=index) < np.float32(p)


# XLA:CPU's float32 log: the Cephes polynomial, products fused into the
# adds that follow them
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = 0.693359375
_SQRTHF = float(np.float32(0.707106781186547524))


def xla_log(x):
    """The natural log of float32 ``x`` bit for bit as XLA's CPU backend
    computes ``jnp.log``, on numpy or torch arrays."""
    tiny = np.float32(_F32_TINY)
    if _is_torch(x):
        xf = x.to(torch.float32)
        where, isnan = torch.where, torch.isnan
        t = torch.where(xf > tiny, xf, torch.full_like(xf, float(tiny)))
        tb = t.view(torch.int32).to(torch.int64)
        m = ((tb & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(
            torch.float32)
        e = ((tb >> 23) - 126).to(torch.float32)
        ab = xf.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
        zero = torch.zeros_like(xf)
    else:
        xf = np.asarray(x, np.float32)
        where, isnan = np.where, np.isnan
        t = np.where(xf > tiny, xf, tiny).astype(np.float32)
        tb = t.view(np.uint32).astype(np.int64)
        m = ((tb & 0x807FFFFF) | 0x3F000000).astype(np.uint32).view(
            np.float32)
        e = ((tb >> 23) - 126).astype(np.float32)
        ab = xf.view(np.uint32).astype(np.int64) & 0x7FFFFFFF
        zero = np.zeros_like(xf)
    one = zero + 1.0
    mask = m < _SQRTHF
    e = e - where(mask, one, zero)
    x0 = (m - 1.0) + where(mask, m, zero)
    x2 = x0 * x0
    x3 = x2 * x0
    p = _LOG_P
    y = _fma32(x0, p[0], p[1])
    y1 = _fma32(x0, p[3], p[4])
    y2 = _fma32(x0, p[6], p[7])
    y = _fma32(y, x0, p[2])
    y1 = _fma32(y1, x0, p[5])
    y2 = _fma32(y2, x0, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    r = _fma32(x2, -0.5, x0) + y
    r = _fma32(e, _LOG_Q2, r)
    # zero and denormals (flushed) give -inf, +inf stays, negatives and
    # NaN give NaN
    daz = ab < 0x00800000
    r = where(daz, zero - np.inf, r)
    r = where(xf == np.inf, zero + np.inf, r)
    r = where(~daz & ((xf < 0) | isnan(xf)), zero + np.nan, r)
    return r


def gumbel(key: Key, shape: Sequence[int] = (), index=None):
    """``jax.random.gumbel(key, shape)`` in float32 (``index``: as
    ``random_bits``)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0, index=index)
    return -xla_log(-xla_log(u))


def categorical(key: Key, logits, axis: int = -1, index=None):
    """``jax.random.categorical(key, logits)``: the first index of the
    largest ``logits + gumbel``. The key's batch axes lead ``logits``'s
    (``[S, 2]`` keys over ``[S, V]`` logits: one draw per row, as
    ``jax.vmap`` gives); the noise takes the rest of the logits' shape.
    With ``index`` (``slice_index``) the logits are a block of a larger
    draw's and the noise is that block's."""
    nb = (key.dim() if _is_torch(key) else np.ndim(key)) - 1
    shape = tuple(logits.shape[nb:])
    g = gumbel(key, shape, index)
    if _is_torch(logits):
        return torch.argmax(logits.to(torch.float32) + g, dim=axis)
    return np.argmax(np.asarray(logits, np.float32) + g, axis=axis)


def to_device(key: np.ndarray, device) -> torch.Tensor:
    """A host key (array) as the int64 words tensor on ``device``."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)).to(
        device)
