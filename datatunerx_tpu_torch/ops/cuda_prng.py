"""Training draws of the threefry twin on the device: the LoRA-dropout keep
mask and the NEFTune noise (ref ``models/llama.py``: ``jax.random.
bernoulli`` in ``_proj``, ``jax.random.uniform`` on the embeddings).

Both take one host key (``ops/prng.py``: a numpy ``[2]`` uint32; its
evolution by ``fold_in`` stays on the host, so no draw waits on the
device) and a shape, and give ``jax.random``'s values bit for bit:

  ``bernoulli(key, p, shape, device)``      bool, ``uniform(key) < p``
  ``uniform(key, shape, lo, hi, device)``   float32 in ``[lo, hi)``

``index=prng.slice_index(global_shape, starts)`` draws the block of a
draw over ``global_shape`` that starts at ``starts`` (a rank's rows, its
sequence chunk or its column shard), equal to the matching elements of the
whole draw: the kernel takes a start counter and the block's strides.

For CUDA devices one launch of ``csrc/threefry.cu`` writes the result
(``threefry_bits.launches`` counts them); on the CPU the plain version
runs: the twin's int64 torch ops (``prng.bernoulli`` / ``prng.uniform``
over the key's words on the device), which the kernel matches integer for
integer. The kernel replaces no Pallas kernel: XLA fuses these rounds on
the TPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from datatunerx_tpu_torch.ops import _build, prng


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


def _key_words(key):
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def kernel_index(shape, index):
    """``(offset, n1, n2, s0, s1)`` for the kernel: the block's dims merged
    where they are contiguous in the global draw, at most three, the
    innermost of stride 1. No index is the whole draw."""
    n = _numel(shape)
    if index is None:
        return 0, 1, n, 0, 0
    offset, strides = index
    dims = [(int(m), int(st)) for m, st in zip(shape, strides) if m != 1]
    merged = []
    for m, st in dims:
        if merged and merged[-1][1] == st * m:
            merged[-1] = (merged[-1][0] * m, st)
        else:
            merged.append((m, st))
    if not merged:
        return int(offset), 1, 1, 0, 0
    if merged[-1][1] != 1 or len(merged) > 3:
        raise ValueError(f"block {tuple(shape)} with strides {strides} is "
                         "not a kernel index (at most 3 runs, unit inner)")
    merged = [(1, 0)] * (3 - len(merged)) + merged
    (_, s0), (n1, s1), (n2, _) = merged
    return int(offset), n1, n2, s0, s1


def threefry_bits(key, shape: Sequence[int], device, *, p=None,
                  lo: float = 0.0, hi: float = 1.0,
                  index=None) -> torch.Tensor:
    """The kernel's launch: the keep mask ``uniform(key, shape) < p`` (bool)
    when ``p`` is given, else ``uniform(key, shape, lo, hi)`` (float32),
    on the CUDA ``device``; ``index`` as ``prng.slice_index``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA, got {device}")
    shape = tuple(int(s) for s in shape)
    n = _numel(shape)
    k0, k1 = _key_words(key)
    where = kernel_index(shape, index)
    lib = _build.library()
    if p is not None:
        out = torch.empty(shape, dtype=torch.bool, device=device)
        code = lib.dtx_threefry_bernoulli(k0, k1, n, float(np.float32(p)),
                                          *where, out.data_ptr(),
                                          _build.stream(out))
    else:
        lo32 = np.float32(lo)
        span = np.float32(np.float32(hi) - lo32)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        code = lib.dtx_threefry_uniform(k0, k1, n, float(lo32), float(span),
                                        *where, out.data_ptr(),
                                        _build.stream(out))
    _build.check(code, "threefry kernel")
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0


def plain_bernoulli(key, p: float, shape, device,
                    index=None) -> torch.Tensor:
    """The kernel's plain version for the keep mask."""
    return prng.bernoulli(prng.to_device(key, device), p, tuple(shape),
                          index=index)


def plain_uniform(key, shape, lo: float, hi: float, device,
                  index=None) -> torch.Tensor:
    """The kernel's plain version for the uniform draw."""
    return prng.uniform(prng.to_device(key, device), tuple(shape), lo, hi,
                        index=index)


def bernoulli(key, p: float, shape, device, index=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` on ``device`` (or its block
    ``index``)."""
    if torch.device(device).type == "cpu":
        return plain_bernoulli(key, p, shape, device, index)
    return threefry_bits(key, shape, device, p=p, index=index)


def uniform(key, shape, lo: float, hi: float, device,
            index=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on ``device`` (or
    its block ``index``)."""
    if torch.device(device).type == "cpu":
        return plain_uniform(key, shape, lo, hi, device, index)
    return threefry_bits(key, shape, device, lo=lo, hi=hi, index=index)
