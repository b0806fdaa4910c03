"""Training draws of the threefry twin on the device: the LoRA-dropout keep
mask and the NEFTune noise (ref ``models/llama.py``: ``jax.random.
bernoulli`` in ``_proj``, ``jax.random.uniform`` on the embeddings).

Both take one host key (``ops/prng.py``: a numpy ``[2]`` uint32; its
evolution by ``fold_in`` stays on the host, so no draw waits on the
device) and a shape, and give ``jax.random``'s values bit for bit:

  ``bernoulli(key, p, shape, device)``      bool, ``uniform(key) < p``
  ``uniform(key, shape, lo, hi, device)``   float32 in ``[lo, hi)``

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


def threefry_bits(key, shape: Sequence[int], device, *, p=None,
                  lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """The kernel's launch: the keep mask ``uniform(key, shape) < p`` (bool)
    when ``p`` is given, else ``uniform(key, shape, lo, hi)`` (float32),
    on the CUDA ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA, got {device}")
    shape = tuple(int(s) for s in shape)
    n = _numel(shape)
    k0, k1 = _key_words(key)
    lib = _build.library()
    if p is not None:
        out = torch.empty(shape, dtype=torch.bool, device=device)
        code = lib.dtx_threefry_bernoulli(k0, k1, n, float(np.float32(p)),
                                          out.data_ptr(), _build.stream(out))
    else:
        lo32 = np.float32(lo)
        span = np.float32(np.float32(hi) - lo32)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        code = lib.dtx_threefry_uniform(k0, k1, n, float(lo32), float(span),
                                        out.data_ptr(), _build.stream(out))
    _build.check(code, "threefry kernel")
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0


def plain_bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """The kernel's plain version for the keep mask."""
    return prng.bernoulli(prng.to_device(key, device), p, tuple(shape))


def plain_uniform(key, shape, lo: float, hi: float, device) -> torch.Tensor:
    """The kernel's plain version for the uniform draw."""
    return prng.uniform(prng.to_device(key, device), tuple(shape), lo, hi)


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` on ``device``."""
    if torch.device(device).type == "cpu":
        return plain_bernoulli(key, p, shape, device)
    return threefry_bits(key, shape, device, p=p)


def uniform(key, shape, lo: float, hi: float, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on ``device``."""
    if torch.device(device).type == "cpu":
        return plain_uniform(key, shape, lo, hi, device)
    return threefry_bits(key, shape, device, lo=lo, hi=hi)
