"""Process set-up for one benchmark run: the checkout's paths, the cache
directories every build uses, and the check that no JAX module was loaded.

Every build and kernel cache lives at a fixed path inside the checkout
(``build/``), so only the first run of a cell in a checkout builds: the
port's nvcc library (``build/torch_kernels/``) and native packer
(``build/torch_native/``) go there by the port's own rule, and the
variables below send torch's extension and Triton caches beside them.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent  # dtxbench/
ROOT = BENCH.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "datatunerx_tpu")


def prepare() -> None:
    """Put the checkout on ``sys.path`` and fix the cache directories.
    Call before importing torch."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    found = set()
    for name in list(sys.modules):
        top = name.split(".", 1)[0]
        if top in FORBIDDEN:
            found.add(top)
    return sorted(found)


def require_cuda(chips: int):
    """The card count this run needs, or an error text."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: this run needs a GPU"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell asks for {chips} GPUs and {n} are visible"
    return None
