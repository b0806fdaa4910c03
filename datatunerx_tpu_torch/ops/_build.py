"""Build and load the port's CUDA kernels; the counterpart of
``datatunerx_tpu/ops/_pallas.py``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together), linked into ONE shared library with a
plain C interface, and loaded with ``ctypes``. The library goes to
``build/torch_kernels/`` under the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already there. Nothing is built at import: the first kernel
launch builds, which is why this module is safe to import on a machine with
no CUDA toolkit (the CPU tests import every module).

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def pick_block_n(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is ≤ cap and a multiple of 128,
    preferred; else the largest power-of-two divisor ≤ cap (a copy of the
    reference helper — the sampling tile walk uses it)."""
    cap = min(cap, n)
    for bn in range(cap - cap % 128, 0, -128):
        if n % bn == 0:
            return bn
    bn = 1
    while bn * 2 <= cap and n % (bn * 2) == 0:
        bn *= 2
    return bn


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, out: Path):
    """One ``nvcc -c`` per source in parallel, then one link."""
    nvcc = _nvcc()
    tmp = out.parent / f".{out.name}.{os.getpid()}.d"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs, procs = [], []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = tmp / out.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:1], *map(str, objs),
             "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib_tmp, out)  # atomic: a reader never sees half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process
    (or loaded when a build of the same sources already exists)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out = BUILD_DIR / f"libdtx_kernels-{_digest(sources)}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(sources, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _declare(lib: ctypes.CDLL):
    """argtypes/restype for every C entry point (pointers and the stream as
    c_void_p, or ctypes would pass them as 32-bit ints)."""
    for dt in ("bf16", "f32"):
        fn = getattr(lib, f"dtx_paged_decode_{dt}")
        # q, k_pool, v_pool, tables, pos_pool, q_pos, out,
        # B, H, KV, d, bs, nbps, scale, stream
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_F, _P]
        fn.restype = _I
        fn = getattr(lib, f"dtx_paged_multitoken_{dt}")
        # q, k_pool, v_pool, tables, allow, out,
        # B, T, H, KV, d, bs, nbps, tq, scale, stream
        fn.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
        fn.restype = _I
    fn = lib.dtx_fused_sample
    # x, temps, us, out, S, Vp, greedy, stream
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
