"""Build and load the port's CUDA kernels; the counterpart of
``datatunerx_tpu/ops/_pallas.py``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together), linked into ONE shared library with a
plain C interface, and loaded with ``ctypes``. The library goes to
``build/torch_kernels/`` under the repository root in a checkout, and to
``${XDG_CACHE_HOME:-~/.cache}/datatunerx_tpu_torch/torch_kernels/`` for an
installed package (``utils/build_dirs.py``), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
library already there. Nothing is built at import: the first kernel launch
builds, which is why this module is safe to import on a machine with no
CUDA toolkit (the CPU tests import every module).

``python -m datatunerx_tpu_torch.ops._build`` compiles the library without
loading it. nvcc needs no card, so an image builds it at image build time.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from datatunerx_tpu_torch.utils.build_dirs import build_dir

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = build_dir("torch_kernels")
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


def compile_library() -> Path:
    """The path of the library built from the sources under ``CSRC``,
    compiled first if no build of them exists. Loads nothing."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libdtx_kernels-{_digest(sources)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build(sources, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process
    (or loaded when a build of the same sources already exists)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = compile_library()  # dtxlint: disable=DTX009 -- deliberate one-time build under lock
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _LL = ctypes.c_uint32, ctypes.c_longlong


def _declare(lib: ctypes.CDLL):
    """argtypes/restype for every C entry point (pointers and the stream as
    c_void_p, or ctypes would pass them as 32-bit ints)."""
    for dt in ("bf16", "f32"):
        fn = getattr(lib, f"dtx_paged_decode_{dt}")
        # q, k_pool, v_pool, tables, pos_pool, q_pos, out,
        # B, H, KV, d, bs, nbps, splits, entries per split, scale, stream
        fn.argtypes = [_P] * 7 + [_I] * 8 + [_F, _P]
        fn.restype = _I
        fn = getattr(lib, f"dtx_paged_multitoken_{dt}")
        # q, k_pool, v_pool, tables, allow, out,
        # B, T, H, KV, d, bs, nbps, tq, scale, stream
        fn.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
        fn.restype = _I
        # the int8-pool instantiations: k_scale, v_scale after v_pool
        fn = getattr(lib, f"dtx_paged_decode_i8_{dt}")
        fn.argtypes = [_P] * 9 + [_I] * 8 + [_F, _P]
        fn.restype = _I
        fn = getattr(lib, f"dtx_paged_multitoken_i8_{dt}")
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_F, _P]
        fn.restype = _I
        # q, k, v, qseg, kseg, out, lse, B, T, S, H, KV, d, causal, scale,
        # stream
        fn = getattr(lib, f"dtx_flash_fwd_{dt}")
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_F, _P]
        fn.restype = _I
        # q, k, v, dO, lse, D, qseg, kseg, dq, B, T, S, H, KV, d, causal,
        # scale, stream
        fn = getattr(lib, f"dtx_flash_bwd_dq_{dt}")
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_F, _P]
        fn.restype = _I
        # q, k, v, dO, lse, D, qseg, kseg, dk, dv, B, T, S, H, KV, d,
        # causal, scale, stream
        fn = getattr(lib, f"dtx_flash_bwd_dkv_{dt}")
        fn.argtypes = [_P] * 10 + [_I] * 7 + [_F, _P]
        fn.restype = _I
        # x|g, packed, scale_q, meta, out|dx, M, K, N, stream
        for name in ("dtx_nf4_matmul", "dtx_nf4_matmul_t"):
            fn = getattr(lib, f"{name}_{dt}")
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
            fn.restype = _I
        # x, q, scale, out, M, K, N, stream
        fn = getattr(lib, f"dtx_int8_matmul_{dt}")
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        fn.restype = _I
        # x, w, a, b, out, M, K, N, r, scale, splits, column vectors, stream
        fn = getattr(lib, f"dtx_lora_split_{dt}")
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P]
        fn.restype = _I
    # x, w, a (or aᵀ), b, out, M, K, N, r, scale, stream
    for name in ("dtx_lora_matmul_f32", "dtx_lora_gemm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_F, _P]
        fn.restype = _I
    fn = lib.dtx_lora_split_smem  # M, K, r, S, BN, element size
    fn.argtypes = [_I] * 6
    fn.restype = _I
    fn = lib.dtx_flash_bwd_resources  # d, int out[8]
    fn.argtypes = [_I, _P]
    fn.restype = _I
    fn = lib.dtx_flash_fwd_resources  # d, int out[4]
    fn.argtypes = [_I, _P]
    fn.restype = _I
    fn = lib.dtx_paged_multitoken_resources  # d, G, tq, int out[8]
    fn.argtypes = [_I] * 3 + [_P]
    fn.restype = _I
    fn = lib.dtx_paged_decode_resources  # d, G, int out[8]
    fn.argtypes = [_I] * 2 + [_P]
    fn.restype = _I
    fn = lib.dtx_int8_matmul_resources  # int out[4]
    fn.argtypes = [_P]
    fn.restype = _I
    fn = lib.dtx_nf4_matmul_resources  # int out[8]: K4, then K5
    fn.argtypes = [_P]
    fn.restype = _I
    # int out[8]: two variants; int out[4]
    for name in ("dtx_lora_gemm_resources", "dtx_lora_split_resources",
                 "dtx_sample_resources"):
        fn = getattr(lib, name)
        fn.argtypes = [_P]
        fn.restype = _I
    fn = lib.dtx_fused_sample
    # x, temps, us, out, S, Vp, greedy, stream
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I
    # k0, k1, n, p | (lo, span), offset, n1, n2, s0, s1, out, stream
    fn = lib.dtx_threefry_bernoulli
    fn.argtypes = [_U32, _U32, _LL, _F] + [_LL] * 5 + [_P, _P]
    fn.restype = _I
    fn = lib.dtx_threefry_uniform
    fn.argtypes = [_U32, _U32, _LL, _F, _F] + [_LL] * 5 + [_P, _P]
    fn.restype = _I
    fn = lib.dtx_empty_kernel  # stream
    fn.argtypes = [_P]
    fn.restype = _I


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


# --------------------------------------------- what the wrappers check
def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def operand(t, name: str, dtype, device, vector: bool = True):
    """A kernel operand: device, dtype, contiguity and, for an operand the
    kernels read with 16-byte loads (``vector``), its alignment."""
    require(t.device == device, f"{name} must be on {device}, got {t.device}")
    require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    t = t.contiguous()
    if vector and t.data_ptr() % 16:
        t = t.clone()
    return t


def stream(t) -> int:
    """The current CUDA stream of t's device, as the kernels take it."""
    import torch  # here, so that the compile-only entry needs no torch

    return torch.cuda.current_stream(t.device).cuda_stream


def main() -> int:
    """Compile the library into ``BUILD_DIR`` (no card, no ``ctypes``
    load) and print its path and the seconds it took."""
    t0 = time.perf_counter()
    out = compile_library()
    print(f"{out} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
