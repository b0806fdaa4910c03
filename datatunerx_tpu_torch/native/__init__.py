"""Native extension loader: builds packer.cpp with g++ on first use and binds
it through ctypes. Every entry point has a pure-Python fallback in
data/preprocess: a missing toolchain costs speed, never correctness.

The library goes to ``build/torch_native/`` under the repository root, named
by a hash of the source and flags, so an edited source rebuilds and an
unchanged one loads the library already there. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# seconds the g++ build took in this process (0.0: loaded an existing build)
build_seconds = 0.0

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"dtx_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[Path]:
    # compile to a per-process temporary name, then rename atomically:
    # test workers, or a trainer beside the operator, may build at once,
    # and a partial library must never be visible at the final path
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    build_seconds = time.perf_counter() - t0
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _library_path()
        if not so.exists():
            # every caller waits behind the one-time first-use compile (a
            # second g++ on the same library would race); the subprocess
            # inside carries timeout=120
            so = _build(so)  # dtxlint: disable=DTX009 -- deliberate one-time build under lock
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.dtx_fill_batch.argtypes = [
                _i32p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, _i32p, _i32p, _i32p,
            ]
            lib.dtx_fill_batch.restype = None
            lib.dtx_first_fit.argtypes = [
                _i64p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
            ]
            lib.dtx_first_fit.restype = ctypes.c_int64
            lib.dtx_fill_packed.argtypes = [
                _i32p, _i32p, _i64p, _i64p, _i64p, _i64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                _i32p, _i32p, _i32p, _i32p, _i32p,
            ]
            lib.dtx_fill_packed.restype = None
        except (OSError, AttributeError):
            return None  # a corrupt or stale library: the Python fallback
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _concat(examples, key):
    lens = np.asarray([len(e[key]) for e in examples], np.int64)
    offsets = np.zeros(len(examples) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), np.int32)
    for i, e in enumerate(examples):
        flat[offsets[i]: offsets[i + 1]] = e[key]
    return flat, offsets


def _lengths_consistent(examples) -> bool:
    """The C++ loops slice labels with the input_ids offsets; examples whose
    two lengths differ would misalign the copy, so they take Python."""
    return all(len(e["input_ids"]) == len(e["labels"]) for e in examples)


def fill_batch_native(examples, block: int, pad_id: int, ignore_index: int):
    lib = get_lib()
    if lib is None or not _lengths_consistent(examples):
        return None
    tokens, offsets = _concat(examples, "input_ids")
    labels, _ = _concat(examples, "labels")
    B = len(examples)
    out_t = np.empty((B, block), np.int32)
    out_l = np.empty((B, block), np.int32)
    out_a = np.empty((B, block), np.int32)
    lib.dtx_fill_batch(tokens, labels, offsets, B, block, pad_id, ignore_index,
                       out_t.reshape(-1), out_l.reshape(-1), out_a.reshape(-1))
    return {"input_ids": out_t, "labels": out_l, "attention_mask": out_a}


def pack_batch_native(examples, block: int, pad_id: int, ignore_index: int):
    lib = get_lib()
    if lib is None or not _lengths_consistent(examples):
        return None
    order = sorted(range(len(examples)),
                   key=lambda i: -len(examples[i]["input_ids"]))
    sorted_ex = [examples[i] for i in order]
    lengths = np.asarray(
        [min(len(e["input_ids"]), block) for e in sorted_ex], np.int64)
    n = len(sorted_ex)
    row_of = np.empty(n, np.int64)
    row_used = np.zeros(n, np.int64)
    n_rows = int(lib.dtx_first_fit(lengths, n, block, row_of, row_used))

    # per-example start column and 1-based segment index within its row
    row_fill = np.zeros(n_rows, np.int64)
    row_segs = np.zeros(n_rows, np.int64)
    row_offset = np.empty(n, np.int64)
    seg_of = np.empty(n, np.int64)
    for i in range(n):
        r = row_of[i]
        row_offset[i] = row_fill[r]
        row_fill[r] += lengths[i]
        row_segs[r] += 1
        seg_of[i] = row_segs[r]

    tokens, offsets = _concat(sorted_ex, "input_ids")
    labels, _ = _concat(sorted_ex, "labels")
    out = {
        "input_ids": np.full((n_rows, block), pad_id, np.int32),
        "labels": np.full((n_rows, block), ignore_index, np.int32),
        "attention_mask": np.zeros((n_rows, block), np.int32),
        "segment_ids": np.zeros((n_rows, block), np.int32),
        "positions": np.zeros((n_rows, block), np.int32),
    }
    lib.dtx_fill_packed(
        tokens, labels, offsets, row_of, row_offset, seg_of, n, block,
        ignore_index,
        out["input_ids"].reshape(-1), out["labels"].reshape(-1),
        out["attention_mask"].reshape(-1), out["segment_ids"].reshape(-1),
        out["positions"].reshape(-1),
    )
    return out
