"""The dtx-kv-session wire format, the port of
``datatunerx_tpu/serving/migration.py``: a live decode session serialized
so that it moves between replicas without a new prefill.

A payload holds the session's KV prefix as a dense row trimmed to its live
cursor, the decode state that makes resumption token-exact (next-token
logits, the slot's threefry key as two uint32 words, position, cursor and
budget), the generated tail, the sampling parameters, the adapter NAME
(pool indices are replica-local) and the model signature. Array bodies are
base64 text for the JSON wire, or host numpy arrays for payloads that never
leave the process (``b64=False``, the engine's preemption parking;
``encode_payload`` makes them wire-safe). Bodies hold the same bytes as the
reference's, so a payload that either package builds and ``json.dumps``
loads in the other. bf16 bodies travel as their raw 16-bit words (numpy has
no bf16 type). A ``dtx-kv-prefix`` payload carries a prefix-cache entry the
same way, with no decode state.

Wire encodings: ``bf16`` (the cache's own bytes, lossless) and ``int8``
(the ``kv_quant`` representation: int8 values plus an f32 scale per head
vector; exact for an int8 cache, a rounding of a bf16 one). Either imports
into either cache type.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from datatunerx_tpu_torch.ops.attention import kv_quantize
from datatunerx_tpu_torch.ops.paged_attention import POS_SENTINEL, row_trim

PAYLOAD_KIND = "dtx-kv-session"
# a prefix-cache entry for the fleet prefix tier: the same KV row encoding,
# no decode state (the importer builds a prefix-cache entry, not a slot)
PREFIX_KIND = "dtx-kv-prefix"
PAYLOAD_VERSION = 1

# the error a migrated-away request finishes with; a gateway matches the
# literal to splice the imported continuation into the client's stream
MIGRATED_SESSION = "session migrated"


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes on the host as numpy; bf16 as its 16-bit words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _body(arr, b64: bool):
    """One array body: base64 text for the JSON wire, or the host numpy
    array itself for a payload that stays in the process."""
    host = _host(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return _b64(host) if b64 else host


def _unb64(data, dtype, shape) -> torch.Tensor:
    """A body (base64 text or raw numpy) → a CPU tensor of ``dtype``."""
    word = np.uint16 if dtype == torch.bfloat16 else {
        torch.int8: np.int8, torch.int32: np.int32,
        torch.float32: np.float32}[dtype]
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data).reshape(-1).view(word)
    else:
        arr = np.frombuffer(base64.b64decode(data.encode()), dtype=word)
    if arr.size != int(np.prod(shape)):
        raise ValueError(
            f"kv payload body holds {arr.size} elements, shape {shape} "
            f"needs {int(np.prod(shape))}")
    t = torch.from_numpy(arr.copy().reshape(shape))
    if dtype == torch.bfloat16:
        return t.view(torch.int16).view(torch.bfloat16)
    return t


def pack_kv_row(row: Dict, cursor: int, wire: str, b64: bool = True) -> dict:
    """A dense row cache (``paged_extract_row`` output) → wire doc, trimmed
    to the live ``cursor``. An int8 row ships as-is under ``int8``; a bf16
    row asked for ``int8`` is quantized with ``kv_quantize``."""
    row = row_trim(row, max(1, cursor))
    k, v = row["k"], row["v"]
    quantized_cache = "k_scale" in row
    if wire == "int8" and not quantized_cache:
        k, ks = kv_quantize(k)
        v, vs = kv_quantize(v)
    elif quantized_cache:
        wire = "int8"  # an int8 cache's bytes ARE the int8 wire encoding
        ks, vs = row["k_scale"], row["v_scale"]
    else:
        wire = "bf16"
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    L, _, W, KV, d = k.shape
    doc = {
        "wire": wire, "width": int(W), "layers": int(L),
        "kv_heads": int(KV), "head_dim": int(d),
        "k": _body(k, b64), "v": _body(v, b64),
        "pos": _body(row["pos"].to(torch.int32), b64),
    }
    if wire == "int8":
        doc["k_scale"] = _body(ks.to(torch.float32), b64)
        doc["v_scale"] = _body(vs.to(torch.float32), b64)
    return doc


def unpack_kv_row(doc: dict, full_width: int, quantize: Optional[str],
                  device="cpu") -> Dict:
    """Wire doc → a dense row cache shaped for this engine's cache
    (``[L, 1, full_width, KV, d]`` plus sentinel-padded positions) on
    ``device``, converting between the int8 and bf16 encodings as
    ``quantize`` demands."""
    L, W = int(doc["layers"]), int(doc["width"])
    KV, d = int(doc["kv_heads"]), int(doc["head_dim"])
    if W > full_width:
        raise ValueError(
            f"session KV depth {W} exceeds this replica's context "
            f"{full_width}")
    wire = doc.get("wire") or "bf16"
    shape = (L, 1, W, KV, d)
    if wire == "int8":
        k = _unb64(doc["k"], torch.int8, shape)
        v = _unb64(doc["v"], torch.int8, shape)
        ks = _unb64(doc["k_scale"], torch.float32, shape[:-1])
        vs = _unb64(doc["v_scale"], torch.float32, shape[:-1])
    elif wire == "bf16":
        k = _unb64(doc["k"], torch.bfloat16, shape)
        v = _unb64(doc["v"], torch.bfloat16, shape)
        ks = vs = None
    else:
        raise ValueError(f"unknown kv wire encoding {wire!r}")
    pos = _unb64(doc["pos"], torch.int32, (1, W))

    def _pad(a: torch.Tensor, fill=0) -> torch.Tensor:
        axis = 2 if a.dim() >= 3 else 1
        shape = list(a.shape)
        shape[axis] = full_width
        out = torch.full(shape, fill, dtype=a.dtype, device=device)
        out.narrow(axis, 0, W).copy_(a)
        return out

    row: Dict = {"pos": _pad(pos, fill=POS_SENTINEL)}
    if quantize == "int8":
        if wire != "int8":  # bf16 wire into an int8 cache: re-quantize
            k, ks = kv_quantize(k)
            v, vs = kv_quantize(v)
        row["k"], row["v"] = _pad(k), _pad(v)
        row["k_scale"], row["v_scale"] = _pad(ks), _pad(vs)
    else:
        if wire == "int8":  # int8 wire into a bf16 cache: dequantize
            k = k.to(torch.float32) * ks[..., None]
            v = v.to(torch.float32) * vs[..., None]
        row["k"] = _pad(k.to(torch.bfloat16))
        row["v"] = _pad(v.to(torch.bfloat16))
    return row


def pack_logits(logits, b64: bool = True):
    return _body(torch.as_tensor(logits).to(torch.float32), b64)


def unpack_logits(payload: dict, vocab: int, device="cpu") -> torch.Tensor:
    return _unb64(payload["logits"], torch.float32, (vocab,)).to(device)


def encode_payload(payload: dict) -> dict:
    """A payload with every raw numpy body (an in-process ``b64=False``
    export) base64-encoded for the wire; encoded payloads pass through."""
    out = dict(payload)
    if isinstance(out.get("logits"), np.ndarray):
        out["logits"] = _b64(np.asarray(out["logits"], np.float32))
    kv = out.get("kv")
    if isinstance(kv, dict):
        kv = dict(kv)
        for key in ("k", "v", "pos", "k_scale", "v_scale"):
            if isinstance(kv.get(key), np.ndarray):
                kv[key] = _b64(kv[key])
        out["kv"] = kv
    return out


def model_signature(cfg, kv_quant: Optional[str]) -> dict:
    """What must match (or be convertible) for an import to be correct."""
    return {"layers": cfg.num_layers, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
            "kv_quant": kv_quant or ""}


def _check_model_sig(payload: dict, cfg) -> None:
    sig = payload.get("model_sig") or {}
    for key, want in (("layers", cfg.num_layers),
                      ("kv_heads", cfg.num_kv_heads),
                      ("head_dim", cfg.head_dim),
                      ("vocab", cfg.vocab_size)):
        if sig.get(key) != want:
            raise ValueError(
                f"session payload is from an incompatible model: "
                f"{key}={sig.get(key)} here {want}")


def _check_kind(payload: dict, kind: str, what: str) -> None:
    if payload.get("kind") != kind:
        raise ValueError(
            f"not a {kind} payload (kind={payload.get('kind')!r})")
    if payload.get("version") != PAYLOAD_VERSION:
        raise ValueError(
            f"unsupported {what} payload version {payload.get('version')!r}")


def check_signature(payload: dict, cfg) -> None:
    _check_model_sig(payload, cfg)
    _check_kind(payload, PAYLOAD_KIND, "session")


def check_prefix_signature(payload: dict, cfg) -> None:
    _check_model_sig(payload, cfg)
    _check_kind(payload, PREFIX_KIND, "prefix")


def prefix_fingerprint(adapter: str, prompt_ids: Sequence[int]) -> str:
    """The fleet-wide identity of a prefix entry: sha1 over the adapter
    NAME, a zero byte and the prompt ids as int64 (the reference's bytes)."""
    h = hashlib.sha1()
    h.update(str(adapter or "").encode("utf-8", "replace"))
    h.update(b"\x00")
    h.update(np.asarray(list(prompt_ids), np.int64).tobytes())
    return h.hexdigest()


def build_payload(cfg, kv_quant: Optional[str], request: dict, row: Dict,
                  cursor: int, pos: int, remaining: int, rng, logits,
                  wire: Optional[str] = None, b64: bool = True) -> dict:
    """One exported session's payload. ``request`` holds the request's host
    fields (trace id, adapter name, prompt and tokens, sampling
    parameters); ``cursor``/``pos``/``remaining`` are host ints, ``rng`` the
    slot's threefry key and ``logits`` its next-token row; ``row`` is the
    dense KV row, trimmed and encoded here (``wire`` defaults to the cache's
    own encoding)."""
    cursor = int(cursor)
    default_wire = "int8" if kv_quant == "int8" else "bf16"
    return {
        "kind": PAYLOAD_KIND, "version": PAYLOAD_VERSION,
        **request,
        "pos": int(pos), "remaining": int(remaining), "cursor": cursor,
        "rng": [int(x) for x in np.asarray(rng, np.uint32)],
        "logits": pack_logits(logits, b64=b64),
        "kv": pack_kv_row(row, cursor, wire or default_wire, b64=b64),
        "model_sig": model_signature(cfg, kv_quant),
    }


def normalize_payload(payload: dict, cfg) -> dict:
    """Check an incoming payload against this engine's model and cast every
    field the import reads to its host type."""
    check_signature(payload, cfg)
    out = dict(payload)
    out["cursor"] = int(payload["cursor"])
    out["pos"] = int(payload["pos"])
    out["remaining"] = int(payload["remaining"])
    out["max_new_tokens"] = int(payload.get("max_new_tokens",
                                            out["remaining"]))
    out["temperature"] = float(payload.get("temperature", 0.0))
    out["top_p"] = float(payload.get("top_p", 1.0))
    out["seed"] = int(payload.get("seed", 0))
    out["stop_ids"] = [int(s) for s in (payload.get("stop_ids") or [])]
    out["prompt_ids"] = [int(t) for t in (payload.get("prompt_ids") or [])]
    out["tokens"] = [int(t) for t in (payload.get("tokens") or [])]
    out["adapter"] = str(payload.get("adapter") or "")
    out["trace_id"] = str(payload.get("trace_id") or "")
    rng = payload.get("rng") or []
    if len(rng) != 2:
        raise ValueError("session payload rng must be a 2-word PRNG key")
    out["rng"] = [int(x) for x in rng]
    return out
