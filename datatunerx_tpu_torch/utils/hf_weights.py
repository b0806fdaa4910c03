"""Stream an HF checkpoint's weights into the port's param tree: the port's
stand-in for ``AutoModelForCausalLM.from_pretrained``'s reading (the machine
the port runs on has neither ``transformers`` nor ``safetensors``).

Formats: ``*.safetensors`` (an 8-byte little-endian header length, a JSON
header, then the raw tensors; ``F32``, ``F16`` and ``BF16``), sharded with
``model.safetensors.index.json``, and ``pytorch_model*.bin`` (+ its index)
through ``torch.load(..., weights_only=True, mmap=True)``.

Tensors are read one at a time from the mapped file, moved to the device,
rounded there to the target dtype through float32 (F16 → f32 → bf16 equals
the reference's host f32 copy rounded to bf16), transposed from torch's
``[out, in]`` to ``[in, out]`` and written into their layer of a stacked
``[L, ...]`` leaf. No full host copy is made: the host holds at most one
tensor (in a pinned staging buffer when the device is a GPU) besides the page
cache. The tree is the one ``utils/hf_convert.convert_hf_state_dict`` +
``models/convert.params_from_jax`` give: the same leaves, names, shapes and
values.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import time
from typing import Dict, Optional, Tuple

import torch

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.utils.hf_convert import _LAYER_KERNELS, _LAYER_NORMS

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16}
MODEL_TYPES = ("llama", "mistral", "qwen2")


def read_safetensors_header(path: str) -> Tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the data's byte offset)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class _SafetensorsFile:
    """Tensors of one ``.safetensors`` file, viewed over a private
    (copy-on-write) mapping of it: nothing is read until a tensor is."""

    def __init__(self, path: str):
        self.path = path
        self.header, self.base = read_safetensors_header(path)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            self.map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size > 0 else b"")
        for name, entry in self.header.items():
            dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise ValueError(
                    f"{path}: tensor {name!r} has dtype {entry['dtype']!r}; "
                    f"the port reads {sorted(SAFETENSORS_DTYPES)}")
            begin, end = entry["data_offsets"]
            numel = 1
            for s in entry["shape"]:
                numel *= s
            if end - begin != numel * dtype.itemsize or \
                    self.base + end > size:
                raise ValueError(
                    f"{path}: tensor {name!r} spans bytes {begin}..{end}, "
                    f"which does not fit shape {entry['shape']} of "
                    f"{entry['dtype']} in the file")

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        entry = self.header[name]
        dtype = SAFETENSORS_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        if end == begin:
            return torch.empty(entry["shape"], dtype=dtype)
        flat = torch.frombuffer(self.map, dtype=dtype,
                                count=(end - begin) // dtype.itemsize,
                                offset=self.base + begin)
        return flat.view(entry["shape"])


class _BinFile:
    """A ``pytorch_model*.bin`` state dict, loaded memory-mapped."""

    def __init__(self, path: str):
        self.path = path
        self.sd = torch.load(path, map_location="cpu", weights_only=True,
                             mmap=True)
        for name, t in self.sd.items():
            if t.dtype not in SAFETENSORS_DTYPES.values():
                raise ValueError(
                    f"{path}: tensor {name!r} has dtype {t.dtype}; the port "
                    "reads float32, float16 and bfloat16")

    def keys(self):
        return self.sd.keys()

    def get(self, name: str) -> torch.Tensor:
        return self.sd[name]


def checkpoint_files(path: str) -> Dict[str, str]:
    """tensor name → the file holding it, from the directory's index (or
    its one file): safetensors first, then ``pytorch_model*.bin``."""
    for index_name, single in (
            ("model.safetensors.index.json", "model.safetensors"),
            ("pytorch_model.bin.index.json", "pytorch_model.bin")):
        index = os.path.join(path, index_name)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            return {k: os.path.join(path, v) for k, v in weight_map.items()}
        if os.path.exists(os.path.join(path, single)):
            return {"": os.path.join(path, single)}
    raise FileNotFoundError(
        f"{path} holds no model.safetensors(.index.json) and no "
        "pytorch_model.bin(.index.json)")


class HFCheckpoint:
    """The tensors of an HF checkpoint directory, by name."""

    def __init__(self, path: str):
        files = checkpoint_files(path)
        self.files: Dict[str, object] = {}
        self.where: Dict[str, str] = {}
        for name, file in files.items():
            if file not in self.files:
                opener = (_SafetensorsFile if file.endswith(".safetensors")
                          else _BinFile)
                if not os.path.exists(file):
                    raise FileNotFoundError(
                        f"{path}: the index names {os.path.basename(file)}, "
                        "which is missing")
                self.files[file] = opener(file)
            if name:
                self.where[name] = file
        if "" in files:  # one file, no index
            single = self.files[files[""]]
            self.where = {k: files[""] for k in single.keys()}
        self.path = path

    def __contains__(self, name: str) -> bool:
        return name in self.where

    def get(self, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """Tensor ``name`` (host, its stored dtype), checked to be ``shape``."""
        file = self.where.get(name)
        if file is None:
            raise KeyError(f"{self.path}: the checkpoint has no tensor "
                           f"{name!r}")
        t = self.files[file].get(name)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{file}: tensor {name!r} has shape {tuple(t.shape)}, the "
                f"config.json asks for {tuple(shape)}")
        return t


def expected_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """HF shape of each per-layer weight (``[out, in]`` for a Linear)."""
    D, F, Q, K = (cfg.hidden_size, cfg.intermediate_size, cfg.q_dim,
                  cfg.kv_dim)
    return {"self_attn.q_proj": (Q, D), "self_attn.k_proj": (K, D),
            "self_attn.v_proj": (K, D), "self_attn.o_proj": (D, Q),
            "mlp.gate_proj": (F, D), "mlp.up_proj": (F, D),
            "mlp.down_proj": (D, F)}


def param_count(cfg: ModelConfig) -> int:
    """Elements of the param tree of ``cfg`` (q/k/v biases when
    ``attention_bias``; no ``lm_head`` when the embeddings are tied)."""
    D, F, Q, K = (cfg.hidden_size, cfg.intermediate_size, cfg.q_dim,
                  cfg.kv_dim)
    layer = 2 * D + D * Q + 2 * D * K + Q * D + 3 * D * F
    if cfg.attention_bias:
        layer += Q + 2 * K
    head = 0 if cfg.tie_word_embeddings else D * cfg.vocab_size
    return cfg.vocab_size * D + cfg.num_layers * layer + D + head


class _Placer:
    """Host tensor → the device in ``dtype`` (through float32, as the
    reference's host copy), with the read (into a pinned staging buffer on
    a GPU) and the placement timed apart."""

    def __init__(self, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.cuda = self.device.type == "cuda"
        self.stage: Optional[torch.Tensor] = None
        self.read_s = self.place_s = 0.0
        self.bytes = 0

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        nbytes = host.numel() * host.element_size()
        if self.cuda:
            if self.stage is None or self.stage.numel() < nbytes:
                self.stage = torch.empty(nbytes, dtype=torch.uint8,
                                         pin_memory=True)
            staged = self.stage[:nbytes].view(host.dtype).view(host.shape)
            staged.copy_(host)
            host = staged
        t1 = time.perf_counter()
        t = host.to(self.device)
        if t.dtype != self.dtype:
            t = t.to(torch.float32).to(self.dtype)
        elif not self.cuda:
            t = t.clone()  # own the bytes: the mapping may go away
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.read_s += t1 - t0
        self.place_s += time.perf_counter() - t1
        self.bytes += nbytes
        return t


def load_hf_params(path: str, cfg: ModelConfig, dtype=torch.float32,
                   device="cpu", timings: Optional[dict] = None) -> dict:
    """The stacked param tree of the HF checkpoint in ``path`` for ``cfg``,
    on ``device`` in ``dtype``. Raises, naming the file, on a missing
    tensor, a shape that disagrees with ``cfg``, or an unknown dtype.
    ``timings``, when given, receives ``read_s``, ``place_s`` and
    ``bytes``."""
    if cfg.name not in MODEL_TYPES:
        raise NotImplementedError(
            f"{path}: model_type {cfg.name!r}; the port reads {MODEL_TYPES}")
    ckpt = HFCheckpoint(path)
    place = _Placer(device, dtype)
    prefix = "model." if any(k.startswith("model.") for k in ckpt.where) \
        else ""
    L = cfg.num_layers
    dev = place.device

    def stacked(shape):
        return torch.empty((L, *shape), dtype=dtype, device=dev)

    layers: dict = {}
    for hf_name, our_name in _LAYER_KERNELS:
        out_dim, in_dim = expected_shapes(cfg)[hf_name]
        kernel = stacked((in_dim, out_dim))
        for i in range(L):
            w = place(ckpt.get(f"{prefix}layers.{i}.{hf_name}.weight",
                               (out_dim, in_dim)))
            kernel[i].copy_(w.T)
            del w
        layers[our_name] = {"kernel": kernel}
        if f"{prefix}layers.0.{hf_name}.bias" in ckpt:
            bias = stacked((out_dim,))
            for i in range(L):
                bias[i].copy_(place(ckpt.get(
                    f"{prefix}layers.{i}.{hf_name}.bias", (out_dim,))))
            layers[our_name]["bias"] = bias
    D = cfg.hidden_size
    for hf_name, our_name in _LAYER_NORMS:
        scale = stacked((D,))
        for i in range(L):
            scale[i].copy_(place(ckpt.get(
                f"{prefix}layers.{i}.{hf_name}.weight", (D,))))
        layers[our_name] = {"scale": scale}
    params = {
        "embed_tokens": {"embedding": place(ckpt.get(
            f"{prefix}embed_tokens.weight", (cfg.vocab_size, D)))},
        "layers": layers,
        "norm": {"scale": place(ckpt.get(f"{prefix}norm.weight", (D,)))},
    }
    if not cfg.tie_word_embeddings:
        head = place(ckpt.get("lm_head.weight", (cfg.vocab_size, D)))
        params["lm_head"] = {"kernel": head.T.contiguous()}
        del head
    if timings is not None:
        timings.update(read_s=place.read_s, place_s=place.place_s,
                       bytes=place.bytes)
    return params
