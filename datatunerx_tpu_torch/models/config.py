"""Model configurations for the llama-family decoder (a copy of
``datatunerx_tpu/models/config.py``: the port imports nothing of the JAX
package, and the tests assert the two agree field for field).

The reference platform targets Llama-2-7B LoRA SFT (reference
pkg/util/generate/generate.go:21, internal/controller/finetune/finetunejob_controller.go:310)
and its BASELINE configs add Mistral-7B (full-param FSDP) and Qwen1.5-14B (QLoRA).
All three are the same decoder family: RMSNorm + RoPE + GQA + SwiGLU, differing in
dims, kv-head count, qkv bias (Qwen) and sliding window (Mistral) — so one
implementation with a config dataclass covers the model inventory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    # RoPE scaling: reference exposes --rope_scaling {linear,dynamic}
    # (reference cmd/tuning/parser.py:57-60); None disables.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen1.5 uses bias on q/k/v projections
    sliding_window: Optional[int] = None  # Mistral local attention window
    # remat ("gradient checkpointing", reference cmd/tuning/train.py:205) policy:
    # "none" | "full" | "dots" (checkpoint_dots_with_no_batch_dims)
    remat: str = "full"
    # attention implementation: "xla" (einsum softmax) | "flash" (Pallas) |
    # "ring" (sequence-parallel ring attention over a mesh axis)
    attention_impl: str = "xla"
    # base-weight quantization: None | "int8" | "int4"/"nf4" (QLoRA).
    # Replaces bitsandbytes (reference cmd/tuning/train.py:224-234).
    quantization: Optional[str] = None
    quant_impl: str = "xla"  # "xla" | "pallas"
    # paged attention kernels (ops/cuda_paged_attention.py): True routes
    # attention over a block-table cache through the in-place kernels
    # (single-token decode and multi-token chunks) instead of the gather
    # path; engages only when the cache is paged and sliding_window is None.
    # Resolved by the serving engine from its --paged_kernel auto|on|off
    # flag; training never sets it.
    paged_kernel: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0
        if self.rope_scaling_type is not None:
            assert self.rope_scaling_type in ("linear", "dynamic"), self.rope_scaling_type

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


PRESETS = {
    # Debug-scale configs for tests and CPU smoke runs.
    "debug": ModelConfig(
        name="debug", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
    ),
    "debug-350m": ModelConfig(
        name="debug-350m", vocab_size=32000, hidden_size=1024, intermediate_size=2816,
        num_layers=20, num_heads=16, num_kv_heads=16, max_seq_len=2048,
    ),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, hidden_size=2048,
        intermediate_size=5632, num_layers=22, num_heads=32, num_kv_heads=4,
        max_seq_len=2048,
    ),
    "llama2-7b": ModelConfig(
        name="llama2-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
        max_seq_len=4096,
    ),
    "llama2-13b": ModelConfig(
        name="llama2-13b", vocab_size=32000, hidden_size=5120,
        intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40,
        max_seq_len=4096,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_seq_len=8192, sliding_window=4096, rms_norm_eps=1e-5,
    ),
    "qwen1.5-14b": ModelConfig(
        name="qwen1.5-14b", vocab_size=152064, hidden_size=5120,
        intermediate_size=13696, num_layers=40, num_heads=40, num_kv_heads=40,
        max_seq_len=8192, rope_theta=1_000_000.0, attention_bias=True,
        rms_norm_eps=1e-6,
    ),
    "qwen1.5-7b": ModelConfig(
        name="qwen1.5-7b", vocab_size=151936, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
        max_seq_len=8192, rope_theta=1_000_000.0, attention_bias=True,
        rms_norm_eps=1e-6,
    ),
}


def get_config(name: str, **overrides) -> ModelConfig:
    """Look up a preset by name, optionally overriding fields."""
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
