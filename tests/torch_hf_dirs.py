"""HF checkpoint directories for the port's tests, written locally with
``transformers``' ``save_pretrained`` (nothing is downloaded): a small
llama, mistral (``sliding_window=16``) or qwen2 model at the widths of
``tests/test_model_parity.py``, seeded random weights in a chosen dtype and
file format, and a committed tokenizer fixture (``fixtures/torch_hf``)."""

import os
import shutil

import torch

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_hf")
# the widths of tests/test_model_parity.py; the vocabulary holds the
# fixtures' tokenizers (2000 and 2003 tokens)
COMMON = dict(vocab_size=2048, hidden_size=64, intermediate_size=128,
              num_hidden_layers=3, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              rms_norm_eps=1e-5, tie_word_embeddings=False)
TOKENIZER = {"llama": "llama", "mistral": "llama_legacy", "qwen2": "qwen2"}
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def hf_model(family: str, seed: int = 0, **overrides):
    """A ``*ForCausalLM`` of ``family`` with seeded random weights (eager
    attention, f32)."""
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        MistralConfig,
        MistralForCausalLM,
        Qwen2Config,
        Qwen2ForCausalLM,
    )

    kw = dict(COMMON, **overrides)
    if family == "llama":
        cfg = LlamaConfig(**kw)
        cls = LlamaForCausalLM
    elif family == "mistral":
        kw.setdefault("sliding_window", 16)
        cfg = MistralConfig(**kw)
        cls = MistralForCausalLM
    elif family == "qwen2":
        cfg = Qwen2Config(**kw)
        cls = Qwen2ForCausalLM
    else:
        raise ValueError(family)
    cfg._attn_implementation = "eager"
    torch.manual_seed(seed)
    model = cls(cfg)
    with torch.no_grad():  # the biases init to 0: give them values
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.02)
    return model.eval()


def write_hf_dir(path, family: str, dtype: str = "F32",
                 fmt: str = "safetensors", shard_kb: int = 0,
                 tokenizer: bool = True, **overrides) -> str:
    """Save a ``family`` model to ``path`` as ``save_pretrained`` does:
    ``fmt`` "safetensors" or "bin", ``shard_kb`` > 0 shards it with an
    index; copy the family's tokenizer fixture beside it."""
    path = str(path)
    model = hf_model(family, **overrides).to(DTYPES[dtype])
    model.save_pretrained(
        path, safe_serialization=fmt == "safetensors",
        max_shard_size=f"{shard_kb}KB" if shard_kb else "10GB")
    if tokenizer:
        src = os.path.join(FIXTURES, TOKENIZER[family])
        for name in os.listdir(src):
            shutil.copy(os.path.join(src, name), path)
    return path
