"""Trainer CLI flags: the port of ``datatunerx_tpu/tuning/parser.py``.

The same flag surface as the reference's ``TrainArgs`` (the flag set the
controller emits plus the trainer's own schema), with one addition:
``--device cuda|cpu`` (default ``cuda``; the CLI raises without a GPU unless
it gets ``--device cpu``).

Contract-compat notes kept from the reference:
- the controller sends ``--lora_r``; ``--lora_rank`` is accepted too;
- ``--deepspeed`` is accepted and ignored;
- ``--columns`` may arrive Go-strconv.Quote()d — it is unquoted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class TrainArgs:
    # model (reference cmd/tuning/parser.py:12-109)
    model_name_or_path: str
    quantization: Optional[str] = None  # int4 | int8
    quantization_type: str = "nf4"  # fp4 | nf4
    double_quantization: bool = True
    quant_impl: str = "pallas"  # pallas (the fused CUDA kernels K4-K6; the
    # reference's name, kept so config.json crosses between the packages) |
    # xla (dequantize, then a plain matmul)
    rope_scaling: Optional[str] = None  # linear | dynamic
    rope_scaling_factor: float = 2.0
    flash_attn: bool = False
    shift_attn: bool = False
    checkpoint_dir: Optional[str] = None  # resume/merge adapters
    export_dir: Optional[str] = None
    # finetuning (reference cmd/tuning/parser.py:112-221)
    stage: str = "sft"  # pt | sft | dpo | rm | ppo
    finetuning_type: str = "lora"  # lora | freeze | full | none
    num_layer_trainable: int = 3
    name_module_trainable: str = "mlp"
    lora_rank: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    lora_target: str = "q_proj,v_proj"
    neft_alpha: float = 0.0
    dpo_beta: float = 0.1  # reference reserves dpo knobs (parser.py:170-185)
    # ppo (reference reserves --stage ppo + knobs, parser.py:117-120,170-185,
    # and a --reward_model arg :74-76; runtime is new capability,
    # training/ppo.py)
    reward_model: Optional[str] = None  # --stage rm run dir (storage/<uid>)
    ppo_epochs: int = 2
    ppo_target: float = 6.0  # >0: adaptive KL controller target (reference
    # parser.py default 6.0 — adaptive KL is ON by default; pass 0 to disable)
    ppo_score_norm: bool = False
    init_kl_coef: float = 0.1
    ppo_gen_len: int = 64
    ppo_temperature: float = 1.0
    num_workers: int = 1
    storage_path: Optional[str] = None
    metrics_export_address: Optional[str] = None
    uid: Optional[str] = None
    # data (reference cmd/tuning/parser.py:224-247)
    train_path: Optional[str] = None
    evaluation_path: Optional[str] = None
    columns: Optional[str] = None
    block_size: int = 1024
    template: str = "llama2"  # reference hardcodes llama2 (train.py:63)
    pack_sequences: bool = False
    streaming: bool = False  # shuffle-buffered streaming ingest (sft/pt)
    shuffle_buffer: int = 2048
    # training loop (HF Seq2SeqTrainingArguments subset the pipeline uses)
    output_dir: str = "result"
    per_device_train_batch_size: int = 4
    per_device_eval_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-4
    num_train_epochs: float = 1.0
    max_steps: int = -1
    lr_scheduler_type: str = "cosine"
    optim: str = "adamw"
    warmup_ratio: float = 0.0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    logging_steps: int = 10
    save_steps: int = 0  # 0 = final only (reference behavior)
    eval_steps: int = 0  # 0 = once per epoch when eval set present
    seed: int = 42
    fp16: bool = False  # accepted for contract; bf16 is the TPU dtype
    bf16: bool = True
    # generative eval (reference GenEvalSeq2SeqTrainer, cmd/tuning/trainer.py)
    predict_with_generate: bool = False
    max_new_tokens: int = 64
    generate_examples: int = 32
    generate_eval_steps: int = 0  # 0 = end-of-run only; N = also every N steps
    # TPU additions
    prefetch_depth: int = 2  # batches in flight in the pipelined input path
    # (host prefetch + double-buffered device placement, data/prefetch.py);
    # 0 = synchronous feeding (the pre-pipeline loop). PPO always synchronous.
    profile_steps: int = 0  # capture a jax.profiler trace for N steps
    mesh: Optional[str] = None  # e.g. "dp=4,fsdp=2,tp=1,sp=1"
    attention: str = "xla"  # xla | flash | ring
    remat: str = "dots"  # none | dots | full
    deepspeed: Optional[str] = None  # accepted, ignored
    resume: bool = True  # auto-resume from latest checkpoint
    device: str = "cuda"  # cuda | cpu

    def __post_init__(self):
        if self.stage not in ("pt", "sft", "rm", "ppo", "dpo"):
            raise ValueError(f"invalid --stage {self.stage}")
        if self.stage in ("dpo", "rm", "ppo") and self.finetuning_type != "lora":
            raise ValueError(
                f"--stage {self.stage} requires --finetuning_type lora")
        if self.stage == "ppo" and self.train_path is not None \
                and not self.reward_model:
            raise ValueError(
                "--stage ppo requires --reward_model (an --stage rm run "
                "directory: <storage_path>/<uid>)")
        if self.streaming:
            if self.stage not in ("sft", "pt"):
                raise ValueError("--streaming supports stages sft/pt only")
            if self.max_steps <= 0:
                raise ValueError(
                    "--streaming needs --max_steps (epoch length is unknown "
                    "without materializing the stream)")
            if self.pack_sequences:
                raise ValueError(
                    "--streaming and --pack_sequences are exclusive (packing "
                    "needs the whole dataset to fill blocks densely)")
        if self.prefetch_depth < 0:
            raise ValueError("--prefetch_depth must be >= 0 (0 disables the "
                             "pipelined input path)")
        if self.finetuning_type not in ("lora", "freeze", "full", "none"):
            raise ValueError(f"invalid --finetuning_type {self.finetuning_type}")
        if self.quantization not in (None, "int4", "int8"):
            raise ValueError("We only accept int4 or int8 quantization.")
        if self.quant_impl not in ("xla", "pallas"):
            raise ValueError("quant_impl must be 'pallas' or 'xla'")
        if self.rope_scaling not in (None, "linear", "dynamic"):
            raise ValueError(f"invalid --rope_scaling {self.rope_scaling}")
        if self.train_path is None and self.export_dir is None:
            raise ValueError("--train_path must be specified")
        if self.storage_path is None:
            raise ValueError("--storage_path must be specified")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"invalid --device {self.device} (cuda | cpu)")

    @property
    def lora_targets(self) -> tuple:
        return tuple(t.strip() for t in self.lora_target.split(",") if t.strip())

    @property
    def columns_map(self) -> Optional[dict]:
        if not self.columns:
            return None
        text = self.columns
        if text.startswith('"') and text.endswith('"'):  # Go strconv.Quote
            text = json.loads(text)
        return json.loads(text)

    @property
    def mesh_dims(self) -> Optional[dict]:
        if not self.mesh:
            return None
        dims = {}
        for part in self.mesh.split(","):
            k, _, v = part.partition("=")
            dims[k.strip()] = int(v)
        return dims


_BOOLS = {"fp16", "bf16", "flash_attn", "shift_attn", "double_quantization",
          "pack_sequences", "resume", "predict_with_generate",
          "ppo_score_norm", "streaming"}
_ALIASES = {"lora_r": "lora_rank"}  # controller emits --lora_r


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="datatunerx-tpu-torch-train", allow_abbrev=False)
    for f in dataclasses.fields(TrainArgs):
        name = "--" + f.name
        if f.name in _BOOLS:
            # accept "--flag true/false" (Go emits values) and bare "--flag"
            p.add_argument(name, nargs="?", const="true",
                           default=None if f.default is None else str(f.default))
        elif f.default is dataclasses.MISSING:
            p.add_argument(name, required=True)
        else:
            p.add_argument(name, default=f.default)
    for alias, target in _ALIASES.items():
        p.add_argument("--" + alias, dest=target, default=argparse.SUPPRESS)
    return p


def parse_train_args(argv=None) -> TrainArgs:
    ns = vars(build_argparser().parse_args(argv))
    kwargs = {}
    for f in dataclasses.fields(TrainArgs):
        if f.name not in ns or ns[f.name] is None:
            continue
        raw = ns[f.name]
        if raw == "" and f.default is None:
            continue  # empty string clears an optional flag (controller may
            # emit e.g. --metrics_export_address "" / --quantization "")
        if f.name in _BOOLS:
            kwargs[f.name] = str(raw).lower() in ("true", "1", "yes")
        elif f.type in ("int", int):
            kwargs[f.name] = int(raw)
        elif f.type in ("float", float):
            kwargs[f.name] = float(raw)
        else:
            kwargs[f.name] = raw
    return TrainArgs(**kwargs)
