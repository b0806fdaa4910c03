"""Trainer entry point: ``python -m datatunerx_tpu_torch.tuning.train
--model_name_or_path … --train_path … --storage_path …`` (the port of
``datatunerx_tpu/tuning/train.py``): the sft, pt, dpo, rm
and ppo stages (ppo against the ``--reward_model`` of an rm run), every
optimizer, QLoRA with ``--quantization int4|int8`` (the base is quantized
on the device right after load, the adapters train, and the export
dequantizes), ``--streaming`` ingest and ``--predict_with_generate``
(rouge/bleu over greedy generations at the end of the run, and every
``--generate_eval_steps`` steps). Datasets, the storage path and the
manifest may be object-store URIs (``utils/storage``); the output and
export directories are written with plain file IO, as the reference
writes them.

  parse → process group → load model + tokenizer → template/encode/pack
  (or a stream) → mesh → Trainer → (resume?) → epoch loop [train_step,
  log, eval, generative eval, save] → final eval → final checkpoint →
  generative eval → completion manifest → merged export

Runs on CUDA unless ``--device cpu``; without a GPU it raises. Several
processes (``--num_workers`` or the ``DTX_*`` env of
``parallel/distributed.py``: one process a card, NCCL on CUDA, gloo with
``--device cpu``) train as one over ``--mesh "dp=…,fsdp=…,tp=…,sp=…,dcn=…"``
(the None-axis absorption of ``mesh_shape_for``): each rank reads its
data-parallel rows of every global batch; only rank 0 logs and writes the
checkpoint, the manifest and the export (whole: the ranks gather their
shards first). ``--stage ppo`` under a mesh takes each rank's prompt rows
whole (the rollout decodes whole prompts); rank 0 writes the adaptive KL
controller's state beside the checkpoints.
"""

from __future__ import annotations

import itertools
import math
import os
import sys

import torch

from datatunerx_tpu_torch.data.loader import (
    BatchIterator,
    CsvDataset,
    PreferenceBatchIterator,
    PromptBatchIterator,
    StreamingBatchIterator,
    StreamingCsvDataset,
)
from datatunerx_tpu_torch.data.prefetch import (
    HostPrefetcher,
    MetricsBuffer,
    PipelineStats,
    prefetch_batches,
)
from datatunerx_tpu_torch.data.preprocess import (
    preprocess_preference_records,
    preprocess_pretrain_records,
    preprocess_prompt_records,
    preprocess_records,
)
from datatunerx_tpu_torch.data.templates import get_template
from datatunerx_tpu_torch.models.lora import target_dims
from datatunerx_tpu_torch.ops.quant import (
    dequantize_model_params,
    quantize_model_params,
)
from datatunerx_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from datatunerx_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from datatunerx_tpu_torch.parallel.sharding import place_batch
from datatunerx_tpu_torch.training.checkpoint import (
    CheckpointManager,
    export_merged_model,
    write_manifest,
)
from datatunerx_tpu_torch.training.generate import generative_eval
from datatunerx_tpu_torch.training.metrics_log import MetricsLogger
from datatunerx_tpu_torch.training.ppo import (
    PPOConfig,
    PPOTrainer,
    load_controller_state,
    load_reward_model,
    save_controller_state,
)
from datatunerx_tpu_torch.training.train_lib import (
    TrainConfig,
    Trainer,
    resolve_device,
)
from datatunerx_tpu_torch.tuning.parser import TrainArgs, parse_train_args
from datatunerx_tpu_torch.utils import storage
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer


class _QuietLogger:
    """The logger of a rank other than 0: logging stays on rank 0."""

    def log_train(self, *a, **k):
        pass

    log_eval = attach_prefetcher = log_train

    def effective_prefetch_depth(self):
        return None


def build_mesh(args: TrainArgs, world: int):
    """(shape, mesh) as the reference's CLI builds its mesh: ``--mesh``
    dims, the ``dcn`` factor popped, the unset data axis absorbing the
    rest (``fsdp`` defaults to 1 when ``dp`` is given)."""
    dims = dict(args.mesh_dims or {})
    dcn_dp = int(dims.pop("dcn", 1) or 1)
    shape = mesh_shape_for(
        world, dp=dims.get("dp"),
        fsdp=dims.get("fsdp", 1 if "dp" in dims else None),
        tp=dims.get("tp", 1), sp=dims.get("sp", 1))
    return shape, make_mesh(shape, dcn_dp=dcn_dp)


def run(args: TrainArgs) -> dict:
    dist_info = maybe_initialize_distributed(args.num_workers, args.device)
    is_main = dist_info["process_id"] == 0
    device = resolve_device(args.device)

    # ----- model -------------------------------------------------------
    overrides = dict(remat=args.remat, attention_impl=args.attention)
    if args.rope_scaling:
        overrides.update(rope_scaling_type=args.rope_scaling,
                         rope_scaling_factor=args.rope_scaling_factor)
    if args.quantization:
        if args.quantization == "int4" and args.quantization_type == "fp4":
            raise NotImplementedError(
                "fp4 is not supported; use nf4 (the reference default, "
                "cmd/tuning/parser.py:45-47)")
        if args.finetuning_type != "lora":
            raise ValueError(
                "--quantization requires finetuning_type lora (quantized "
                "base weights are frozen, as with bitsandbytes+peft)")
        overrides["quantization"] = args.quantization
        overrides["quant_impl"] = args.quant_impl
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg, params, tokenizer = load_model_and_tokenizer(
        args.model_name_or_path, dtype=dtype, seed=args.seed, device=device,
        config_overrides=overrides)

    # export-only invocation: --export_dir with no --train_path
    if args.train_path is None:
        export_merged_model(params, cfg, args.export_dir)
        return {"steps": 0, "metrics": {}, "manifest": None,
                "checkpoint_dir": None, "export_dir": args.export_dir}

    if args.quantization:
        # on the device; deterministic, so a resume re-quantizes the reloaded
        # base to the same bytes (the checkpoint holds only the adapters)
        params = quantize_model_params(params, args.quantization)

    # ----- data --------------------------------------------------------
    template = get_template(args.template, tokenizer)
    pad_id = tokenizer.pad_token_id or 0

    preference = args.stage in ("dpo", "rm")
    ppo = args.stage == "ppo"

    def encode(records):
        if preference:
            return preprocess_preference_records(
                records, template, tokenizer, cutoff_len=args.block_size,
                columns=args.columns_map)
        if ppo:
            return preprocess_prompt_records(
                records, template, tokenizer, cutoff_len=args.block_size,
                columns=args.columns_map)
        if args.stage == "pt":
            return preprocess_pretrain_records(
                records, tokenizer, cutoff_len=args.block_size,
                columns=args.columns_map)
        return preprocess_records(records, template, tokenizer,
                                  cutoff_len=args.block_size,
                                  columns=args.columns_map)

    train_examples = None
    if not args.streaming:  # a stream is encoded lazily by its iterator
        train_examples = encode(
            CsvDataset(args.train_path, columns=args.columns_map).records)
        if not train_examples:
            raise RuntimeError("Empty dataset!")
    eval_examples = eval_records = None
    if args.evaluation_path and ppo:
        print("[ppo] --evaluation_path ignored: PPO's held-out signal is the "
              "reward/KL curve, not a loss over a fixed eval set", flush=True)
    elif args.evaluation_path:
        eval_records = CsvDataset(args.evaluation_path,
                                  columns=args.columns_map).records
        eval_examples = encode(eval_records)
        if args.stage != "sft":  # generation reads instruction/response
            eval_records = None

    # ----- mesh --------------------------------------------------------
    shape, mesh = build_mesh(args, dist_info["num_processes"])
    data_par = shape[0] * shape[1]
    host = dict(host_id=mesh.data_index if mesh is not None else 0,
                num_hosts=data_par)

    grad_accum = args.gradient_accumulation_steps
    if ppo:
        if grad_accum > 1:
            print(f"[ppo] --gradient_accumulation_steps {grad_accum} ignored:"
                  " a PPO step already makes ppo_epochs optimization passes "
                  "per rollout batch", flush=True)
        grad_accum = 1
    global_batch = args.per_device_train_batch_size * data_par * grad_accum
    iterator_cls = (PreferenceBatchIterator if preference else
                    PromptBatchIterator if ppo else
                    BatchIterator)
    if args.streaming:
        it = StreamingBatchIterator(
            StreamingCsvDataset(args.train_path, columns=args.columns_map),
            template, tokenizer, global_batch=global_batch,
            block_size=args.block_size, pad_id=pad_id, grad_accum=grad_accum,
            buffer_size=args.shuffle_buffer, seed=args.seed,
            stage=args.stage, **host)
        # a stream's length is unknown: the loop re-opens it (a new shuffle
        # order) until max_steps (required with --streaming) land
        total_steps = steps_per_epoch = args.max_steps
    else:
        it = iterator_cls(
            train_examples, global_batch=global_batch,
            block_size=args.block_size, pad_id=pad_id, grad_accum=grad_accum,
            seed=args.seed, pack=args.pack_sequences, **host)
        steps_per_epoch = it.steps_per_epoch()
        if steps_per_epoch == 0:
            raise RuntimeError(
                f"dataset ({len(train_examples)} examples) smaller than one "
                f"global batch ({global_batch})")
        total_steps = (args.max_steps if args.max_steps > 0 else
                       int(math.ceil(steps_per_epoch * args.num_train_epochs)))

    # ----- trainer -----------------------------------------------------
    tcfg = TrainConfig(
        finetuning_type=args.finetuning_type,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout,
        lora_targets=args.lora_targets,
        num_layer_trainable=args.num_layer_trainable,
        name_module_trainable=args.name_module_trainable,
        learning_rate=args.learning_rate,
        scheduler=args.lr_scheduler_type,
        optimizer=args.optim,
        warmup_ratio=args.warmup_ratio,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        # a PPO step makes ppo_epochs optimizer updates and the schedule
        # counts updates: the horizon scales so the LR decays over the run
        total_steps=(total_steps * max(args.ppo_epochs, 1) if ppo
                     else total_steps),
        grad_accum=grad_accum,
        neftune_alpha=args.neft_alpha,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        stage=args.stage if preference or ppo else "sft",
        dpo_beta=args.dpo_beta,
    )
    if ppo:
        reward_lora, reward_scaling = load_reward_model(
            cfg, params, args.reward_model, device=device)
        trainer = PPOTrainer(
            cfg, tcfg,
            PPOConfig(gen_len=args.ppo_gen_len,
                      temperature=args.ppo_temperature,
                      kl_coef=args.init_kl_coef, ppo_target=args.ppo_target,
                      ppo_epochs=args.ppo_epochs,
                      score_norm=args.ppo_score_norm),
            reward_lora=reward_lora, reward_scaling=reward_scaling,
            eos_id=tokenizer.eos_token_id, pad_id=pad_id, device=device,
            mesh=mesh)
    else:
        trainer = Trainer(cfg, tcfg, device=device, mesh=mesh)
    state = trainer.init_state(params, args.seed)

    run_name = args.uid or os.path.basename(args.output_dir.rstrip("/")) \
        or "run"
    ckpt_dir = storage.join(args.storage_path, run_name, "checkpoints")
    ckpt = CheckpointManager(ckpt_dir, save_interval_steps=args.save_steps)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        # every rank reads the whole checkpoint and keeps its shards
        state, start_step = ckpt.restore(trainer.gather_state(state))
        state = trainer.place_state(state)
        if ppo:
            cs = load_controller_state(ckpt_dir)
            if cs is not None:
                trainer.kl_coef = float(cs["kl_coef"])
        print(f"[resume] restored step {start_step} from {ckpt_dir}",
              flush=True)

    logger = MetricsLogger(
        args.output_dir, total_steps,
        metrics_export_address=args.metrics_export_address, uid=args.uid,
        # the prefetch advisory suggests (and retunes to) a deeper depth
        # when pipe_step_wait_ms says the step loop waits on the input path
        prefetch_depth=args.prefetch_depth) if is_main else _QuietLogger()

    def save(at: int, force: bool = False) -> bool:
        """A checkpoint when due: every rank gathers, rank 0 writes."""
        if not ckpt.due(at, force):
            return False
        whole = trainer.gather_state(state) if mesh is not None else state
        if is_main:
            ckpt.maybe_save(whole, at, force=True)
        return True

    # ----- loop --------------------------------------------------------
    # profiling: a torch.profiler window over steps [start+1, start+1+N);
    # the chrome trace lands in <output_dir>/trace and in the manifest
    trace_dir = os.path.join(args.output_dir, "trace")
    prof = None
    prof_until = None
    profiled = False
    # a stream tokenizes inside the prefetch worker: with in-training
    # generative eval encoding on this thread, each thread gets its own
    # tokenizer copy, or (not copyable) the pipeline stays synchronous
    gen_in_training = (args.predict_with_generate and eval_records
                       and args.generate_eval_steps > 0)
    # PPO keeps the synchronous path: its step interleaves generation
    # with optimization and places the prompt batches itself
    pipelined = args.prefetch_depth > 0 and not ppo
    if pipelined and args.streaming and gen_in_training \
            and not it.ensure_thread_safe_encoding():
        pipelined = False
        print("[pipeline] disabled: --streaming with in-training generative "
              "eval shares one tokenizer that cannot be copied", flush=True)
    lora_run = tcfg.finetuning_type == "lora"
    step_fn = trainer.step if ppo else trainer.train_step
    pipe_stats = PipelineStats() if pipelined else None
    # step outputs stay on the device and resolve one logging interval
    # late, so a logging boundary never drains the stream
    mbuf = MetricsBuffer(lag=1)
    final_metrics: dict = {}

    def log_resolved(resolved):
        for s_done, host in resolved:
            logger.log_train(s_done, host)
            final_metrics.clear()
            final_metrics.update(host)

    step = 0  # counts up through start_step (skipping those batches)
    done = False
    epochs = (itertools.count() if args.streaming
              else range(int(math.ceil(total_steps / steps_per_epoch))))
    try:
        for epoch in epochs:
            if done:
                break
            saw_batch = False
            src = it.epoch(epoch)
            # resumed: fast-forward on host batches before the pipeline
            # starts, so skipped batches never reach the device
            exhausted = False
            while step < start_step and step < total_steps:
                if next(src, None) is None:
                    exhausted = True
                    break
                saw_batch = True
                step += 1
            if step >= total_steps:
                break
            host_pf: HostPrefetcher | None = None
            if mesh is not None and not ppo:
                # this rank's sequence chunk, labels shifted, on the host
                src = (place_batch(b, mesh, accum=grad_accum > 1)
                       for b in src)
            if exhausted:
                batches = iter(())
            elif pipelined:
                # a retuned depth carries into every later epoch
                batches, host_pf = prefetch_batches(
                    src, device=device,
                    depth=logger.effective_prefetch_depth()
                    or args.prefetch_depth,
                    stats=pipe_stats)
                logger.attach_prefetcher(host_pf)
            else:
                batches = src
            try:
                for batch in batches:
                    saw_batch = True
                    if step >= total_steps:
                        done = True
                        break
                    if (prof is None and not profiled and is_main
                            and args.profile_steps > 0
                            and step >= start_step + 1):
                        prof = _start_profiler(device)
                        prof_until = step + args.profile_steps
                    state, metrics = step_fn(state, batch)
                    step += 1
                    if prof is not None and step >= prof_until:
                        _stop_profiler(prof, device, trace_dir)
                        prof, profiled = None, True
                    if step % args.logging_steps == 0 or step == total_steps:
                        extra = {"epoch": round(step / steps_per_epoch, 3)}
                        if pipe_stats is not None:
                            extra.update(pipe_stats.snapshot())
                        mbuf.push(step, metrics, extra)
                        log_resolved(mbuf.pop_ready())
                    if args.save_steps > 0 and save(step) and ppo \
                            and is_main:
                        save_controller_state(ckpt_dir, step, trainer.kl_coef)
                    if (eval_examples and args.eval_steps > 0
                            and step % args.eval_steps == 0):
                        _run_eval(trainer, state, eval_examples, args,
                                  pad_id, logger, step, host)
                    if (gen_in_training and step < total_steps
                            and step % args.generate_eval_steps == 0):
                        # a small sample at intervals, so rouge/bleu have
                        # curves; the final step gets the full pass below
                        _generate(trainer.gather_state(state), trainer, cfg,
                                  tokenizer, template, eval_records, args,
                                  lora_run, logger, step,
                                  min(args.generate_examples, 8), is_main)
            finally:
                if host_pf is not None:
                    host_pf.close()
            if (eval_examples and args.eval_steps == 0 and not done
                    and step < total_steps):
                _run_eval(trainer, state, eval_examples, args, pad_id,
                          logger, step, host)
            if not saw_batch:  # a stream's pass gave no full batch
                if step == 0:
                    raise RuntimeError("Empty dataset!")
                break
    finally:
        # also on a crash: resolve buffered records rather than drop them
        log_resolved(mbuf.drain())
    if prof is not None:  # the window reached past the last step
        _stop_profiler(prof, device, trace_dir)
        profiled = True

    # ----- final eval / save / manifest / export -------------------------
    if eval_examples:
        final_metrics.update(_run_eval(trainer, state, eval_examples, args,
                                       pad_id, logger, step, host))
    save(step, force=True)
    if ppo and is_main:
        save_controller_state(ckpt_dir, step, trainer.kl_coef)
    whole = trainer.gather_state(state)  # every rank takes part
    if args.predict_with_generate and eval_records:
        final_metrics.update(_generate(
            whole, trainer, cfg, tokenizer, template, eval_records, args,
            lora_run, logger, step, args.generate_examples, is_main))
    if not is_main:
        return {"steps": step, "metrics": final_metrics, "manifest": None,
                "checkpoint_dir": ckpt_dir}
    manifest_path = write_manifest(
        args.storage_path, run_name, storage.join(ckpt_dir, str(step)),
        metrics=final_metrics,
        extra={
            "model": args.model_name_or_path,
            "finetuning_type": args.finetuning_type,
            # serving merges the adapter with THIS scaling (alpha/rank)
            "lora_scaling": trainer.scaling if lora_run else None,
            "lora_alpha": args.lora_alpha if lora_run else None,
            "lora_rank": args.lora_rank if lora_run else None,
            "lora_targets": list(args.lora_targets) if lora_run else None,
            "stage": args.stage,
            "optimizer": args.optim,
            "reward_model": args.reward_model,
            "template": args.template,
            "mesh": dict(zip(("dp", "fsdp", "tp", "sp"), shape)),
            "steps": step,
            "trace": trace_dir if profiled else None,
        },
    )
    if args.export_dir:
        export_params = whole.params
        if args.quantization:  # the export holds full (dequantized) kernels
            export_params = dequantize_model_params(
                export_params, args.quantization,
                dims_fn=lambda n: target_dims(cfg, n))
        export_merged_model(export_params, cfg, args.export_dir,
                            lora=whole.lora if lora_run else None,
                            scaling=trainer.scaling)
    return {"steps": step, "metrics": final_metrics,
            "manifest": manifest_path, "checkpoint_dir": ckpt_dir}


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, device, trace_dir: str):
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the window holds finished steps
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    print(f"[profile] trace captured to {trace_dir}", flush=True)


def _run_eval(trainer, state, eval_examples, args, pad_id, logger, step,
              host):
    iterator_cls = (PreferenceBatchIterator if args.stage in ("dpo", "rm")
                    else BatchIterator)
    eval_it = iterator_cls(
        eval_examples,
        global_batch=args.per_device_eval_batch_size * host["num_hosts"],
        block_size=args.block_size, pad_id=pad_id, shuffle=False,
        drop_remainder=False,  # pad the tail: every eval example counts
        **host)
    m = trainer.evaluate(state, eval_it.epoch(0))
    if args.stage in ("dpo", "rm"):
        # eval_loss is the mean pairwise loss: exp of it is no perplexity
        m.pop("perplexity", None)
    logger.log_eval(step, m)
    return m


def _generate(state, trainer, cfg, tokenizer, template, records, args,
              lora_run, logger, step, max_examples, is_main=True) -> dict:
    """Greedy generations over the eval records, scored and logged (rank 0
    of a multi-process run, on the whole state); a failure is printed and
    never ends a run."""
    if not is_main:
        return {}
    try:
        m = generative_eval(
            state.params, cfg, tokenizer, template, records, args.output_dir,
            lora=(state.lora, trainer.scaling) if lora_run else None,
            max_new_tokens=args.max_new_tokens, max_examples=max_examples,
            columns=args.columns_map)
    except Exception as e:  # noqa: BLE001 — never lose a run to an eval
        print(f"[generate@{step}] failed (run preserved): {e}", flush=True)
        return {}
    if m:
        logger.log_eval(step, m)
    return m


def _leave_process_group():
    """Every rank reaches the end before any tears its group down: a rank
    that exits while another still holds the group's store or its gloo
    pairs can abort that one at interpreter exit."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None):
    args = parse_train_args(argv)
    result = run(args)
    print(f"[done] {result['steps']} steps; manifest: {result['manifest']}",
          flush=True)
    _leave_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
