"""The training driver: one ``Trainer`` over the program's input pipeline,
driven through its first steps in set-up, then timed.

Set-up draws the weights (``harness/weights.py``), quantizes them with the
program where the job asks, builds the ``Trainer`` and its state, packs
the mix's documents with the program's packer (``data/loader.BatchIterator``)
and feeds it through ``data/prefetch.HostPrefetcher``. The first three
steps run through that same feed and call (and warm every shape: the
cell has one), and the state after them goes on into the window. The
window runs steps until ``--seconds`` have passed and ends at a
``synchronize``; it is the same in a traced run, which counts the
operations of the window's steps for ``mfu.train`` and then, after the
window, profiles ``traced_steps`` more steps in the device window and one
in the host window (``harness/trace.py``), each between two synchronizes.

After the window the program is freed and the reference follows the first
two steps from the same weights, documents and keys
(``reference/train.py``): two for three keeps it shorter than the window.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from dtxbench.harness import flops, trace, traffic, weights
from dtxbench.reference import model as ref_model
from dtxbench.reference import train as ref_train

FIRST_STEPS = 3
COMPARE_STEPS = 2


def _segments(batch) -> list:
    """The document lengths of a packed host batch."""
    out = []
    for row in np.asarray(batch["segment_ids"]):
        counts = np.bincount(row)
        out.extend(int(n) for n in counts[1:] if n)
    return out


def _ab(tree) -> dict:
    """The program's adapter tree as {target: [A, B]}, cloned."""
    return {t: [ab["a"].detach().clone(), ab["b"].detach().clone()]
            for t, ab in tree["layers"].items()}


def _epochs(it):
    e = 0
    while True:
        yield from it.epoch(e)
        e += 1


def _check_rows(batches, docs):
    """The reference's own look at the packed rows: every segment is one
    whole document of the mix, at positions 0..n-1, with its labels. Says
    what is wrong, or None."""
    known = {tuple(d["input_ids"]) for d in docs}
    for b in batches:
        ids, seg = np.asarray(b["input_ids"]), np.asarray(b["segment_ids"])
        pos, lab = np.asarray(b["positions"]), np.asarray(b["labels"])
        for r in range(ids.shape[0]):
            for s in np.unique(seg[r]):
                if s == 0:
                    continue
                at = np.nonzero(seg[r] == s)[0]
                toks = tuple(ids[r, at].tolist())
                if toks not in known:
                    return "a packed segment is not a document of the mix"
                if not np.array_equal(pos[r, at], np.arange(len(at))):
                    return "a packed segment's positions are not 0..n-1"
                want = [traffic.IGNORE] + list(toks[1:])
                if lab[r, at].tolist() != want:
                    return "a packed segment's labels are not its document's"
    return None


def run(ctx) -> dict:
    from datatunerx_tpu_torch.data.loader import BatchIterator
    from datatunerx_tpu_torch.data.prefetch import HostPrefetcher, PipelineStats
    from datatunerx_tpu_torch.ops.quant import quantize_model_params
    from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer
    from datatunerx_tpu_torch.utils.hf_convert import config_from_hf

    c, job, dev = ctx.config, ctx.workload["job"], ctx.device
    cuda = dev.type == "cuda"
    mc = dataclasses.replace(
        config_from_hf(c), attention_impl=job["attention"],
        remat=job["remat"], quantization=job.get("quantization"),
        quant_impl=job.get("quant_impl", "xla"))
    timings = {}
    if cuda:
        from datatunerx_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.library()
        timings["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = weights.model_params(c, ctx.config_name, ctx.seed, dev)
    if mc.quantization:
        params = quantize_model_params(params, mc.quantization)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    timings["weights_s"] = time.perf_counter() - t

    train_seed = int(ctx.seed) % 2 ** 31
    tc = TrainConfig(
        finetuning_type="lora", lora_rank=job["lora_rank"],
        lora_alpha=job["lora_alpha"], lora_dropout=job["lora_dropout"],
        lora_targets=tuple(job["lora_targets"]),
        learning_rate=job["learning_rate"], scheduler="cosine",
        optimizer="adamw", max_grad_norm=job["max_grad_norm"],
        total_steps=job["total_steps"], compute_dtype=torch.bfloat16)
    trainer = Trainer(mc, tc, device=dev)
    state = trainer.init_state(params, rng=train_seed)
    del params

    docs = traffic.packed_docs(ctx.traffic, ctx.seed, c["vocab_size"])
    rows = BatchIterator(docs, global_batch=job["batch"],
                         block_size=job["block"], pack=True,
                         seed=train_seed)
    stats = PipelineStats()
    feed = HostPrefetcher(lambda: _epochs(rows), depth=2, stats=stats)
    step = trainer.train_step
    if ctx.fault is not None:
        step = ctx.fault(step)

    # the first steps: the warm-up, and what the reference follows
    compare = COMPARE_STEPS
    init = _ab(state.lora)
    first_batches, losses = [], []
    for i in range(FIRST_STEPS):
        b = next(feed)
        first_batches.append(b)
        state, m = step(state, b)
        losses.append(m["loss"])
        if i == 0:
            mu1 = _ab(state.opt_state["mu"])
        if i + 1 == compare:
            changed = _ab(state.lora)
    if cuda:
        torch.cuda.synchronize()
    stats.snapshot()
    setup_s = time.perf_counter() - ctx.t_start

    tokens, n_steps, segs = 0, 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        b = next(feed)
        tokens += int((np.asarray(b["segment_ids"]) > 0).sum())
        if ctx.trace:
            segs.extend(_segments(b))
        state, _ = step(state, b)
        n_steps += 1
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    wait = stats.snapshot().get("pipe_step_wait_ms")
    out = {"attempted": n_steps, "failed": 0,
           "timings": dict(timings, setup_s=setup_s),
           "e2e": {"train_tokens_per_s": tokens / seconds,
                   "setup_s": setup_s}}
    if ctx.trace:
        shapes = flops.Shapes(c)
        lc = {"kernels": ctx.kernels, "step_wait_ms": wait,
              "window_flops": flops.train_step_flops(
                  shapes, segs, job["lora_targets"], job["lora_rank"]),
              "window_s": seconds}
        traced = []
        for host, n in ((False, int(ctx.workload.get("traced_steps", 3))),
                        (True, 1)):
            win, state, tsegs = _traced(state, feed, step, n, host, cuda)
            lc["host" if host else "window"] = win
            traced.append(tsegs)
        N = sum(traced[0])
        attn = flops.train_attention(shapes, traced[0])
        lc["attention_least_s"] = flops.least_s(*attn)
        lc["nf4_least_s"] = (flops.train_nf4(shapes, N)[1]
                             if job.get("quantization") else None)
        out["layer_ctx"] = lc
    feed.close()
    out["memory_peak"] = torch.cuda.max_memory_allocated() if cuda else 0

    prog = ref_train.readings(
        [float(x) for x in losses[:compare]],
        {t: [x / (1 - ref_train.B1) for x in ab] for t, ab in mu1.items()},
        changed, init)
    del state, trainer, feed, rows, mu1, changed, init, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    batches = first_batches[:compare]
    bad = _check_rows(batches, docs)
    t = time.perf_counter()
    ref_model.no_tf32()
    W = ref_model.Weights(c, ctx.config_name, ctx.seed, dev,
                          quant="nf4" if mc.quantization in ("int4", "nf4")
                          else "")
    ref = ref_train.readings(*ref_train.run(W, batches, job, train_seed,
                                            compare))
    out["timings"]["reference_s"] = time.perf_counter() - t
    nums = ref_train.numbers(prog, ref)
    out["compared"] = [(k, nums.get(k), ctx.workload["limits"][k])
                       for k in ctx.workload["limits"]]
    if ctx.control:
        # the control: the reference in fp8 put in the program's place
        low = ref_train.readings(*ref_train.run(W, batches, job, train_seed,
                                                compare, prec="fp8"))
        out["control"] = ref_train.numbers(low, ref)
    out["problem"] = bad
    return out


def _traced(state, feed, step, n, host, cuda):
    """``n`` steps under a profiler, between two synchronizes: (the
    stopped window, the state, the steps' document lengths)."""
    if cuda:
        torch.cuda.synchronize()
    prof = trace.start(host)
    t0 = trace.now()
    segs = []
    for _ in range(n):
        b = next(feed)
        segs.extend(_segments(b))
        state, _ = step(state, b)
    if cuda:
        torch.cuda.synchronize()
    t1 = trace.now()
    prof.stop()
    return trace.Window(prof, t0, t1), state, segs
