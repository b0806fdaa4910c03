"""The serving driver: the program's ``BatchedEngine`` in this process,
fed token ids through ``submit`` by an open loop.

Set-up draws the weights (``harness/weights.py``) and hands them to the
engine in place of a checkpoint, builds the engine with the cell's
settings, warms it with requests of the mix's own shapes, then starts the
schedule ``ramp_s`` before the window so the window opens on a loaded
engine (the ramp is set-up). Requests are sent at their due times whether
or not earlier ones have finished; each is timed from its due time.

The window's rate counts every token the engine emitted between its two
ends. The cells run above the knee, where the queue grows through the
window: what the engine finished is judged, what still waits at the close
is neither timed nor failed. A traced run has the same window; its
per-layer latencies come from the engine's stamps of the window's
requests, and after the window, while the mix's traffic goes on, it
profiles ``traced_seconds`` in the device window and as long in the host
window (``harness/trace.py``), each from one decode chunk's tokens to
another's.

After the window the engine is freed and the reference runs one full
forward over a sample of the finished requests, greedy and sampled apart,
the longest of each among them (``reference/serve.py``).
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from dtxbench.harness import flops, trace, traffic, weights
from dtxbench.reference import model as ref_model
from dtxbench.reference import serve as ref_serve


def _sleep_until(t: float, poll=None):
    while True:
        if poll is not None:
            poll()
        d = t - time.perf_counter()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def _emitted(sent) -> int:
    return sum(len(r.tokens) for _, r in sent)


def _boundary(sent, timeout: float = 5.0):
    """Wait until a decode chunk's tokens land (the emitted count moves)."""
    n0 = _emitted(sent)
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        time.sleep(0.0005)
        if _emitted(sent) != n0:
            return


def build_engine(ctx):
    """The engine over the benchmark's weights, warmed: (engine, timings)."""
    from datatunerx_tpu_torch.serving import batched_engine as be
    from datatunerx_tpu_torch.utils.decoding import DECODE_BUCKET
    from datatunerx_tpu_torch.utils.hf_convert import config_from_hf
    from datatunerx_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

    c, wl, dev = ctx.config, ctx.workload, ctx.device
    mc = config_from_hf(c)
    timings = {}
    if dev.type == "cuda":
        from datatunerx_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.library()
        timings["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = weights.model_params(c, ctx.config_name, ctx.seed, dev)
    timings["weights_s"] = time.perf_counter() - t

    loader = be.load_model_and_tokenizer
    be.load_model_and_tokenizer = (
        lambda *a, **k: (mc, params, SimpleTokenizer()))
    try:
        eng = be.BatchedEngine("benchmark:weights", device=dev,
                               **wl["engine"])
    finally:
        be.load_model_and_tokenizer = loader
    del params
    if ctx.fault is not None:
        ctx.fault(eng)

    # warm-up: one prompt a chunk length (a whole chunk, then each tail of
    # a bucket multiple), decoding a few tokens at the full slot count,
    # greedy and sampled
    t = time.perf_counter()
    rng = np.random.default_rng(1)
    chunk = eng.prefill_chunk
    ws = [eng.submit(rng.integers(3, c["vocab_size"], chunk + n).tolist(),
                     max_new_tokens=16, temperature=0.8 if n % 128 else 0.0,
                     seed=n)
          for n in range(DECODE_BUCKET, chunk + 1, DECODE_BUCKET)]
    for r in ws:
        r.done.wait(300)
    timings["warm_s"] = time.perf_counter() - t
    return eng, timings


def _profile(sent, host: bool, seconds: float) -> dict:
    """``seconds`` of the running engine under a profiler, from one decode
    chunk's tokens to another's: the stopped profiler, the window's bounds
    on Kineto's clock and on the host's, and each request's token count at
    both."""
    prof = trace.start(host)
    _boundary(sent)
    ph = {"t0": trace.now(), "p0": time.perf_counter(),
          "n0": [len(r.tokens) for _, r in list(sent)]}
    _sleep_until(ph["p0"] + seconds)
    _boundary(sent)
    ph.update(t1=trace.now(), p1=time.perf_counter(),
              n1=[len(r.tokens) for _, r in list(sent)])
    prof.stop()
    ph["prof"] = prof
    return ph


def run(ctx) -> dict:
    c, wl, dev = ctx.config, ctx.workload, ctx.device
    cuda = dev.type == "cuda"
    eng, timings = build_engine(ctx)
    mix = ctx.traffic
    V = c["vocab_size"]

    traced_s = float(wl.get("traced_seconds", 4.0))
    # a traced run's traffic goes on after the window while it profiles
    tail = 2 * traced_s + 10.0 if ctx.trace else 0.0
    sched = traffic.open_loop(mix, ctx.seed, V, ctx.seconds, tail)
    ramp = float(mix.get("ramp_s", 0.0))
    sent = []  # (schedule entry with "due", Request)
    T0 = time.perf_counter() + 0.05
    w0, w1 = T0 + ramp, T0 + ramp + ctx.seconds
    snaps, phases, kv = {}, {}, [0]
    closed = threading.Event()

    def kv_peak():
        used = eng.kv_blocks_reserved
        if used is not None and used > kv[0]:
            kv[0] = used

    def watch():
        _sleep_until(w0, kv_peak)
        snaps["w0"] = (time.perf_counter(), _emitted(sent))
        _sleep_until(w1, kv_peak)
        snaps["w1"] = (time.perf_counter(), _emitted(sent))
        if ctx.trace:
            for host in (False, True):
                phases[host] = _profile(sent, host, traced_s)
        closed.set()

    late = [0.0]

    def submit_all():
        for r in sched:
            due = T0 + r["t"]
            _sleep_until(due)
            if closed.is_set() and due >= w1:  # the tail ends with tracing
                return
            if due < w1:
                late[0] = max(late[0], time.perf_counter() - due)
            req = eng.submit(r["prompt"], max_new_tokens=r["max_new"],
                             temperature=r["temperature"], seed=r["seed"])
            sent.append((dict(r, due=due), req))

    # the open loop on its own thread; this one keeps the window (a
    # profiler is started and stopped on the thread that made it)
    loop = threading.Thread(target=submit_all, name="dtxbench-open-loop")
    loop.start()
    watch()
    loop.join()
    setup_s = w0 - ctx.t_start

    inside = [(r, q) for r, q in sent if w0 <= r["due"] < w1]
    # above the knee the queue grows through the window: what it
    # finished is judged, what still waits is not a failure
    broken = [q for _, q in inside if q.done.is_set() and q.error is not None]
    errors = sorted({q.error for q in broken})
    (t_a, n_a), (t_b, n_b) = snaps["w0"], snaps["w1"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = {"attempted": len(inside), "failed": len(broken),
           "memory_peak": peak,
           "timings": dict(timings, setup_s=setup_s,
                           generator_late_s=late[0],
                           kv_blocks_peak=kv[0],
                           kv_blocks=eng.total_kv_blocks),
           "e2e": {"serve_output_tokens_per_s": (n_b - n_a) / (t_b - t_a),
                   "setup_s": setup_s}}
    if ctx.trace:
        out["layer_ctx"] = _layer_ctx(phases, sent, c, ctx, w0, w1)

    # the samples the reference judges, drawn from the seed: finished
    # greedy and sampled requests apart, the longest of each first
    done = [(r, list(q.tokens)) for r, q in sent
            if q.done.is_set() and q.error is None and q.tokens]
    budget = int(wl.get("check_tokens", 600))
    greedy = ref_serve.draw_sample(
        [d for d in done if d[0]["temperature"] == 0.0], ctx.seed, budget)
    drawn = ref_serve.draw_sample(
        [d for d in done if d[0]["temperature"] > 0.0], ctx.seed + 1, budget)
    eng.close()
    restore = getattr(eng, "_dtxbench_restore", None)
    if restore is not None:
        restore()
    del eng, sent, inside, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    gap = draw = None
    ref_model.no_tf32()
    W = ref_model.Weights(c, ctx.config_name, ctx.seed, dev)
    greedy_in = [(r["prompt"], toks) for r, toks in greedy]
    drawn_in = [(r["prompt"], toks, r["seed"], r["temperature"])
                for r, toks in drawn]
    if greedy_in:
        gap = max(max(g) for g in ref_serve.served_gaps(W, greedy_in))
    if drawn_in:
        draw = max(max(g) for g in ref_serve.draw_gaps(W, drawn_in))
    if ctx.control and greedy_in and drawn_in:
        # the control: the reference in fp8 in the program's place, read
        # at the same positions with the same uniforms
        out["control"] = {
            "max_logit_gap": max(max(g) for g in ref_serve.served_gaps(
                W, greedy_in, prec="fp8", chooser="own")),
            "max_draw_gap": max(max(g) for g in ref_serve.draw_gaps(
                W, drawn_in, prec="fp8", chooser="own"))}
    del W
    out["timings"]["reference_s"] = time.perf_counter() - t
    out["timings"]["checked_tokens"] = sum(len(x) for _, x in greedy_in)
    out["timings"]["checked_draws"] = sum(len(x) for _, x, _, _ in drawn_in)
    lim = wl["limits"]
    out["compared"] = [("max_logit_gap", gap, lim["max_logit_gap"]),
                       ("max_draw_gap", draw, lim["max_draw_gap"])]
    missing = [k for k, v in (("greedy", greedy_in), ("sampled", drawn_in))
               if not v]
    out["problem"] = ("; ".join(errors) if errors else
                      f"no finished {' or '.join(missing)} request to check"
                      if missing else None)
    return out


def _work(ph, sent, s) -> dict:
    """The decode and prefill work of one profiled phase: the tokens each
    request gained between its bounds, and the prefill chunks stamped
    inside them."""
    dec_flops = dec_attn_flops = dec_bytes = 0.0
    for k, (r, q) in enumerate(sent[:len(ph["n1"])]):
        n0 = ph["n0"][k] if k < len(ph["n0"]) else 0
        P = len(r["prompt"])
        for j in range(max(n0, 1), ph["n1"][k]):  # token 0 is prefill's
            dec_flops += flops.decode_token_flops(s, P + j)
            dec_attn_flops += flops.decode_attention_flops(s, P + j)
            dec_bytes += flops.decode_kv_bytes(s, P + j)
    pre_flops = pre_least = 0.0
    for r, q in sent:
        P = len(r["prompt"])
        lo = None
        for stamp, event, detail in list(q.timeline):
            if event == "admit":
                lo, pad = 0, detail["plen"] - P
            elif event == "prefill" and lo is not None:
                n = detail["tokens"]
                real = max(0, lo + n - max(lo, pad))
                if ph["p0"] <= stamp <= ph["p1"] and real:
                    f, af, ab = flops.prefill_chunk(s, real,
                                                    max(0, lo - pad))
                    pre_flops += f
                    pre_least += flops.least_s(af, ab)
                lo += n
    return {"decode_flops": dec_flops,
            "decode_attention_least_s": flops.least_s(dec_attn_flops,
                                                      dec_bytes),
            "prefill_flops": pre_flops,
            "prefill_attention_least_s": pre_least}


def _first_admit(q):
    for stamp, event, _ in list(q.timeline):
        if event == "admit":
            return stamp
    return None


def _layer_ctx(phases, sent, c, ctx, w0, w1) -> dict:
    """What the per-layer readers need: the two profiled phases, and the
    engine's stamps of the measured window's requests."""
    s = flops.Shapes(c)
    dev, host = phases[False], phases[True]
    lc = {"window": trace.Window(dev["prof"], dev["t0"], dev["t1"]),
          "host": trace.Window(host["prof"], host["t0"], host["t1"]),
          "kernels": ctx.kernels,
          "decode_chunk": int(ctx.workload["engine"]["decode_chunk"]),
          "host_prefill_flops": _work(host, sent, s)["prefill_flops"]}
    lc.update(_work(dev, sent, s))
    # the decode time a token of the requests that ended in the window
    ended = [q for _, q in sent if q.done.is_set() and q.error is None
             and q.last_token_ts is not None and w0 <= q.last_token_ts < w1
             and len(q.tokens) >= 2]
    lc["tpot_ms"] = [(q.last_token_ts - q.first_token_ts) * 1e3
                     / (len(q.tokens) - 1) for q in ended]
    # admission to first token of the requests whose first token came in
    # the window: the prefill, interleaved with decode, without the queue
    first = [(q.first_token_ts, _first_admit(q)) for _, q in sent
             if q.first_token_ts is not None
             and w0 <= q.first_token_ts < w1]
    lc["admit_to_first_token_ms"] = [(f - a) * 1e3 for f, a in first
                                     if a is not None]
    return lc
