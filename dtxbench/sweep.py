"""The knee of a serving cell: the highest offered rate at which the queue
does not grow through a window. One process builds the cell's engine
once, then offers each rate in turn as an open loop (the cell's traffic
mix at that rate, a short ramp first), waits for every request, and
prints one JSON line a rate and a summary:

    python3 dtxbench/sweep.py --workload serve.qwen1.5-7b.chat-saturated \\
        --seed 11 --rates 1.5,2,2.5,3 --seconds 40

A rate holds when the median queue wait (admission minus due time) of
the requests due in the window's last third is within 0.5 s or 1.5× of
the first third's: the queue did not grow through the window. The
requests still waiting for a slot at the close are reported beside it. The cell runs at about four fifths of the highest rate
that holds; that rate is written into its traffic file by hand, with the
sweep's lines beside it in ``PERF.md``.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dtxbench.harness import env, spec, stats, traffic  # noqa: E402


def offer(drv, eng, mix, seed, vocab, seconds):
    _emitted, _sleep_until = drv._emitted, drv._sleep_until
    sched = traffic.open_loop(mix, seed, vocab, seconds)
    ramp = float(mix.get("ramp_s", 0.0))
    T0 = time.perf_counter() + 0.05
    w0, w1 = T0 + ramp, T0 + ramp + seconds
    sent, snaps = [], {}
    for r in sched:
        due = T0 + r["t"]
        if "w0" not in snaps and due >= w0:
            _sleep_until(w0)
            snaps["w0"] = (time.perf_counter(), _emitted(sent))
        _sleep_until(due)
        sent.append((due, eng.submit(r["prompt"], max_new_tokens=r["max_new"],
                                     temperature=r["temperature"],
                                     seed=r["seed"])))
    _sleep_until(w1)
    snaps["w1"] = (time.perf_counter(), _emitted(sent))
    for _, q in sent:
        q.done.wait(300)
    inside = [(d, q) for d, q in sent if w0 <= d < w1]

    def admit(q):
        a = [st for st, ev, _ in q.timeline if ev == "admit"]
        return a[0] if a else None

    waiting = sum(1 for d, q in inside
                  if admit(q) is None or admit(q) > w1)
    thirds = [[(admit(q) - d) for d, q in inside
               if admit(q) is not None
               and w0 + k * seconds / 3 <= d < w0 + (k + 1) * seconds / 3]
              for k in range(3)]
    first = statistics.median(thirds[0]) if thirds[0] else 0.0
    last = statistics.median(thirds[2]) if thirds[2] else float("inf")
    ttft = stats.ttft_ms([d for d, _ in inside],
                         [q.first_token_ts for _, q in inside])
    (ta, na), (tb, nb) = snaps["w0"], snaps["w1"]
    return {"requests": len(inside),
            "output_tokens_per_s": (nb - na) / (tb - ta),
            "ttft_p50_ms": stats.percentile(ttft, 50),
            "ttft_p90_ms": stats.percentile(ttft, 90),
            "ttft_p95_ms": stats.percentile(ttft, 95),
            "queue_wait_first_third_s": first,
            "queue_wait_last_third_s": last,
            "waiting_at_close": waiting,
            "holds": last <= max(first * 1.5, first + 0.5)}


def main():
    import types

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--ramp", type=float, default=5.0)
    args = ap.parse_args()
    env.prepare()
    wl = spec.workload(args.workload)
    err = env.require_cuda(int(wl["chips"]))
    if err:
        print(f"sweep: {err}", file=sys.stderr)
        return 3
    import torch

    drv = spec.driver(wl["driver"])
    ctx = types.SimpleNamespace(
        seed=args.seed, workload=wl, config_name=wl["config"],
        config=spec.config(wl["config"]), fault=None,
        device=torch.device("cuda", torch.cuda.current_device()))
    eng, _ = drv.build_engine(ctx)
    mix = spec.traffic(wl["traffic"])
    held = []
    for k, rate in enumerate(float(x) for x in args.rates.split(",")):
        res = offer(drv, eng, dict(mix, rate=rate, ramp_s=args.ramp),
                    args.seed + k, ctx.config["vocab_size"], args.seconds)
        res["rate"] = rate
        print(json.dumps(res), flush=True)
        if res["holds"]:
            held.append(rate)
    eng.close()
    knee = max(held) if held else None
    print(json.dumps({"knee": knee,
                      "cell_rate": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
