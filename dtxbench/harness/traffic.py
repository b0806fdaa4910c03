"""The one traffic generator. A traffic mix is a data file
(``traffic/<mix>.json``) of parameters; its ``kind`` picks the shape:

- ``packed_docs`` (training): documents of drawn lengths, token ids
  uniform over the vocabulary above ``id_low``, packed into rows by the
  program's packer. Each document's first label is ignored, so no token is
  predicted across a document boundary.
- ``open_loop`` (serving): independent requests due on a schedule of
  Poisson arrivals, each with a drawn prompt and output length, a share of
  them greedy and the rest sampled at ``temperature``; a ramp of
  ``ramp_s`` before the window loads the server.

Lengths are ``lognormal`` (``median``, ``sigma``), clipped to
``[min, max]``. The SET of sizes (and of gaps) is drawn from the mix's
own ``shape_seed``; the run's ``--seed`` only orders them and draws the
token ids and sampling seeds, so every seed does the same work.
"""

from __future__ import annotations

import math

import numpy as np

IGNORE = -100


def _rng(seed: int, salt: str) -> np.random.Generator:
    return np.random.default_rng(
        [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
         sum(ord(c) * 131 ** i for i, c in enumerate(salt)) & 0xFFFFFFFF])


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = np.exp(rng.normal(math.log(spec["median"]), spec["sigma"], n))
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def packed_docs(mix: dict, seed: int, vocab: int) -> list:
    """The documents of one run: ``[{"input_ids", "labels"}]``."""
    shape = _rng(mix["shape_seed"], "docs")
    n = int(mix["documents"])
    lens = lengths(mix["length"], n, shape)
    run = _rng(seed, "docs")
    lens = lens[run.permutation(n)]
    low = int(mix.get("id_low", 3))
    ids = run.integers(low, vocab, int(lens.sum()), dtype=np.int64)
    docs, at = [], 0
    for m in lens:
        x = ids[at:at + m].tolist()
        at += m
        docs.append({"input_ids": x, "labels": [IGNORE] + x[1:]})
    return docs


def open_loop(mix: dict, seed: int, vocab: int, seconds: float,
              tail_s: float = 0.0) -> list:
    """Requests due over ``ramp_s + seconds + tail_s``, as dicts with ``t``
    (due, seconds from the schedule's start), ``prompt`` (ids),
    ``max_new``, ``temperature`` (0 = greedy) and ``seed``.

    The ramp, the window and the tail (traffic after the window, which a
    traced run profiles) are drawn apart: each holds ``rate`` × its length
    requests, whose sizes and gaps are a set fixed by the mix (a Poisson
    process held to that count: exponential gaps scaled to the span), put
    in an order drawn from the seed. So every window holds the same
    requests, arriving in another order, with or without a tail."""
    rate = float(mix["rate"])
    low = int(mix.get("id_low", 3))
    temp = float(mix.get("temperature", 1.0))
    reqs, t0 = [], 0.0
    for part, span in (("ramp", float(mix.get("ramp_s", 0.0))),
                       ("window", float(seconds)), ("tail", float(tail_s))):
        n = int(round(rate * span))
        if n <= 0:
            t0 += span
            continue
        shape = _rng(mix["shape_seed"], f"open_loop/{part}/{n}")
        gaps = shape.exponential(1.0, n + 1)
        prompts = lengths(mix["prompt"], n, shape)
        outs = lengths(mix["output"], n, shape)
        greedy = np.zeros(n, bool)
        greedy[:int(round(n * float(mix.get("greedy_share", 0.0))))] = True
        run = _rng(seed, f"open_loop/{part}")
        order = run.permutation(n)
        prompts, outs, greedy = prompts[order], outs[order], greedy[order]
        gaps = gaps[run.permutation(n + 1)]
        times = t0 + span * np.cumsum(gaps)[:-1] / gaps.sum()
        for i in range(n):
            reqs.append({
                "t": float(times[i]),
                "prompt": run.integers(low, vocab, int(prompts[i]),
                                       dtype=np.int64).tolist(),
                "max_new": int(outs[i]),
                "temperature": 0.0 if greedy[i] else temp,
                "seed": int(run.integers(0, 2 ** 31 - 1)),
            })
        t0 += span
    return reqs
