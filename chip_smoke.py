#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``datatunerx_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``datatunerx_tpu_torch/csrc`` with
nvcc, then, each phase failing the run (non-zero exit) on any error:

1. device: prints the card's name and power limit (nvidia-smi) and the
   kernel build time;
2. kernels: runs each kernel of the serving path — K7 paged decode, K8 paged
   multi-token, K9 fused sampling — on the card at the shapes the
   tinyllama-1.1b serving path gives it, holds it against its plain PyTorch
   version on the same inputs with the stated tolerance, and times kernel,
   plain version and a PyTorch yardstick call with CUDA events;
3. serve: starts the port's HTTP server in-process for
   ``preset:tinyllama-1.1b`` (full width, random weights from seed 0) with
   ``--kv_block_size 16 --slots 4``, sends four concurrent
   ``/chat/completions`` (two greedy, one of them streamed over SSE; two
   sampled at temperature 0.8) and requires every kernel's launch counter,
   zeroed just before, to have moved;
4. greedy parity: two greedy prompts, 32 tokens each, through the kernel
   engine and through an engine on the gather path with the legacy sampler;
   the streams must agree up to a divergence at a near-tie (top-2 logits of
   the plain path within 2 bf16 ulps);
5. prints one JSON ``{"kernels": [...]}`` line and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

``--phase kernels`` stops after phase 2. The script imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
SENTINEL = 2**30


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
class Timer:
    """Device time of one call with CUDA events. Before each timed call the
    L2 is flushed (64 MB written) and the stream is held busy by a spin
    kernel, so the host has enqueued the events and the call before the
    device reaches them: the interval is device time, not launch overhead
    (for a call made of many launches, host time between them still
    counts — that is the plain versions' real cost)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 2
def make_pool(torch, B, nbps, bs, KV, d, lens, gen):
    """A bf16 block pool holding ``lens[b]`` written tokens per slot through
    shuffled block tables (positions 0..len-1, sentinel elsewhere); the pool
    carries the engine's extra scratch block."""
    NB = B * nbps
    perm = torch.randperm(NB, generator=gen).tolist()
    tables = torch.full((B, nbps), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        need = -(-lens[b] // bs)
        tables[b, :need] = torch.tensor(perm[nxt:nxt + need], dtype=torch.int32)
        nxt += need
    k = torch.randn((NB + 1, bs, KV, d), generator=gen).to(torch.bfloat16)
    v = torch.randn((NB + 1, bs, KV, d), generator=gen).to(torch.bfloat16)
    pos = torch.full((NB + 1, bs), SENTINEL, dtype=torch.int32)
    for b in range(B):
        for i in range(lens[b]):
            pos[tables[b, i // bs], i % bs] = i
    return (k.cuda(), v.cuda(), tables.cuda(), pos.cuda())


def gathered(torch, pool, tables):
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    B = tables.shape[0]
    return pool[tbl].reshape(B, -1, pool.shape[-2], pool.shape[-1])


def sdpa(torch, q, k, v, mask):
    """Yardstick: one PyTorch SDPA call, q [B, H, T, d], k/v [B, KV, S, d]."""
    F = torch.nn.functional
    G = q.shape[1] // k.shape[1]
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:  # torch without enable_gqa
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask)


def close_enough(torch, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


def check_k7(torch, timer, gen):
    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa

    B, H, KV, d, bs, nbps = 4, 32, 4, 64, 16, 64
    lens = [1000, 517, 77, 0]  # ragged, one empty slot
    k, v, tables, pos = make_pool(torch, B, nbps, bs, KV, d, lens, gen)
    q = torch.randn((B, H, d), generator=gen).to(torch.bfloat16).cuda()
    qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                        device="cuda")

    def kern():
        return cpa.paged_decode_attention(q, k, v, None, None, tables, pos,
                                          qpos)

    def plain():
        return cpa._plain_decode(q, k, v, tables, pos, qpos)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok, err = close_enough(torch, got, want, 2**-8, 2**-7)
    if not ok:
        fail(f"K7 disagrees with its plain version: max abs err {err}")
    if got[3].abs().max().item() != 0:
        fail("K7: the empty slot did not write zeros")
    k_all, v_all = gathered(torch, k, tables), gathered(torch, v, tables)
    kv_pos = gathered(torch, pos[:, :, None, None], tables).reshape(B, -1)
    kv_pos = torch.where((tables >= 0).repeat_interleave(bs, 1), kv_pos,
                         torch.full_like(kv_pos, SENTINEL))
    mask = (kv_pos <= qpos[:, None])[:, None, None, :]  # [B, 1, 1, W]
    qs, ks, vs = q[:, :, None, :], k_all.transpose(1, 2), v_all.transpose(1, 2)
    valid = sum(lens)
    nbytes = (2 * q.numel() * 2 + tables.numel() * 4 + qpos.numel() * 4
              + valid * (4 + 2 * KV * d * 2))
    b_ms, b_by = bound_ms(nbytes, 4 * H * d * valid, BF16_OPS_PER_S)
    return {
        "name": "K7 paged_decode_attention", "route": "cuda",
        "source": "datatunerx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "datatunerx_tpu/ops/pallas_paged_attention.py:65",
        "counter": cpa.paged_decode_attention,
        "max_abs_err": err, "tolerance": "atol 2^-8 + rtol 2^-7 (bf16)",
        "ms": timer.ms(kern), "plain_ms": timer.ms(plain, reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: sdpa(torch, qs, ks, vs, mask)),
        "shape": f"B={B} H={H} KV={KV} d={d} bs={bs} nbps={nbps} lens={lens}",
    }


def check_k8(torch, timer, gen):
    from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
    from datatunerx_tpu_torch.ops.attention import attention_allow

    B, T, H, KV, d, bs, nbps = 1, 256, 32, 4, 64, 16, 64
    lens = [768]  # the third 256-token chunk of a prompt, post-write
    k, v, tables, pos = make_pool(torch, B, nbps, bs, KV, d, lens, gen)
    q = torch.randn((B, T, H, d), generator=gen).to(torch.bfloat16).cuda()
    qpos = torch.arange(lens[0] - T, lens[0], dtype=torch.int32,
                        device="cuda")[None]
    kv_pos = gathered(torch, pos[:, :, None, None], tables).reshape(B, -1)
    kv_pos = torch.where((tables >= 0).repeat_interleave(bs, 1), kv_pos,
                         torch.full_like(kv_pos, SENTINEL))
    allow = attention_allow(qpos, kv_pos)

    def kern():
        return cpa.paged_multitoken_attention(q, k, v, None, None, tables,
                                              allow)

    def plain():
        return cpa._plain_multitoken(q, k, v, tables, allow)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok, err = close_enough(torch, got, want, 2**-8, 2**-7)
    if not ok:
        fail(f"K8 disagrees with its plain version: max abs err {err}")
    k_all, v_all = gathered(torch, k, tables), gathered(torch, v, tables)
    qs = q.transpose(1, 2)
    ks, vs = k_all.transpose(1, 2), v_all.transpose(1, 2)
    mask = allow[:, None]
    valid_pairs = int(allow.sum().item())
    nbytes = (2 * q.numel() * 2 + allow.numel() + tables.numel() * 4
              + lens[0] * 2 * KV * d * 2)
    b_ms, b_by = bound_ms(nbytes, 4 * H * d * valid_pairs, BF16_OPS_PER_S)
    return {
        "name": "K8 paged_multitoken_attention", "route": "cuda",
        "source": "datatunerx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "datatunerx_tpu/ops/pallas_paged_attention.py:294",
        "counter": cpa.paged_multitoken_attention,
        "max_abs_err": err, "tolerance": "atol 2^-8 + rtol 2^-7 (bf16)",
        "ms": timer.ms(kern), "plain_ms": timer.ms(plain, reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: sdpa(torch, qs, ks, vs, mask)),
        "shape": f"B={B} T={T} H={H} KV={KV} d={d} bs={bs} nbps={nbps} "
                 f"len={lens[0]}",
    }


def check_k9(torch, timer, gen):
    from datatunerx_tpu_torch.ops import cuda_sampling as cs

    S, V = 4, 32000
    logits = (torch.randn((S, V), generator=gen) * 2.0).cuda()
    logits[1, 7] = logits[1, 31000] = logits[1].max() + 1.0  # exact tie
    us = torch.rand((S,), generator=gen).cuda()
    err = 0
    results = {}
    for mode, temps in (("greedy", [0.0] * S),
                        ("simple", [0.8, 0.8, 0.0, 1.3])):
        t = torch.tensor(temps, device="cuda")
        x, bn = cs._prep(logits, t, mode=mode)
        greedy = mode == "greedy"
        got = cs.kernel_sample(x, t, us, greedy=greedy)
        want = cs._plain_sample(x, t, us, bn=bn, greedy=greedy)
        torch.cuda.synchronize()
        if greedy and int(got[1]) != 7:
            fail(f"K9 greedy tie: got {int(got[1])}, want the first max 7")
        for r in range(S):
            a, b = int(got[r]), int(want[r])
            if a == b:
                continue
            if greedy or temps[r] <= 0:
                fail(f"K9 {mode} row {r}: kernel {a} != plain {b}")
            # a sampled mismatch is allowed only at a CDF boundary within
            # 1e-5*Z of u*Z between the two tokens (f32 sum order)
            row = x[r].double()
            e = torch.exp(row - row.max())
            cdf, z = torch.cumsum(e, 0), e.sum()
            lo, hi = min(a, b), max(a, b)
            gap = (cdf[lo:hi] - us[r].double() * z).abs().min()
            if float(gap) > 1e-5 * float(z):
                fail(f"K9 simple row {r}: kernel {a} != plain {b}, "
                     "not at a CDF boundary")
        err = max(err, int((got.long() - want.long()).abs().max()))
        if greedy:
            lib = timer.ms(lambda: torch.argmax(x, dim=-1))
        else:
            lib = timer.ms(lambda: torch.multinomial(
                torch.softmax(x, dim=-1), 1))
        results[mode] = {
            "ms": timer.ms(lambda: cs.kernel_sample(x, t, us, greedy=greedy)),
            "plain_ms": timer.ms(lambda: cs._plain_sample(
                x, t, us, bn=bn, greedy=greedy), reps=5),
            "library_ms": lib, "vp": x.shape[1]}
    # the entry reports the simple mode (all three passes); greedy is printed
    vp = results["simple"]["vp"]
    b_ms, b_by = bound_ms(S * vp * 4 + 3 * S * 4, 4 * S * vp, F32_OPS_PER_S)
    log(f"  K9 greedy: kernel {results['greedy']['ms']:.4f} ms, plain "
        f"{results['greedy']['plain_ms']:.4f} ms, torch.argmax "
        f"{results['greedy']['library_ms']:.4f} ms")
    return {
        "name": "K9 fused_sample", "route": "cuda",
        "source": "datatunerx_tpu_torch/csrc/sampling.cu",
        "replaces": "datatunerx_tpu/ops/pallas_sampling.py:97",
        "counter": cs.kernel_sample,
        "max_abs_err": err,
        "tolerance": "token ids exact (sampled rows: up to a CDF boundary "
                     "within 1e-5*Z)",
        "ms": results["simple"]["ms"],
        "plain_ms": results["simple"]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": results["simple"]["library_ms"],
        "shape": f"S={S} V={V} (Vp={vp}), simple mode; greedy printed above",
    }


# ------------------------------------------------------------------ phase 3
def post(port, body, stream=False, trace=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/chat/completions",
        data=json.dumps(dict(body, stream=stream)).encode(),
        headers={"Content-Type": "application/json",
                 "X-DTX-Trace-Id": trace})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
        if not stream:
            out = json.loads(resp.read())
            return {"text": out["choices"][0]["message"]["content"],
                    "keys": sorted(out), "wall_s": time.perf_counter() - t0}
        text, first = "", None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "error" in ev:
                raise RuntimeError(ev["error"])
            delta = ev["choices"][0]["delta"].get("content")
            if delta and first is None:
                first = time.perf_counter() - t0
            text += delta or ""
        return {"text": text, "keys": ["stream"], "first_delta_s": first,
                "wall_s": time.perf_counter() - t0}


def serve_phase(torch, counters):
    from datatunerx_tpu_torch.serving import server

    args = server.parse_args([
        "--model_path", "preset:tinyllama-1.1b", "--kv_block_size", "16",
        "--slots", "4", "--host", "127.0.0.1", "--port", "0"])
    srv = server.start(args)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    t0 = time.perf_counter()
    while server.STATE.engine is None:
        if server.STATE.error:
            fail(f"engine failed to load: {server.STATE.error}")
        if time.perf_counter() - t0 > 600:
            fail("engine did not load within 600 s")
        time.sleep(0.2)
    eng = server.STATE.engine
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        if r.status != 200:
            fail(f"/healthz answered {r.status} after load")
    log(f"  engine loaded in {time.perf_counter() - t0:.1f} s: "
        f"decode_path={eng.decode_path} sampling_epilogue="
        f"{eng.sampling_epilogue} kv_blocks={eng.total_kv_blocks}")
    # warm-up request (first-call allocations), not counted
    post(port, {"messages": [{"role": "user", "content": "warm up"}],
                "max_tokens": 8})
    long_q = " ".join(f"item {i}: the quick brown fox." for i in range(40))
    reqs = [
        ("greedy-long", {"messages": [{"role": "user", "content": long_q}],
                         "max_tokens": 64}, False),
        ("greedy-sse", {"messages": [{"role": "user",
                                      "content": "Stream me a story."}],
                        "max_tokens": 64}, True),
        ("sampled-a", {"messages": [{"role": "user", "content": "Say hi."}],
                       "max_tokens": 64, "temperature": 0.8, "top_p": 1.0},
         False),
        ("sampled-b", {"messages": [{"role": "user",
                                     "content": "Count to ten."}],
                       "max_tokens": 64, "temperature": 0.8, "top_p": 1.0},
         False),
    ]
    for c in counters:
        c.launches = 0
    eng.request_stats.clear()
    results, errors = {}, []

    def run(name, body, stream):
        try:
            results[name] = post(port, body, stream=stream, trace=name)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    t_start = time.perf_counter()
    for th_ in threads:
        th_.start()
    for th_ in threads:
        th_.join(timeout=900)
    wall = time.perf_counter() - t_start
    launches = {c.__name__: c.launches for c in counters}
    if errors or len(results) != len(reqs):
        fail(f"serve phase: {errors or 'requests did not finish'}")
    stats = {s["trace_id"]: s for s in eng.request_stats}
    total = 0
    for name, _, _ in reqs:
        st = stats.get(name)
        if st is None or st["tokens"] <= 0:
            fail(f"{name}: the engine emitted no tokens")
        if not isinstance(results[name]["text"], str):
            fail(f"{name}: no content string in the response")
        total += st["tokens"]
        tps = (1.0 / st["tpot_s"]) if st["tpot_s"] else float("nan")
        log(f"  {name}: 200, {st['tokens']} tokens "
            f"({len(results[name]['text'])} chars of text), TTFT "
            f"{st['ttft_s'] * 1e3:.1f} ms, decode {tps:.1f} tok/s per request")
    if results["greedy-sse"].get("first_delta_s") is None and \
            results["greedy-sse"]["text"]:
        fail("greedy-sse: text arrived without a delta event")
    if _most_chunks(eng.sched_trace) < 2:
        fail("no prompt was prefilled in two or more chunks")
    log(f"  4 concurrent requests: {total} tokens in {wall:.2f} s wall "
        f"({total / wall:.1f} tok/s aggregate), launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve phase: kernel {name} was never launched")
    srv.shutdown()
    srv.server_close()
    return eng, launches, {"wall_s": wall, "tokens": total}


def _most_chunks(sched_trace) -> int:
    """Most prefill chunks any one admission took."""
    cur, best = {}, 0
    for ev in list(sched_trace):
        if ev[0] == "admit":
            cur[ev[1]] = 0
        elif ev[0] == "prefill":
            cur[ev[1]] = cur.get(ev[1], 0) + 1
            best = max(best, cur[ev[1]])
    return best


# ------------------------------------------------------------------ phase 4
def parity_phase(torch, eng):
    from datatunerx_tpu_torch.models.llama import forward
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
    from datatunerx_tpu_torch.utils.decoding import prepare_prompt

    plain = BatchedEngine("preset:tinyllama-1.1b", template="llama2",
                          max_seq_len=1024, slots=4, kv_block_size=16,
                          paged_kernel="off", sampling_epilogue="off")
    try:
        tok = eng.tokenizer
        prompts = [tok.encode("The capital of France is"),
                   tok.encode("def fibonacci(n):" * 20)]
        for p in prompts:
            a = eng.generate(p, max_new_tokens=32)
            b = plain.generate(p, max_new_tokens=32)
            n = min(len(a), len(b))
            div = next((i for i in range(n) if a[i] != b[i]), None)
            if div is None and len(a) == len(b):
                log(f"  greedy parity: {len(a)} tokens equal")
                continue
            div = n if div is None else div
            ids, mask, positions, plen, n_prompt, _, _ = prepare_prompt(
                p, tok.eos_token_id, plain.max_seq_len, 32)
            seq = ids + b[:div]
            pos = positions + list(range(n_prompt, n_prompt + div))
            msk = mask + [1] * div
            with torch.inference_mode():
                logits, _ = forward(
                    plain.params, torch.tensor([seq], device="cuda"),
                    plain.cfg,
                    positions=torch.tensor([pos], device="cuda"),
                    attention_mask=torch.tensor([msk], device="cuda"),
                    compute_dtype=torch.bfloat16)
            top = torch.topk(logits[0, -1], 2).values.double()
            ulp = 2.0 ** (torch.floor(torch.log2(top[0].abs())) - 7)
            gap_ulps = float((top[0] - top[1]) / ulp)
            log(f"  greedy parity: diverged at token {div}; plain top-2 gap "
                f"{gap_ulps:.2f} bf16 ulps")
            if gap_ulps > 2.0:
                fail(f"greedy streams diverge at token {div} without a "
                     f"near-tie (gap {gap_ulps:.2f} ulps)")
    finally:
        plain.close()


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="all", choices=["all", "kernels"])
    opts = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "datatunerx_tpu_torch", "csrc")):
        fail("datatunerx_tpu_torch/ is missing: run from a repository "
             "checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[1] device: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}")

    from datatunerx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"    kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")

    log("[2] kernels vs their plain versions (tinyllama-1.1b shapes)")
    gen = torch.Generator().manual_seed(0)
    timer = Timer(torch)
    entries = []
    for check in (check_k7, check_k8, check_k9):
        e = check(torch, timer, gen)
        entries.append(e)
        log(f"  {e['name']} [{e['shape']}]: max abs err {e['max_abs_err']:.3g}"
            f" ({e['tolerance']}); kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']})")
    counters = [e["counter"] for e in entries]

    launches = {c.__name__: 0 for c in counters}
    if opts.phase == "all":
        log("[3] serve preset:tinyllama-1.1b (4 concurrent /chat/completions)")
        eng, launches, _ = serve_phase(torch, counters)
        log("[4] greedy parity: kernels vs gather path + legacy sampler")
        try:
            parity_phase(torch, eng)
        finally:
            eng.close()

    line = []
    for e in entries:
        line.append({
            "name": e["name"], "route": e["route"], "source": e["source"],
            "replaces": e["replaces"],
            "launches": launches[e["counter"].__name__],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    log(card)  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
