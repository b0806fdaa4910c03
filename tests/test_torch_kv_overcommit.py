"""The KV overcommit plane of the port's ``BatchedEngine`` (``tests/
test_kv_overcommit.py`` ported; adapters, the gateway and replay wait for
ROADMAP Queue 1 items 3, 6 and 11): refcounted copy-on-write prefix blocks,
on-demand table growth, youngest-first preemption and token-exact resume.
Overcommit must be invisible in the tokens: growth, COW mapping and
preempt/resume all equal the eager engine's streams, greedy and sampled
(a parked session carries its threefry key)."""

import threading
import time

import pytest

from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

MODEL = "preset:debug"
BASE = dict(template="vanilla", max_seq_len=256, decode_chunk=4,
            device="cpu")


@pytest.fixture(scope="module")
def dense():
    eng = BatchedEngine(MODEL, slots=2, **BASE)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def over_cow():
    """Overcommit + COW prefix blocks; a roomy pool."""
    eng = BatchedEngine(MODEL, slots=2, kv_block_size=16,
                        kv_overcommit="on", prefix_cache=4,
                        paged_kernel="on", **BASE)
    yield eng
    eng.close()


# ----------------------------------------------- COW token-exactness

def test_cow_reuse_and_extend_match_dense_copy_path(dense, over_cow):
    """COW block mapping (exact hit) and shared prefix + chunked suffix
    (strict-prefix hit, K8 from a base cursor > 0) give the dense engine's
    tokens, greedy and fixed-seed sampled."""
    tok = dense.tokenizer
    p1 = tok.encode("shared system prompt for every request here")
    want1 = dense.generate(p1, max_new_tokens=10)
    assert over_cow.generate(p1, max_new_tokens=10) == want1  # cold
    assert over_cow.generate(p1, max_new_tokens=10) == want1  # COW reuse
    p2 = tok.encode("shared system prompt for every request here plus")
    want2 = dense.generate(p2, max_new_tokens=10)
    assert over_cow.generate(p2, max_new_tokens=10) == want2  # COW extend
    assert over_cow.prefill_stats["reuse"] >= 1
    assert over_cow.prefill_stats["extend"] >= 1
    modes = {e[3] for e in over_cow.sched_trace if e[0] == "admit"}
    assert "cow" in modes and "cow_extend" in modes, modes
    for seed in (0, 7):
        w = dense.generate(p1, max_new_tokens=10, temperature=0.8,
                           top_p=0.9, seed=seed)
        g = over_cow.generate(p1, max_new_tokens=10, temperature=0.8,
                              top_p=0.9, seed=seed)
        assert g == w, (seed, g, w)


def test_cow_block_accounting_shares_then_releases(over_cow):
    """Slots decref on release while cache entries keep their shares: the
    only blocks still out are the entries', each at a refcount equal to its
    owner count, and dropping the cache returns the pool to full. The test
    makes its own entries (a cold prompt, a hit, an extension), so it does
    not lean on what another test left in the module's engine."""
    tok = over_cow.tokenizer
    p1 = tok.encode("shared system prompt for every request here")
    for prompt in (p1, p1, p1 + tok.encode(" plus")):
        over_cow.generate(prompt, max_new_tokens=10)
    ents = [e for e in over_cow._prefix._d.values() if e.get("blocks")]
    assert ents, "COW cache holds no block entries"
    alloc = over_cow._allocator
    owners: dict = {}
    for e in ents:
        for b in e["blocks"]:
            owners[b] = owners.get(b, 0) + 1
    assert over_cow.kv_blocks_reserved == len(owners)
    for b, n in owners.items():
        assert alloc.refcount(b) == n, (b, n, alloc.refcount(b))
    while over_cow._prefix.pop_lru_block_entry() is not None:
        pass  # pop hands ownership to us...
    for e in ents:
        alloc.free(e["blocks"])  # ...and we release it
    assert over_cow.free_kv_blocks == over_cow.total_kv_blocks


@pytest.mark.parametrize("layout", ["gather", "kernel"])
def test_cow_int8_kv_parity(layout):
    """int8 pools: the scale pools move with K/V through every COW copy."""
    pk = "on" if layout == "kernel" else "off"
    eager = BatchedEngine(MODEL, slots=2, kv_block_size=16, kv_quant="int8",
                          paged_kernel=pk, **BASE)
    cow = BatchedEngine(MODEL, slots=2, kv_block_size=16, kv_quant="int8",
                        kv_overcommit="on", prefix_cache=4, paged_kernel=pk,
                        **BASE)
    try:
        prompt = eager.tokenizer.encode("quantized overcommit probe")
        longer = prompt + eager.tokenizer.encode(" and more")
        for kw in ({}, {"temperature": 0.7, "top_p": 0.9, "seed": 11}):
            want = eager.generate(prompt, max_new_tokens=8, **kw)
            assert cow.generate(prompt, max_new_tokens=8, **kw) == want
            assert cow.generate(prompt, max_new_tokens=8, **kw) == want
        assert cow.generate(longer, max_new_tokens=8) == \
            eager.generate(longer, max_new_tokens=8)
        assert cow.prefill_stats["reuse"] >= 1
        assert cow.prefill_stats["extend"] >= 1
    finally:
        eager.close()
        cow.close()


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
def test_cow_tail_block_copy_parity(quant):
    """A block wider than the 64-token prompt bucket leaves every cached
    cursor inside a block, so each hit copies the entry's partial tail block
    (``paged_copy_block``, scrubbing the lanes past it): tokens still equal
    the eager engine's."""
    kw = dict(BASE, slots=2, kv_block_size=128, kv_quant=quant,
              paged_kernel="on")
    eager = BatchedEngine(MODEL, **kw)
    cow = BatchedEngine(MODEL, kv_overcommit="on", prefix_cache=4, **kw)
    try:
        tok = eager.tokenizer
        p = tok.encode("tail block probe")
        longer = p + tok.encode(" extended past the tail")
        want = [eager.generate(x, max_new_tokens=12) for x in (p, p, longer)]
        got = [cow.generate(x, max_new_tokens=12) for x in (p, p, longer)]
        assert got == want
        ents = [e for e in cow._prefix._d.values() if e.get("blocks")]
        assert any(e["rem"] for e in ents)
    finally:
        eager.close()
        cow.close()


# -------------------------------- growth, preemption, liveness, resume

@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
def test_growth_under_exhaustion_liveness_and_exact_resume(quant):
    """The preemption policy's whole contract on one tiny pool: every
    request completes (the oldest is never preempted: no deadlock),
    preempted sessions resume TOKEN-EXACTLY, greedy and sampled, and the
    pool is whole afterwards."""
    kw = dict(BASE, slots=4, kv_block_size=16, kv_quant=quant)
    ref = BatchedEngine(MODEL, **kw)
    eng = BatchedEngine(MODEL, kv_blocks=20, kv_overcommit="on", **kw)
    try:
        prompts = [eng.tokenizer.encode(f"request number {i} probing growth")
                   for i in range(4)]
        kws = [{}, {"temperature": 0.8, "top_p": 0.9, "seed": 3},
               {}, {"temperature": 0.7, "top_p": 0.95, "seed": 9}]
        want = [ref.generate(p, max_new_tokens=80, **k)
                for p, k in zip(prompts, kws)]
        reqs = [eng.submit(p, max_new_tokens=80, **k)
                for p, k in zip(prompts, kws)]
        for i, r in enumerate(reqs):
            assert r.done.wait(300), f"request {i} stalled"
            assert r.error is None, (i, r.error)
            assert r.tokens == want[i], f"request {i} diverged after resume"
        # 4 sessions on a 20-block pool, each growing toward 9 blocks, MUST
        # have preempted, and every export came back
        assert eng.preempt_stats.get("exported", 0) >= 1, eng.preempt_stats
        assert (eng.preempt_stats.get("resumed", 0)
                == eng.preempt_stats.get("exported", 0))
        resumed = {e[1] for e in eng.sched_trace if e[0] == "resume"}
        sampled = {reqs[1].seq, reqs[3].seq}
        preempted = {e[2] for e in eng.sched_trace if e[0] == "preempt"}
        assert resumed and preempted & sampled, (preempted, sampled)
        assert any(e[0] == "grow" for e in eng.sched_trace)
        assert eng.kv_stats["peak_sessions"] == 4
        assert eng.parked_sessions == 0
        assert eng.free_kv_blocks == eng.total_kv_blocks == 20
        assert max(eng.kv_stats["session_blocks"]) <= 20
    finally:
        ref.close()
        eng.close()


def test_oldest_request_never_preempted():
    """The forward-progress invariant, on the trace: no preempt event names
    the oldest live request."""
    eng = BatchedEngine(MODEL, slots=4, kv_block_size=16, kv_blocks=20,
                        kv_overcommit="on", **BASE)
    try:
        prompts = [eng.tokenizer.encode(f"victim ordering probe {i}")
                   for i in range(4)]
        reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
        for r in reqs:
            assert r.done.wait(300) and r.error is None
        preempted = {e[2] for e in eng.sched_trace
                     if e[0] in ("preempt", "preempt_prefill")}
        assert preempted, "pool never contended — test is vacuous"
        assert min(r.seq for r in reqs) not in preempted
    finally:
        eng.close()


def test_younger_cold_request_waits_behind_a_parked_session():
    """Strict FIFO across the park: while an older session is parked, a
    younger cold request is not admitted ahead of it."""
    eng = BatchedEngine(MODEL, slots=4, kv_block_size=16, kv_blocks=20,
                        kv_overcommit="on", **BASE)
    try:
        tok = eng.tokenizer
        reqs = [eng.submit(tok.encode(f"fifo probe {i}"), max_new_tokens=80)
                for i in range(4)]
        late = None
        deadline = time.time() + 300
        while time.time() < deadline and not all(r.done.is_set()
                                                  for r in reqs):
            if late is None and eng.parked_sessions:
                late = eng.submit(tok.encode("late arrival"),
                                  max_new_tokens=8)
            time.sleep(0.001)
        for r in reqs + ([late] if late else []):
            assert r.done.wait(300) and r.error is None
        assert late is not None, "nothing was ever parked"
        # every session parked when the late request arrived is older than
        # it: none may still be parked when it is admitted (its admission
        # is the trace's last)
        trace = list(eng.sched_trace)
        i = max(j for j, e in enumerate(trace) if e[0] == "admit")
        parked = (sum(1 for e in trace[:i] if e[0] == "preempt")
                  - sum(1 for e in trace[:i] if e[0] == "resume"))
        assert parked == 0
        assert eng.free_kv_blocks == eng.total_kv_blocks
    finally:
        eng.close()


def test_overcommit_metrics_and_flag_validation():
    with pytest.raises(ValueError, match="kv_block_size"):
        BatchedEngine(MODEL, slots=2, kv_overcommit="on", **BASE)
    with pytest.raises(ValueError, match="on|off"):
        BatchedEngine(MODEL, slots=2, kv_block_size=16,
                      kv_overcommit="sometimes", **BASE)
    eng = BatchedEngine(MODEL, slots=2, kv_block_size=16, kv_blocks=18,
                        kv_overcommit="on", **BASE)
    try:
        assert eng.kv_overcommit_ratio == 0.0 and eng.parked_sessions == 0
        req = eng.submit(eng.tokenizer.encode("metrics probe"),
                         max_new_tokens=48, stop_ids={-1})
        peak_ratio, peak_reserved = 0.0, 0
        deadline = time.time() + 300
        while not req.done.is_set() and time.time() < deadline:
            peak_ratio = max(peak_ratio, eng.kv_overcommit_ratio)
            peak_reserved = max(peak_reserved, eng.kv_blocks_reserved)
            time.sleep(0.001)
        assert req.done.wait(300) and req.error is None
        # one live session demanding ceil((64+48)/16)=7 eager blocks on an
        # 18-block pool, reserving lazily from ceil((64+4)/16)=5
        assert peak_ratio == round(7 / 18, 4)
        assert 5 <= peak_reserved <= 7
        assert eng.kv_blocks_reserved == 0
        assert eng.preempt_stats == {}
    finally:
        eng.close()
    dense = BatchedEngine(MODEL, slots=2, **BASE)
    try:
        assert dense.kv_blocks_reserved is None
        assert dense.kv_overcommit_ratio is None
    finally:
        dense.close()


def test_overcommit_off_reserves_eagerly_byte_identical():
    """``kv_overcommit="off"``: the reserve is the full
    ceil((plen+max_new)/bs) up front, nothing preempts, COW never engages,
    and prefix entries are dense rows."""
    eng = BatchedEngine(MODEL, slots=2, kv_block_size=16,
                        kv_overcommit="off", prefix_cache=4, **BASE)
    try:
        assert not eng.overcommit and not eng.cow
        assert eng._reserve_depth(64, 100) == 164  # eager math
        req = eng.submit(eng.tokenizer.encode("hi"), max_new_tokens=48)
        peak = 0
        deadline = time.time() + 300
        while not req.done.is_set() and time.time() < deadline:
            peak = max(peak, eng.total_kv_blocks - eng.free_kv_blocks)
            time.sleep(0.001)
        assert req.done.wait(300) and req.error is None
        assert peak == 7, peak  # plen 64 + max_new 48 → 7 blocks of 16
        assert eng.preempt_stats == {}
        assert all(not e.get("blocks") for e in eng._prefix._d.values())
    finally:
        eng.close()


# ------------------------------------------------- parity with the JAX engine
#
# Both engines serve the same weights (the JAX ``preset:debug`` export, each
# loaded by its own package's loader) with the same overcommit settings and
# the same traffic. The contended batch is handed to each scheduler in one
# admission pass (a gate on ``_admit_waiting``), so the two schedules are
# the same function of the request lengths and can be compared event by
# event: admission modes, prefill chunks, growth, preemption and resume.

OVER = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
            kv_block_size=16, paged_kernel="on", kv_overcommit="on",
            prefix_cache=4, kv_blocks=24)
OVER_NEW = 64
EVENTS = ("admit", "prefill", "activate", "grow", "preempt",
          "preempt_prefill", "resume", "finish")


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    import jax

    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _near_tie(export_dir, prompt, prefix) -> bool:
    """JAX's bf16 logits for the step after ``prompt + prefix`` put the top
    two within 2 bf16 ulps (``tests/test_torch_engine.py``'s rule)."""
    import jax.numpy as jnp
    import numpy as np

    from datatunerx_tpu.models.llama import forward
    from datatunerx_tpu.utils.decoding import prepare_prompt
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, tok = load_model_and_tokenizer(export_dir,
                                                dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, OVER_NEW)
    seq = ids + list(prefix)
    pos = positions + list(range(n, n + len(prefix)))
    msk = mask + [1] * len(prefix)
    logits, _ = forward(params, jnp.asarray([seq]), cfg,
                        positions=jnp.asarray([pos]),
                        attention_mask=jnp.asarray([msk]),
                        compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1][:2]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
    return (top[0] - top[1]) <= 2 * ulp


def _drive_overcommit(eng):
    """A cold prompt P, an exact hit on P, a strict-prefix extension of P,
    then four greedy requests (two deeper extensions, P, and the first
    extension) submitted while the scheduler waits at its admission gate.
    Returns the prompts, the streams, the normalised trace and the peak
    ``(kv_blocks_reserved, kv_overcommit_ratio)`` seen after a growth
    tick."""
    tok = eng.tokenizer
    p = tok.encode("a shared preamble for every request")
    p1 = p + tok.encode(" and a question")
    p2 = p1 + tok.encode(" then more")
    p3 = p + tok.encode(" or another")
    gate, parked = threading.Event(), threading.Event()
    gate.set()
    admit, grow = eng._admit_waiting, eng._grow_tick
    peaks = []

    def gated_admit():
        if not gate.is_set():
            parked.set()
            gate.wait()
        admit()

    def noted_grow():
        grow()
        peaks.append((eng.kv_blocks_reserved, eng.kv_overcommit_ratio))

    eng._admit_waiting, eng._grow_tick = gated_admit, noted_grow
    prompts, reqs = [], []
    for x in (p, p, p1):
        r = eng.submit(x, max_new_tokens=OVER_NEW)
        assert r.done.wait(600) and r.error is None, r.error
        prompts.append(x)
        reqs.append(r)
    gate.clear()
    eng._wake.set()
    assert parked.wait(60), "the scheduler never reached its gate"
    batch = (p2, p3, p, p1)
    reqs += [eng.submit(x, max_new_tokens=OVER_NEW) for x in batch]
    prompts += list(batch)
    gate.set()
    for r in reqs:
        assert r.done.wait(600) and r.error is None, r.error
    index = {r.seq: i for i, r in enumerate(reqs)}
    trace = [e if e[0] not in ("preempt", "preempt_prefill")
             else (e[0], e[1], index[e[2]])
             for e in eng.sched_trace if e[0] in EVENTS]
    return prompts, [r.tokens for r in reqs], trace, peaks


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_overcommit_matches_the_jax_engine(export_dir, kv_quant):
    """COW hits, growth, reclamation, preemption and resume, held against
    the JAX engine on the same export: greedy streams (near-tie rule), the
    admission statistics, the preemption outcomes, the scheduler's events,
    the peak reserve and overcommit ratio, and the pool afterwards."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine

    kw = dict(OVER, kv_quant=kv_quant)
    runs = []
    for make in (lambda: JEngine(export_dir, **kw),
                 lambda: BatchedEngine(export_dir, device="cpu", **kw)):
        eng = make()
        try:
            prompts, streams, trace, peaks = _drive_overcommit(eng)
            live = sum(len(e["blocks"]) for e in eng._prefix._d.values()
                       if e.get("blocks"))
            runs.append(dict(
                streams=streams, trace=trace, peak=max(peaks),
                prefill=dict(eng.prefill_stats),
                preempt=dict(eng.preempt_stats),
                peak_sessions=eng.kv_stats["peak_sessions"],
                free=eng.free_kv_blocks, live=live,
                parked=eng.parked_sessions))
        finally:
            eng.close()
    want, got = runs
    for i, (w, g) in enumerate(zip(want["streams"], got["streams"])):
        div = next((j for j in range(min(len(w), len(g))) if g[j] != w[j]),
                   None)
        if div is not None or len(g) != len(w):
            assert _near_tie(export_dir, prompts[i], w[:div or len(g)]), i
    # the traffic exercised what it is meant to, in the reference
    assert want["prefill"]["reuse"] >= 1 and want["prefill"]["extend"] >= 1
    assert want["preempt"].get("exported", 0) >= 1, want["preempt"]
    assert want["preempt"].get("resumed", 0) >= 1, want["preempt"]
    modes = {e[3] for e in want["trace"] if e[0] == "admit"}
    assert {"cow", "cow_extend"} <= modes, modes
    assert any(e[0] == "grow" for e in want["trace"])
    for key in ("trace", "prefill", "preempt", "peak", "peak_sessions",
                "free", "live", "parked"):
        assert got[key] == want[key], key
    assert got["free"] + got["live"] == OVER["kv_blocks"]
