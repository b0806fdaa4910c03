"""Session migration on the port's ``BatchedEngine`` (``tests/
test_session_handoff.py`` ported), held to the JAX package's engine.

A session exported mid-decode and imported on another engine resumes token
for token against an undisturbed run: greedy and fixed-seed sampled (the
payload carries the slot's live threefry key), port to port, JAX to port and
port to JAX through ``json.dumps`` (the payload is the reference's JSON
wire format), bf16 and int8 caches and wires, paged and dense layouts,
mixed-rank pooled adapters, and chain- and tree-spec sessions (settled
before export, re-primed after import; greedy, as in the reference). The
cross-package cases run ``preset:debug`` exported once with its final norm
scaled by 64, so every step has a clear head and both packages' greedy and
sampled streams are equal (``tests/test_torch_speculative.py``'s rule);
the port-only cases run ``preset:debug`` itself. Every refusal raises
``ValueError``; transient ones wait out ``wait_s`` first."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from datatunerx_tpu_torch.serving import migration as tmig
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

MODEL = "preset:debug"
BASE = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
            device="cpu")
PAGED = dict(BASE, kv_block_size=16)
SAMPLED = {"temperature": 0.8, "top_p": 0.9, "seed": 11}
LOGIT_SCALE = 64.0


def throttled(eng, delay=0.04):
    """Slow each decode tick of ``eng`` (either package, plain or spec) so
    a test can catch a request mid-decode; returns the restore callable."""
    if getattr(eng, "spec", None) is not None:
        attr = "_spec_decode_tick"
    else:
        attr = "_decode_chunk" if hasattr(eng, "_decode_chunk") else "_decode"
    orig = getattr(eng, attr)

    def slow(*a, **k):
        time.sleep(delay)
        return orig(*a, **k)

    setattr(eng, attr, slow)
    return lambda: setattr(eng, attr, orig)


def held(eng, when):
    """Hold ``eng``'s scheduler (either package) between two ticks while
    ``when()`` is true, until the returned callable releases it. The held
    loop keeps serving session commands (the first call of every tick),
    so a test acts on a request at a known point, however the machine's
    load stretches the test thread: a gate, not a clock."""
    gate = threading.Event()
    serve = eng._service_migrations
    shutdown = getattr(eng, "_shutdown", threading.Event())

    def held_serve():
        serve()
        while when() and not gate.is_set() and not shutdown.is_set():
            gate.wait(0.005)
            serve()

    eng._service_migrations = held_serve

    def release():
        gate.set()
        del eng._service_migrations

    return release


def wait_until(cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond(), what


def submit_held(eng, prompt, min_tokens=3, **kw):
    """Submit on ``eng`` and hold its scheduler once the request has
    ``min_tokens`` tokens; returns (request, release)."""
    box = []
    release = held(eng, lambda: bool(box) and len(box[0].tokens)
                   >= min_tokens)
    try:
        box.append(eng.submit(prompt, **kw))
        wait_until(lambda: len(box[0].tokens) >= min_tokens,
                   "decode never started")
    except BaseException:
        release()
        raise
    return box[0], release


def export_mid_decode(src, prompt, min_tokens=5, **kw):
    """Submit on ``src``, hold it once a few tokens are out, export; the
    source request must finish with the migrated marker. Returns the one
    payload after a JSON round trip (the wire). The default holds after
    the second 4-token chunk, where the export landed when a sleep paced
    the ticks (a port payload taken after the first chunk resumes on the
    JAX engine with a sampled token parted at a near-tie: ROADMAP Queue
    3)."""
    req, release = submit_held(src, prompt, min_tokens, **kw)
    try:
        doc = src.export_sessions()
    finally:
        release()
    assert len(doc["sessions"]) == 1, doc
    assert req.done.wait(30) and "session migrated" in (req.error or "")
    return json.loads(json.dumps(doc["sessions"][0]))


def import_and_wait(dst, payload, timeout=120, **kw):
    meta = dst.import_session(json.loads(json.dumps(payload)), **kw)
    handle = meta.pop("_request")
    assert handle.done.wait(timeout), "imported session never finished"
    assert handle.error is None, handle.error
    return handle, meta


@pytest.fixture(scope="module")
def paged_pair():
    src, dst = BatchedEngine(MODEL, **PAGED), BatchedEngine(MODEL, **PAGED)
    yield src, dst
    src.close()
    dst.close()


@pytest.fixture(scope="module")
def peaked_export(tmp_path_factory):
    import jax

    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer(MODEL)
    params = dict(params)
    params["norm"] = {"scale": params["norm"]["scale"] * LOGIT_SCALE}
    d = tmp_path_factory.mktemp("peaked_migration_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


# ------------------------------------------------------------- wire format

def test_signatures_and_fingerprints_equal_the_reference():
    from datatunerx_tpu.models.config import get_config as jcfg
    from datatunerx_tpu.serving import migration as jmig
    from datatunerx_tpu_torch.models.config import get_config as tcfg

    for name in ("debug", "tinyllama-1.1b"):
        for quant in (None, "int8"):
            assert (tmig.model_signature(tcfg(name), quant)
                    == jmig.model_signature(jcfg(name), quant))
    rng = np.random.default_rng(0)
    for adapter in ("", "ad0-r2", "tenant/ü"):
        ids = rng.integers(0, 32000, size=int(rng.integers(1, 300)))
        assert (tmig.prefix_fingerprint(adapter, ids.tolist())
                == jmig.prefix_fingerprint(adapter, ids.tolist()))
    assert tmig.PREFIX_KIND == jmig.PREFIX_KIND
    assert tmig.MIGRATED_SESSION == jmig.MIGRATED_SESSION


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_build_and_normalize_payload_cross_the_packages(wire):
    """A payload either package builds from the same numpy row and state
    holds the same JSON (bodies included), and each normalizes the other's;
    raw in-process bodies encode to the same text."""
    import jax.numpy as jnp

    from datatunerx_tpu.models.config import get_config as jcfg
    from datatunerx_tpu.serving import migration as jmig
    from datatunerx_tpu_torch.models.config import get_config as tcfg

    rng = np.random.default_rng(1)
    L, W, KV, d, V, cursor = 2, 32, 2, 16, 256, 21
    cfg_j, cfg_t = jcfg("debug"), tcfg("debug")
    k = rng.standard_normal((L, 1, W, KV, d)).astype(np.float32)
    v = rng.standard_normal((L, 1, W, KV, d)).astype(np.float32)
    pos = np.where(np.arange(W) < cursor, np.arange(W), 2**30)[None]
    logits = rng.standard_normal(V).astype(np.float32)
    key = np.array([123456789, 987654321], np.uint32)
    request = {"trace_id": "t1", "adapter": "a", "prompt_ids": [1, 2, 3],
               "tokens": [4, 5], "max_new_tokens": 9, "temperature": 0.8,
               "top_p": 0.9, "seed": 7, "stop_ids": [2]}
    jrow = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v,
                                                              jnp.bfloat16),
            "pos": jnp.asarray(pos, jnp.int32)}
    trow = {"k": torch.from_numpy(k).to(torch.bfloat16),
            "v": torch.from_numpy(v).to(torch.bfloat16),
            "pos": torch.from_numpy(pos.astype(np.int32))}
    jp = jmig.build_payload(cfg_j, None, request, jrow, cursor, 3, 9, key,
                            logits, wire=wire)
    tp = tmig.build_payload(cfg_t, None, request, trow, cursor, 3, 9, key,
                            torch.from_numpy(logits), wire=wire)
    assert json.dumps(tp, sort_keys=True) == json.dumps(jp, sort_keys=True)
    raw = tmig.build_payload(cfg_t, None, request, trow, cursor, 3, 9, key,
                             torch.from_numpy(logits), wire=wire, b64=False)
    assert tmig.encode_payload(raw) == tp
    assert tmig.encode_payload(tp) == tp
    wire_tp = json.loads(json.dumps(tp))
    assert (tmig.normalize_payload(wire_tp, cfg_t)
            == jmig.normalize_payload(wire_tp, cfg_j))


# ----------------------------------------------------- port to port parity

@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_export_import_parity(paged_pair, sampling):
    src, dst = paged_pair
    kw = SAMPLED if sampling == "sampled" else {}
    prompt = src.tokenizer.encode("the quick brown fox jumps over")
    want = src.generate(prompt, max_new_tokens=24, **kw)
    payload = export_mid_decode(src, prompt, max_new_tokens=24, **kw)
    assert payload["kv"]["wire"] == "bf16"
    assert payload["rng"] != [0, 0] and len(payload["rng"]) == 2
    handle, meta = import_and_wait(dst, payload)
    assert handle.tokens == want, (handle.tokens, want)
    assert meta["tokens"] == len(payload["tokens"])
    assert meta["text_so_far"] == src.tokenizer.decode(
        payload["tokens"], skip_special_tokens=True)
    assert src.free_kv_blocks == src.total_kv_blocks
    assert dst.free_kv_blocks == dst.total_kv_blocks
    assert src.session_stats["export"].get("ok", 0) >= 1
    assert dst.session_stats["import"].get("ok", 0) >= 1
    assert any(e[0] == "import" for e in dst.sched_trace)


@pytest.mark.parametrize("route", ["dense_to_dense", "dense_to_paged",
                                   "paged_to_dense"])
def test_dense_layout_exports_and_imports(route):
    """The dense per-slot cache ships its row trimmed to the cursor and
    takes one in, in either direction against the paged pool."""
    a, b = route.split("_to_")
    src = BatchedEngine(MODEL, **(PAGED if a == "paged" else BASE))
    dst = BatchedEngine(MODEL, **(PAGED if b == "paged" else BASE))
    try:
        prompt = src.tokenizer.encode("dense rows move between engines")
        for kw in ({}, SAMPLED):
            want = src.generate(prompt, max_new_tokens=16, **kw)
            payload = export_mid_decode(src, prompt, max_new_tokens=16, **kw)
            assert payload["kv"]["width"] == payload["cursor"]
            handle, _ = import_and_wait(dst, payload)
            assert handle.tokens == want, (kw, handle.tokens, want)
    finally:
        src.close()
        dst.close()


def test_int8_kv_parity_and_cross_wire():
    """int8 engines ship their own int8 bytes and scales (exact, greedy and
    sampled); a bf16 wire into int8 pools re-quantizes and an int8 wire
    from a bf16 cache dequantizes: both run to completion with the tail
    kept verbatim."""
    q_src = BatchedEngine(MODEL, kv_quant="int8", **PAGED)
    q_dst = BatchedEngine(MODEL, kv_quant="int8", **PAGED)
    b_eng = BatchedEngine(MODEL, **PAGED)
    try:
        prompt = q_src.tokenizer.encode("quantized cache migration probe")
        for kw in ({}, SAMPLED):
            want = q_src.generate(prompt, max_new_tokens=16, **kw)
            payload = export_mid_decode(q_src, prompt, max_new_tokens=16,
                                        **kw)
            assert payload["kv"]["wire"] == "int8"
            assert "k_scale" in payload["kv"]
            handle, _ = import_and_wait(q_dst, payload)
            assert handle.tokens == want, (kw, handle.tokens, want)
        # bf16 wire (a bf16 cache's default) into int8 pools
        payload = export_mid_decode(b_eng, prompt, max_new_tokens=16)
        assert payload["kv"]["wire"] == "bf16"
        handle, _ = import_and_wait(q_dst, payload)
        assert handle.tokens[:len(payload["tokens"])] == payload["tokens"]
        assert len(payload["tokens"]) < len(handle.tokens) <= 16
        # the int8 wire asked of a bf16 cache, into bf16 pools
        req, release = submit_held(b_eng, prompt, max_new_tokens=16)
        try:
            doc = b_eng.export_sessions(wire_quant="int8")
        finally:
            release()
        payload = doc["sessions"][0]
        assert payload["kv"]["wire"] == "int8"
        handle, _ = import_and_wait(b_eng, payload)
        assert handle.tokens[:len(payload["tokens"])] == payload["tokens"]
        assert len(payload["tokens"]) < len(handle.tokens) <= 16
    finally:
        for e in (q_src, q_dst, b_eng):
            e.close()


def test_export_import_mixed_rank_adapters(tmp_path):
    """Adapter sessions move by NAME: the importer's one-slot pool loads
    the adapter on a miss inside the import's retries (evicting the other),
    and ranks 2 and 4 survive the trip."""
    from datatunerx_tpu_torch.serving.adapters import make_adapter_checkpoint

    cks = {n: make_adapter_checkpoint(str(tmp_path / n), MODEL, seed=3 + i,
                                      rank=2 * (i + 1))
           for i, n in enumerate(("a", "b"))}
    src = BatchedEngine(MODEL, adapters=cks, adapter_pool=2,
                        adapter_rank_max=8, **PAGED)
    dst = BatchedEngine(MODEL, adapters=cks, adapter_pool=1,
                        adapter_rank_max=8, **PAGED)
    try:
        prompt = src.tokenizer.encode("tenant session on the move")
        for adapter in ("a", "b"):
            want = src.generate(prompt, max_new_tokens=12, adapter=adapter)
            payload = export_mid_decode(src, prompt, max_new_tokens=12,
                                        adapter=adapter)
            assert payload["adapter"] == adapter
            handle, meta = import_and_wait(dst, payload)
            assert handle.tokens == want, (adapter, handle.tokens, want)
            assert meta["adapter"] == adapter
        assert dst.adapter_occupancy()["resident"] == 1
        assert want != src.generate(prompt, max_new_tokens=12)
        assert src.adapter_catalog() == cks
    finally:
        src.close()
        dst.close()


@pytest.mark.parametrize("tree", [None, "2x2"], ids=["chain", "tree"])
def test_spec_active_session_exports_and_reprimes(paged_pair, tree):
    """A spec-form session settles before export (the payload is the plain
    logits form, with the controller's state beside it as JSON), the spec
    importer re-primes its draft and keeps drafting, and the greedy
    continuation equals the plain engine's undisturbed stream, into a spec
    engine and into a plain one."""
    ref, plain_dst = paged_pair
    spec = dict(PAGED, slots=3, spec_draft="take:1", spec_k=3,
                spec_mode="on", spec_tree=tree)
    src = BatchedEngine(MODEL, **spec)
    try:
        prompt = src.tokenizer.encode("speculative sessions migrate too")
        want = ref.generate(prompt, max_new_tokens=20)
        # a verify step emits up to k + 1 tokens: held early, the imported
        # session has steps left to draft
        payload = export_mid_decode(src, prompt, min_tokens=3,
                                    max_new_tokens=20)
        assert any(e[0] == "spec_settle" for e in src.sched_trace)
        json.dumps(payload["spec"])
        if tree:
            assert src.spec_info()["tree_steps"] > 0
            assert payload["spec"]["plan"][0] == "tree"
            wire = {k: v for k, v in payload.items() if k != "spec"}
            assert "tree" not in json.dumps(wire)
        primes = sum(1 for e in src.sched_trace if e[0] == "spec_prime")
        proposed = src.spec_info()["proposed"]
        # the exporter's freed slot takes the import: spec into spec
        handle, _ = import_and_wait(src, payload)
        assert handle.tokens == want, (handle.tokens, want)
        assert sum(1 for e in src.sched_trace
                   if e[0] == "spec_prime") > primes
        assert src.spec_info()["proposed"] > proposed
        handle, _ = import_and_wait(plain_dst, payload)
        assert handle.tokens == want, (handle.tokens, want)
    finally:
        src.close()


# -------------------------------------------- across the two packages

def _engines(export_dir, **extra):
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JE

    kw = dict(dict(template="vanilla", max_seq_len=256, slots=2,
                   decode_chunk=4, kv_block_size=16, prefill_chunk=64),
              **extra)
    return JE(export_dir, **kw), BatchedEngine(export_dir, device="cpu", **kw)


def test_sessions_move_between_the_packages(peaked_export):
    """JAX to port and port to JAX, greedy and seeded-sampled: the moved
    stream equals the JAX engine's undisturbed one (and the port's own)."""
    jeng, teng = _engines(peaked_export)
    try:
        prompt = teng.tokenizer.encode("the quick brown fox jumps over")
        for kw in ({}, SAMPLED):
            want = jeng.generate(prompt, max_new_tokens=20, **kw)
            assert teng.generate(prompt, max_new_tokens=20, **kw) == want
            payload = export_mid_decode(jeng, prompt, max_new_tokens=20,
                                        **kw)
            handle, meta = import_and_wait(teng, payload)
            assert handle.tokens == want, ("jax->port", kw, handle.tokens)
            assert meta["cursor"] == payload["cursor"]
            payload = export_mid_decode(teng, prompt, max_new_tokens=20,
                                        **kw)
            handle, _ = import_and_wait(jeng, payload)
            assert handle.tokens == want, ("port->jax", kw, handle.tokens)
        greedy = jeng.generate(prompt, max_new_tokens=20)
        assert len({tuple(want), tuple(greedy)}) == 2  # sampling differs
        # the earliest hand-off, after the first chunk, greedy (a sampled
        # one parts at a near-tie there: ROADMAP Queue 3)
        for src, dst, way in ((jeng, teng, "jax->port"),
                              (teng, jeng, "port->jax")):
            payload = export_mid_decode(src, prompt, min_tokens=1,
                                        max_new_tokens=20)
            assert len(payload["tokens"]) <= 1 + BASE["decode_chunk"], way
            handle, _ = import_and_wait(dst, payload)
            assert handle.tokens == greedy, (way, handle.tokens, greedy)
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("tree", [None, "2x2"], ids=["chain", "tree"])
def test_spec_sessions_move_between_the_packages(peaked_export, tree):
    """Chain- and tree-spec sessions, greedy, in both directions: the
    continuation equals the JAX engine's undisturbed stream. (Sampled spec
    streams depend on where verify steps fall, which a settle and re-prime
    move, in the reference too.)"""
    jeng, teng = _engines(peaked_export, slots=3, spec_draft="take:1",
                          spec_k=3, spec_mode="on", spec_tree=tree)
    try:
        prompt = teng.tokenizer.encode("the quick brown fox jumps over")
        want = jeng.generate(prompt, max_new_tokens=20)
        # a prompt whose undisturbed streams agree across the packages (a
        # bf16 near-tie parts them on others, moved or not)
        assert teng.generate(prompt, max_new_tokens=20) == want
        payload = export_mid_decode(jeng, prompt, max_new_tokens=20)
        handle, _ = import_and_wait(teng, payload)
        assert handle.tokens == want, ("jax->port", handle.tokens, want)
        assert any(e[0] == "spec_prime" for e in teng.sched_trace)
        payload = export_mid_decode(teng, prompt, max_new_tokens=20)
        assert payload["spec"]["plan"][0] == ("tree" if tree else "chain")
        handle, _ = import_and_wait(jeng, payload)
        assert handle.tokens == want, ("port->jax", handle.tokens, want)
    finally:
        jeng.close()
        teng.close()


# ------------------------------------------------------------- the slot

def test_export_deactivates_slot_next_tenant_uncorrupted():
    """An exported slot is deactivated at once: a request admitted into it
    while another slot keeps decoding chunk-prefills undisturbed."""
    eng = BatchedEngine(MODEL, prefill_chunk=64, prefill_token_budget=64,
                        **PAGED)
    try:
        long_prompt = eng.tokenizer.encode("chunked prefill target " * 40)
        short = eng.tokenizer.encode("short co-tenant")
        want = eng.generate(long_prompt, max_new_tokens=8)
        # held once both slots decode: req_b is live when it is exported
        busy = lambda: (all(r is not None for r in eng._slot_req)  # noqa: E731
                        and all(eng._decode_ready))
        release = held(eng, busy)
        try:
            req_a = eng.submit(short, max_new_tokens=64, temperature=0.9,
                               seed=1)
            req_b = eng.submit(short, max_new_tokens=64, temperature=0.9,
                               seed=2)
            wait_until(busy, "both slots never decoded")
            slot_b = eng._slot_req.index(req_b)
            doc = eng.export_sessions(slots=[slot_b])
            assert len(doc["sessions"]) == 1
            assert not bool(eng._active[slot_b])
        finally:
            release()
        req_c = eng.submit(long_prompt, max_new_tokens=8)
        assert req_c.done.wait(120) and req_c.error is None, req_c.error
        assert req_c.tokens == want, (req_c.tokens, want)
        assert req_a.done.wait(120) and req_a.error is None
    finally:
        eng.close()


def test_an_idle_command_queue_costs_nothing(paged_pair):
    """With no command queued, the scheduler's first step touches no engine
    state: every handler stubbed to fail goes uncalled."""
    eng, _ = paged_pair
    calls = []
    eng._do_export = lambda cmd: calls.append(cmd)
    try:
        assert eng._mig_q.empty() and not eng._mig_retry
        before = dict(eng.session_stats)
        eng._service_migrations()
        assert calls == [] and eng.session_stats == before
    finally:
        del eng._do_export


# ------------------------------------------------------------- refusals

def test_import_refusals(paged_pair):
    src, dst = paged_pair
    prompt = src.tokenizer.encode("refusal probe")
    payload = export_mid_decode(src, prompt, max_new_tokens=12)

    def refused(match, **edits):
        bad = json.loads(json.dumps(payload))
        for key, val in edits.items():
            if key == "layers":
                bad["model_sig"]["layers"] = val
            else:
                bad[key] = val
        with pytest.raises(ValueError, match=match):
            dst.import_session(bad)

    refused("incompatible model", layers=999)
    refused("unknown adapter", adapter="nobody-registered-this")
    refused("exceeds this replica's context", cursor=256)
    refused("not a dtx-kv-session payload", kind="dtx-kv-prefix")
    refused("unsupported session payload version", version=2)
    refused("2-word PRNG key", rng=[1, 2, 3])
    refused("exceeds this replica's context", pending={
        "ids": list(range(250)), "mask": [1] * 250,
        "positions": list(range(250)), "n_prompt": 250, "max_new": 4,
        "base": 0, "done": 0})
    n_refused = dst.session_stats["import"].get("refused", 0)
    assert n_refused >= 7

    # every slot busy (held there until the refusal): the import waits out
    # wait_s, then is refused
    full = lambda: all(r is not None for r in dst._slot_req)  # noqa: E731
    release = held(dst, full)
    occupants = []
    try:
        occupants = [dst.submit(prompt, max_new_tokens=48)
                     for _ in range(dst.slots)]
        wait_until(full, "the slots never filled")
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="no free cache slot"):
            dst.import_session(json.loads(json.dumps(payload)), wait_s=0.3)
        assert time.monotonic() - t0 >= 0.3
    finally:
        release()
        for r in occupants:
            r.done.wait(120)
    assert dst.session_stats["import"]["refused"] == n_refused + 1


def test_import_waits_for_blocks_then_refuses():
    """No free blocks is transient: the import retries each tick until
    ``wait_s`` and is then refused; once the session holding the pool
    finishes, a longer wait admits it and it resumes exactly."""
    eng = BatchedEngine(MODEL, kv_blocks=16, **PAGED)
    src = BatchedEngine(MODEL, **PAGED)
    try:
        prompt = src.tokenizer.encode("blocks are short here")
        want = src.generate(prompt, max_new_tokens=40)
        payload = export_mid_decode(src, prompt, max_new_tokens=40)
        # the hog is held while it holds the pool, until the refusal
        release = held(eng, lambda: eng.free_kv_blocks == 0)
        try:
            # 64 prompt lanes + 180 new tokens reserve all 16 blocks
            hog = eng.submit(prompt, max_new_tokens=180)
            wait_until(lambda: eng.free_kv_blocks == 0,
                       "the hog never took the pool")
            with pytest.raises(ValueError, match="kv blocks exhausted"):
                eng.import_session(payload, wait_s=0.2)
            assert not hog.done.is_set()
        finally:
            release()
        # retried each tick until the hog's 180 tokens are out, however
        # long a loaded machine takes to decode them
        handle, _ = import_and_wait(eng, payload, wait_s=120,
                                    timeout_s=150)
        assert hog.done.is_set() and hog.error is None
        assert handle.tokens == want, (handle.tokens, want)
    finally:
        eng.close()
        src.close()


def test_closed_engine_refuses_commands():
    eng = BatchedEngine(MODEL, **PAGED)
    eng.close()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.export_sessions()
