"""The fleet plane over the port's engines (``tests/test_fleet.py``
ported): mid-prefill handoff, peer spill of parked sessions and the prefix
tier, held to the JAX package's engine where both run.

- A session exported MID-chunked-prefill resumes on the peer where the
  source stopped: the peer prefills only the tail, and the stream is token
  for token an undisturbed run's (greedy and seeded-sampled, int8 and a
  pooled adapter), port to port and across the packages (the ``pending``
  document is the contract between them).
- A prefix published through the tier admits on a second replica with ZERO
  prefill chunks and the same tokens, across the packages too.
- A parked session leased by ``hold_parked`` neither resumes nor lets a
  younger request in; ``release_parked`` resumes it here, an expired hold
  too; a spill to a peer resumes it token for token, and the books balance.

The coordinators are the port's own (``datatunerx_tpu_torch/fleet``), run
over the reference gateway's ``ReplicaPool`` and ``InProcessReplica``
wrapping port engines, and over the reference tests' fakes for policy.
Pools keep their default size (every slot's whole table) wherever prefix
entries are imported: admission never reclaims a prefix entry, in either
package (ROADMAP Queue 3), so a short pool would leave a request waiting
behind imported entries."""

import json
import time

import pytest

from datatunerx_tpu.gateway.replica_pool import (
    InProcessReplica,
    ReplicaError,
    ReplicaPool,
)
from datatunerx_tpu_torch.fleet import (
    FleetPlane,
    HandoffCoordinator,
    PrefixTier,
    SpillCoordinator,
)
from datatunerx_tpu_torch.fleet.handoff import decode_targets
from datatunerx_tpu_torch.fleet.prefix_tier import payload_bytes
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from tests.test_fleet import (
    _FakePool,
    _FakePrefixReplica,
    _FakeSessionReplica,
    _prefix_payload,
)
from tests.test_torch_migration import (  # noqa: F401 — fixture
    BASE,
    PAGED,
    SAMPLED,
    _engines,
    import_and_wait,
    peaked_export,
    throttled,
)

MODEL = "preset:debug"
CHUNKED = dict(PAGED, prefill_chunk=64, prefill_token_budget=64)


def throttled_prefill(eng, delay=0.05):
    """Slow each prefill chunk of ``eng`` (either package) so a test can
    catch a prompt mid-chunked-prefill; returns the restore callable."""
    orig = eng._prefill_chunk_fn

    def slow(*a, **k):
        time.sleep(delay)
        return orig(*a, **k)

    eng._prefill_chunk_fn = slow
    return lambda: setattr(eng, "_prefill_chunk_fn", orig)


def export_mid_prefill(src, prompt, **kw):
    """Submit a chunk-prefilling prompt, catch it with the prompt partly
    done and export it with ``include_prefill``."""
    restore = throttled_prefill(src)
    try:
        req = src.submit(prompt, **kw)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(0 < st["done"] < st["plen"]
                   for st in list(src._pending.values())):
                break
            time.sleep(0.002)
        else:
            pytest.fail("request never caught mid-chunked-prefill")
        doc = src.export_sessions(include_prefill=True)
    finally:
        restore()
    assert len(doc["sessions"]) == 1, doc
    assert req.done.wait(30) and "session migrated" in (req.error or "")
    return json.loads(json.dumps(doc["sessions"][0]))


def prefill_tokens(eng, mark=0):
    """Prompt tokens chunk-prefilled since trace index ``mark``."""
    return sum(ev[2] for ev in list(eng.sched_trace)[mark:]
               if ev[0] == "prefill")


@pytest.fixture(scope="module")
def chunked_pair():
    src, dst = BatchedEngine(MODEL, **CHUNKED), BatchedEngine(MODEL,
                                                              **CHUNKED)
    yield src, dst
    src.close()
    dst.close()


# ------------------------------------------- mid-prefill export / import

@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_mid_prefill_export_import_parity(chunked_pair, sampling):
    src, dst = chunked_pair
    kw = SAMPLED if sampling == "sampled" else {}
    prompt = src.tokenizer.encode("chunked prefill handoff target " * 30)
    want = src.generate(prompt, max_new_tokens=12, **kw)
    payload = export_mid_prefill(src, prompt, max_new_tokens=12, **kw)
    pending = payload["pending"]
    tail, done_src = len(pending["ids"]), int(pending["done"])
    assert tail > 0 and done_src > 0, pending
    assert payload["cursor"] == pending["base"] + done_src
    mark = len(dst.sched_trace)
    handle, meta = import_and_wait(dst, payload)
    assert handle.tokens == want, (handle.tokens, want)
    assert meta["prefill"] is True
    # the prompt work done is kept: the peer prefills only the tail
    assert prefill_tokens(dst, mark) == tail
    trace = list(dst.sched_trace)[mark:]
    assert any(e[0] == "import_prefill" for e in trace)
    assert src.session_stats["export"].get("ok_prefill", 0) >= 1
    assert dst.session_stats["import"].get("ok_prefill", 0) >= 1
    assert src.free_kv_blocks == src.total_kv_blocks
    assert dst.free_kv_blocks == dst.total_kv_blocks


def test_mid_prefill_export_skipped_without_flag(chunked_pair):
    """A plain export skips a mid-prefill slot, which finishes in place."""
    src, _ = chunked_pair
    prompt = src.tokenizer.encode("skip me while prefill runs " * 30)
    want = src.generate(prompt, max_new_tokens=8)
    restore = throttled_prefill(src)
    try:
        req = src.submit(prompt, max_new_tokens=8)
        deadline = time.monotonic() + 60
        while not any(0 < st["done"] < st["plen"]
                      for st in list(src._pending.values())) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        doc = src.export_sessions()
    finally:
        restore()
    assert doc["sessions"] == []
    assert any(s["reason"] == "prefill_in_progress" for s in doc["skipped"])
    assert src.session_stats["export"].get("skipped_prefill", 0) >= 1
    assert req.done.wait(120) and req.error is None
    assert req.tokens == want


def test_mid_prefill_int8_and_pooled_adapter_parity(tmp_path):
    from datatunerx_tpu_torch.serving.adapters import make_adapter_checkpoint

    ck = {"t-a": make_adapter_checkpoint(str(tmp_path / "a"), MODEL,
                                         seed=3, rank=2)}
    kw = dict(CHUNKED, adapters=ck, adapter_pool=1, adapter_rank_max=4,
              kv_quant="int8")
    src, dst = BatchedEngine(MODEL, **kw), BatchedEngine(MODEL, **kw)
    try:
        prompt = src.tokenizer.encode("tenant prefill on the move " * 30)
        want = src.generate(prompt, max_new_tokens=10, adapter="t-a")
        payload = export_mid_prefill(src, prompt, max_new_tokens=10,
                                     adapter="t-a")
        assert payload["adapter"] == "t-a"
        assert payload["kv"]["wire"] == "int8"
        handle, meta = import_and_wait(dst, payload)
        assert handle.tokens == want, (handle.tokens, want)
        assert meta["adapter"] == "t-a"
        assert want != src.generate(prompt, max_new_tokens=10)
    finally:
        src.close()
        dst.close()


def test_mid_prefill_moves_between_the_packages(peaked_export):
    """The pending document crosses the packages both ways: greedy and
    seeded-sampled, the moved stream equals the JAX engine's undisturbed
    one, and the importer prefills only the tail."""
    jeng, teng = _engines(peaked_export, prefill_token_budget=64)
    try:
        prompt = teng.tokenizer.encode("tokens go here and there " * 8)
        for kw in ({}, SAMPLED):
            want = jeng.generate(prompt, max_new_tokens=12, **kw)
            # a prompt whose undisturbed streams agree across the packages
            assert teng.generate(prompt, max_new_tokens=12, **kw) == want
            for src, dst in ((jeng, teng), (teng, jeng)):
                payload = export_mid_prefill(src, prompt, max_new_tokens=12,
                                             **kw)
                mark = len(dst.sched_trace)
                handle, _ = import_and_wait(dst, payload)
                assert handle.tokens == want, (type(src).__module__, kw)
                assert (prefill_tokens(dst, mark)
                        == len(payload["pending"]["ids"]))
    finally:
        jeng.close()
        teng.close()


# --------------------------------------------------- prefix tier (unit)

def test_prefix_tier_directory_lru_budget():
    tier = PrefixTier(byte_budget=250)
    assert tier.publish(_prefix_payload("f1"), source="r0")
    assert not tier.publish(_prefix_payload("f1"), source="r1")
    assert tier.holders("f1") == {"r0", "r1"}
    assert tier.publish(_prefix_payload("f2"), source="r0")
    assert tier.publish(_prefix_payload("f3"), source="r0")
    assert tier.entries == 2 and tier.counters["evicted"] == 1
    assert tier.holders("f1") == set()
    assert tier.bytes_used <= 250
    assert not tier.publish({"kv": {"k": "x"}})
    assert payload_bytes(_prefix_payload("f", nbytes=10)) >= 10
    st = tier.stats()
    assert st["entries"] == 2 and st["publishes"] == 3


def test_prefix_tier_sync_pull_push_and_refusals():
    tier = PrefixTier(1 << 20)
    src = _FakePrefixReplica("r0", entries=[_prefix_payload("f1")])
    ok = _FakePrefixReplica("r1")
    assert tier.sync(src)["pulled"] == 1 and tier.entries == 1
    assert tier.sync(ok)["pushed"] == 1 and tier.counters["hits"] == 1
    assert tier.sync(ok) == {"pulled": 0, "pushed": 0, "refused": 0}
    assert ok.offered == ["f1"]
    busy = _FakePrefixReplica("r2", mode="refuse")
    tier.sync(busy)
    tier.sync(busy)
    assert busy.offered == ["f1", "f1"]  # a 409 stays retryable
    assert tier.counters["misses"] == 2
    broken = _FakePrefixReplica("r3", mode="fault")
    tier.sync(broken)
    tier.sync(broken)
    assert broken.offered == ["f1"]  # a fault is not re-offered


def test_prefix_import_refusal_paths(chunked_pair):
    src, _ = chunked_pair  # no prefix cache
    pcache = BatchedEngine(MODEL, prefix_cache=4, **PAGED)
    try:
        prompt = pcache.tokenizer.encode("publish this prefix " * 10)
        req = pcache.submit(prompt, max_new_tokens=4)
        assert req.done.wait(120) and req.error is None
        doc = pcache.export_prefix_entries()
        assert len(doc["entries"]) == 1
        payload = doc["entries"][0]
        assert pcache.export_prefix_entries(
            exclude=[payload["fingerprint"]]) == {"entries": []}
        assert src.export_prefix_entries() == {"entries": []}
        with pytest.raises(ValueError, match="prefix cache disabled"):
            src.import_prefix_entry(json.loads(json.dumps(payload)))
        for key, val, match in (("layers", 999, "incompatible model"),
                                ("kind", "dtx-kv-session", "not a dtx-kv-"
                                                           "prefix"),
                                ("adapter", "nobody", "unknown adapter"),
                                ("cursor", 256, "unusable in context")):
            bad = json.loads(json.dumps(payload))
            if key == "layers":
                bad["model_sig"]["layers"] = val
            else:
                bad[key] = val
            bad["prompt_ids"] = bad["prompt_ids"][:-1]  # not cached here
            with pytest.raises(ValueError, match=match):
                pcache.import_prefix_entry(bad)
        # the engine's own entry is present already
        assert pcache.import_prefix_entry(payload) == {
            "imported": False, "reason": "present"}
        rep = InProcessReplica("r-shim", src)
        with pytest.raises(ReplicaError) as ei:
            rep.import_prefix_entry(payload)
        assert ei.value.status == 409
    finally:
        pcache.close()


@pytest.mark.parametrize("layout", ["paged", "cow"])
def test_prefix_tier_second_replica_zero_prefill(layout):
    """Replica A prefills a shared prompt once; the tier publishes it to B,
    whose first request on that prompt admits with ZERO prefill chunks and
    A's tokens (a COW block entry on an overcommit engine)."""
    kw = dict(CHUNKED, prefix_cache=4)
    if layout == "cow":
        kw["kv_overcommit"] = "on"
    a, b = BatchedEngine(MODEL, **kw), BatchedEngine(MODEL, **kw)
    try:
        prompt = a.tokenizer.encode("shared system preamble " * 20)
        req = a.submit(prompt, max_new_tokens=8)
        assert req.done.wait(120) and req.error is None
        tier = PrefixTier(16 << 20)
        ra, rb = InProcessReplica("rA", a), InProcessReplica("rB", b)
        assert tier.sync(ra)["pulled"] >= 1
        assert tier.sync(rb)["pushed"] >= 1
        fp = next(iter(tier._d))
        assert tier.holders(fp) >= {"rA", "rB"}
        mark = len(b.sched_trace)
        req_b = b.submit(prompt, max_new_tokens=8)
        assert req_b.done.wait(120) and req_b.error is None
        assert req_b.tokens == req.tokens
        assert prefill_tokens(b, mark) == 0
        mode = "cow" if layout == "cow" else "cache"
        assert any(ev[0] == "admit" and ev[3] == mode
                   for ev in list(b.sched_trace)[mark:])
        assert b.prefill_stats["reuse"] == 1
        assert b.session_stats["import_prefix"].get("ok", 0) == 1
    finally:
        a.close()
        b.close()


def test_prefix_entries_move_between_the_packages(peaked_export):
    """A prefix entry either package publishes admits on the other with no
    prefill chunk and the publisher's tokens."""
    jeng, teng = _engines(peaked_export, prefix_cache=4)
    try:
        for i, (src, dst) in enumerate(((jeng, teng), (teng, jeng))):
            prompt = teng.tokenizer.encode(f"shared preamble {i} " * 8)
            req = src.submit(prompt, max_new_tokens=8)
            assert req.done.wait(120) and req.error is None
            doc = src.export_prefix_entries(max_entries=1)
            payload = json.loads(json.dumps(doc["entries"][0]))
            assert payload["cursor"] >= len(prompt) and payload["logits"]
            assert dst.import_prefix_entry(payload)["imported"] is True
            mark = len(dst.sched_trace)
            got = dst.submit(prompt, max_new_tokens=8)
            assert got.done.wait(120) and got.error is None
            assert got.tokens == req.tokens
            assert prefill_tokens(dst, mark) == 0
    finally:
        jeng.close()
        teng.close()


# ------------------------------------------- coordinator policy (fakes)

def test_handoff_coordinator_policy():
    parked = {}
    sess = {"trace_id": "t1", "tokens": [1, 2]}
    src = _FakeSessionReplica(
        "pf", role="prefill", busy=2,
        export_doc={"sessions": [sess],
                    "skipped": [{"slot": 1,
                                 "reason": "prefill_in_progress"}]})
    dec = _FakeSessionReplica("dc", role="decode", free_blocks=9)
    hc = HandoffCoordinator(_FakePool([src, dec]),
                            park=lambda t, e: parked.__setitem__(t, e))
    assert hc.tick() == {"moved": 1, "cold": 0, "skipped": 1}
    assert hc.counters == {"ok": 1, "cold": 0, "skipped": 1, "none": 0}
    assert parked["t1"]["target"] == "dc"
    assert parked["t1"]["text_so_far"] == "tail "
    assert ("export", False) in src.calls
    pf2 = _FakeSessionReplica("pf2", role="prefill", free_blocks=99)
    assert [t.name for t in decode_targets(_FakePool([src, dec, pf2]),
                                           "pf")] == ["dc", "pf2"]
    parked.clear()
    dec.import_mode = pf2.import_mode = "refuse"
    hc2 = HandoffCoordinator(_FakePool([src, dec, pf2]),
                             park=lambda t, e: parked.__setitem__(t, e))
    hc2.tick()
    assert parked["t1"] == {"failed": True} and hc2.counters["cold"] == 1
    hc3 = HandoffCoordinator(_FakePool([src]), park=lambda t, e: None)
    hc3.tick()
    assert hc3.counters["none"] == 1


def test_spill_coordinator_two_phase_ordering():
    events = []
    sess = {"trace_id": "s1", "seq": 7, "payload": {"trace_id": "s1"}}
    src = _FakeSessionReplica("ovc", parked=1,
                              hold_doc={"sessions": [sess], "parked": 1})
    dst = _FakeSessionReplica("peer", role="decode", free_blocks=4)
    orig_drop = src.drop_parked

    def drop_traced(tids):
        events.append("drop")
        return orig_drop(tids)

    src.drop_parked = drop_traced
    sc = SpillCoordinator(
        _FakePool([src, dst]),
        park=lambda t, e: events.append(("park", t, e["target"])))
    assert sc.tick()["moved"] == 1 and sc.counters["ok"] == 1
    assert events == [("park", "s1", "peer"), "drop"]  # park before drop
    assert ("hold", sc.max_sessions, sc.hold_s) in src.calls
    src2 = _FakeSessionReplica("ovc2", parked=1,
                               hold_doc={"sessions": [sess], "parked": 1})
    full = _FakeSessionReplica("full", role="decode", free_blocks=2,
                               import_mode="refuse")
    sc2 = SpillCoordinator(_FakePool([src2, full]), park=lambda t, e: None)
    assert sc2.tick()["refused"] == 1 and sc2.counters["refused"] == 1
    assert ("release", ["s1"]) in src2.calls
    src3 = _FakeSessionReplica("ovc3", parked=1,
                               hold_doc={"sessions": [sess], "parked": 1})
    dry = _FakeSessionReplica("dry", role="decode", free_blocks=0)
    sc3 = SpillCoordinator(_FakePool([src3, dry]), park=lambda t, e: None)
    assert sc3.tick()["skipped"] == 1
    assert not any(c[0] == "hold" for c in src3.calls)
    src4 = _FakeSessionReplica("ovc4", parked=1,
                               hold_doc={"sessions": [sess], "parked": 1})
    src4.drop_fails = True
    dst4 = _FakeSessionReplica("peer4", role="decode", free_blocks=4)
    sc4 = SpillCoordinator(_FakePool([src4, dst4]), park=lambda t, e: None)
    sc4.tick()
    assert sc4.counters["error"] == 1


def test_fleet_plane_gating_and_ticks():
    plane = FleetPlane(_FakePool([]), park=lambda t, e: None)
    assert not plane.enabled and plane.tick() == {} and plane.stats() == {}
    plane = FleetPlane(_FakePool([]), park=lambda t, e: None,
                       prefix_budget_bytes=1 << 20, handoff=True, spill=True)
    assert plane.enabled
    assert set(plane.tick()) == {"handoff", "spill", "prefix"}
    assert set(plane.stats()) == {"handoff", "spill", "prefix"}
    plane.start(interval_s=0.01)
    time.sleep(0.05)
    plane.stop()


# ------------------------------------------------ over the port engines

def test_fleet_plane_ticks_over_port_engines():
    """One ``FleetPlane.tick`` over two port engines behind the reference
    gateway's pool: the handoff moves the prefill replica's decoding
    session to the decode replica, and the prefix tier publishes the
    prompt the prefill replica cached and pushes it to its peer."""
    kw = dict(PAGED, prefix_cache=4)
    a, b = BatchedEngine(MODEL, **kw), BatchedEngine(MODEL, **kw)
    try:
        prompt = a.tokenizer.encode("fleet plane probe " * 6)
        want = a.generate(prompt, max_new_tokens=24)
        parked = {}
        pool = ReplicaPool([InProcessReplica("P", a, role="prefill"),
                            InProcessReplica("D", b, role="decode")])
        plane = FleetPlane(pool, park=parked.__setitem__,
                           prefix_budget_bytes=64 << 20, handoff=True)
        restore = throttled(a)
        try:
            req = a.submit(prompt, max_new_tokens=24, trace_id="fp-1")
            while len(req.tokens) < 3:
                time.sleep(0.005)
            out = plane.tick()
        finally:
            restore()
        assert out["handoff"]["moved"] == 1, out
        assert out["prefix"]["pulled"] >= 1 and out["prefix"]["pushed"] >= 1
        assert parked["fp-1"]["target"] == "D"
        "".join(parked["fp-1"]["stream"])  # the continuation runs out
        assert req.done.is_set() and "session migrated" in req.error
        assert any(e[0] == "import" for e in b.sched_trace)
        stats = plane.stats()
        assert stats["handoff"]["ok"] == 1 and stats["prefix"]["hits"] >= 1
        mark = len(b.sched_trace)
        got = b.generate(prompt, max_new_tokens=24)
        assert got == want
        assert prefill_tokens(b, mark) == 0
    finally:
        a.close()
        b.close()


def test_handoff_coordinator_moves_port_sessions():
    """A role=prefill replica's decoding session moves to the decode
    replica; the parked continuation completes the undisturbed text."""
    a, b = BatchedEngine(MODEL, **PAGED), BatchedEngine(MODEL, **PAGED)
    try:
        prompt = a.tokenizer.encode("hand me over to decode")
        want = a.tokenizer.decode(a.generate(prompt, max_new_tokens=24),
                                  skip_special_tokens=True)
        parked = {}
        pool = ReplicaPool([InProcessReplica("P", a, role="prefill"),
                            InProcessReplica("D", b, role="decode")])
        hc = HandoffCoordinator(pool, park=parked.__setitem__)
        restore = throttled(a)
        try:
            req = a.submit(prompt, max_new_tokens=24, trace_id="h-1")
            while len(req.tokens) < 3:
                time.sleep(0.005)
            assert hc.tick()["moved"] == 1
        finally:
            restore()
        assert req.done.wait(30) and "session migrated" in req.error
        ent = parked["h-1"]
        assert ent["target"] == "D"
        assert ent["text_so_far"] + "".join(ent["stream"]) == want
        assert hc.counters["ok"] == 1
    finally:
        a.close()
        b.close()


def _parked_source(**extra):
    """An overcommit engine with a tight pool and a reference engine."""
    kw = dict(BASE, slots=4, kv_block_size=16)
    return (BatchedEngine(MODEL, kv_blocks=20, kv_overcommit="on", **kw,
                          **extra),
            BatchedEngine(MODEL, **kw))


def test_hold_release_and_expiry_on_the_engine():
    """A held parked head resumes nowhere and keeps a younger cold request
    out; ``release_parked`` lets it resume here, token for token; a hold
    that runs out does the same."""
    eng, ref = _parked_source()
    try:
        tok = eng.tokenizer
        prompts = [tok.encode(f"hold probe {i}") for i in range(4)]
        want = [ref.generate(p, max_new_tokens=80) for p in prompts]
        restore = throttled(eng, delay=0.02)
        try:
            reqs = [eng.submit(p, max_new_tokens=80) for p in prompts]
            deadline = time.monotonic() + 120
            while not eng.parked_sessions and time.monotonic() < deadline:
                time.sleep(0.001)
            doc = eng.hold_parked(max_sessions=1, hold_s=60)
        finally:
            restore()
        assert len(doc["sessions"]) == 1 and doc["parked"] >= 1
        held = doc["sessions"][0]
        assert held["payload"]["kind"] == "dtx-kv-session"
        assert isinstance(held["payload"]["kv"]["k"], str)  # wire-encoded
        head = next(r for r in reqs if r.trace_id == held["trace_id"])
        late = eng.submit(tok.encode("late arrival"), max_new_tokens=8)
        # the live sessions run out, or park behind the head (an OLDER
        # session parked later sorts ahead of the head, is not held and
        # resumes: wait for it too); then nothing resumes and the younger
        # request stays out
        deadline = time.monotonic() + 120
        while (any(r is not None for r in eng._slot_req)
               or not (eng._preempted and eng._preempted[0]["req"] is head)) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert all(r is None for r in eng._slot_req)
        assert not head.done.is_set() and not late.tokens
        assert eng._preempted[0]["req"] is head
        # a held entry is not leased twice
        again = eng.hold_parked(max_sessions=4, hold_s=0.01)["sessions"]
        assert held["trace_id"] not in {s["trace_id"] for s in again}
        assert eng.release_parked([held["trace_id"], "nobody"]) == {
            "released": 1}
        for i, r in enumerate(reqs):
            assert r.done.wait(120) and r.error is None, (i, r.error)
            assert r.tokens == want[i], i
        assert late.done.wait(120) and late.error is None
        assert eng.parked_sessions == 0
        assert eng.free_kv_blocks == eng.total_kv_blocks
        # a hold that runs out: the session resumes here by itself
        restore = throttled(eng, delay=0.02)
        try:
            reqs = [eng.submit(p, max_new_tokens=80) for p in prompts]
            deadline = time.monotonic() + 120
            while not eng.parked_sessions and time.monotonic() < deadline:
                time.sleep(0.001)
            assert eng.hold_parked(max_sessions=4, hold_s=0.2)["sessions"]
        finally:
            restore()
        for i, r in enumerate(reqs):
            assert r.done.wait(120) and r.error is None, (i, r.error)
            assert r.tokens == want[i], i
        assert eng.preempt_stats.get("spilled", 0) == 0
    finally:
        eng.close()
        ref.close()


def test_peer_spill_token_exact_counters_reconcile():
    """Parked sessions re-homed onto a peer through hold → import → drop
    resume token for token, and the books balance: the source's "spilled"
    count is the coordinator's ok count."""
    a, b = _parked_source()
    try:
        prompts = [a.tokenizer.encode(f"spill pressure probe {i}")
                   for i in range(4)]
        want_text = [b.tokenizer.decode(b.generate(p, max_new_tokens=80),
                                        skip_special_tokens=True)
                     for p in prompts]
        parked_box = {}
        pool = ReplicaPool([InProcessReplica("A", a, role="mixed"),
                            InProcessReplica("B", b, role="decode")])
        sc = SpillCoordinator(pool, park=parked_box.__setitem__)
        restore = throttled(a, delay=0.05)
        try:
            reqs = [a.submit(p, max_new_tokens=80, trace_id=f"spill-{i}")
                    for i, p in enumerate(prompts)]
            deadline = time.monotonic() + 120
            while sc.counters["ok"] == 0 and time.monotonic() < deadline:
                if a.parked_sessions:
                    sc.tick()
                if all(r.done.is_set() for r in reqs):
                    break
                time.sleep(0.01)
        finally:
            restore()
        assert sc.counters["ok"] >= 1, (sc.counters, a.preempt_stats)
        for i, r in enumerate(reqs):
            assert r.done.wait(300), f"request {i} stalled"
            if r.error is None:
                text = a.tokenizer.decode(r.tokens, skip_special_tokens=True)
                assert text == want_text[i], i
                continue
            assert "session migrated" in r.error, (i, r.error)
            ent = parked_box[r.trace_id]
            assert ent["target"] == "B"
            text = ent["text_so_far"] + "".join(ent["stream"])
            assert text == want_text[i], (i, text, want_text[i])
        assert a.preempt_stats.get("spilled", 0) == sc.counters["ok"]
        assert b.session_stats["import"].get("ok", 0) >= sc.counters["ok"]
        assert a.free_kv_blocks == a.total_kv_blocks
        assert b.free_kv_blocks == b.total_kv_blocks
    finally:
        a.close()
        b.close()
