"""Prefix keep-warm (``BatchedEngine(prefix_keep_warm=True)``) against the
JAX engine: a slot that is preempted under overcommit, or exported by a
drain, publishes its prompt's blocks as a ``no_reuse`` COW entry before it
frees them, so a resume admits through a COW strict-prefix hit instead of
prefilling the prompt again.

Both packages serve the same weights (``preset:debug`` exported with its
final norm scaled by 64, so every greedy step has a clear head) with the
same traffic; the prefix entries (``blocks``, ``full``, ``rem``,
``cursor``, ``no_reuse``), the ``keep_warm`` trace events and the greedy
streams after the resume must be equal."""

import threading

from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from tests.test_torch_migration import peaked_export  # noqa: F401 — fixture

ENTRY_KEYS = ("blocks", "full", "rem", "cursor", "no_reuse")


def _engines(export, **kw):
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine

    return (("jax", lambda: JEngine(export, prefix_keep_warm=True, **kw)),
            ("port", lambda: BatchedEngine(export, device="cpu",
                                           prefix_keep_warm=True, **kw)))


def _entries(eng):
    """Prompt tokens → the entry's fields, for every BLOCK entry."""
    return {key[0]: {k: (list(e[k]) if k == "blocks" else e.get(k))
                     for k in ENTRY_KEYS}
            for key, e in eng._prefix.snapshot_entries() if e.get("blocks")}


def _keep_warm_events(eng):
    return [e for e in eng.sched_trace if e[0] == "keep_warm"]


def _hold(eng, cond, ready):
    """Hold ``eng``'s scheduler (either package) at the start of a tick
    while ``cond()`` is true, serving session commands meanwhile; the
    returned ``parked`` event is set once it waits there with ``ready()``
    true, ``gate`` lets it go. A gate, not a clock: both engines stop at
    the same tick."""
    gate, parked = threading.Event(), threading.Event()
    serve = eng._service_migrations

    def held_serve():
        serve()
        while cond() and not gate.is_set():
            if ready():
                parked.set()
            gate.wait(0.005)
            serve()

    eng._service_migrations = held_serve
    return gate, parked


def test_keep_warm_needs_cow():
    for kw in (dict(), dict(kv_block_size=16, prefix_cache=2),
               dict(kv_block_size=16, kv_overcommit="on")):
        eng = BatchedEngine("preset:debug", template="vanilla",
                            max_seq_len=256, slots=1, device="cpu",
                            prefix_keep_warm=True, **kw)
        try:
            assert eng.prefix_keep_warm is False, kw
        finally:
            eng.close()


def test_keep_warm_on_preemption_matches_the_jax_engine(peaked_export):
    """Two sessions admitted in one pass into a pool that cannot hold both
    at full depth: growth reclaims the prefix entries, then preempts the
    younger session, whose slot republishes its prompt as a no_reuse entry;
    the session resumes once the elder finishes. The keep_warm events, the
    entries, the schedule and the greedy streams equal the JAX engine's."""
    kw = dict(template="vanilla", max_seq_len=192, slots=2, decode_chunk=4,
              kv_block_size=16, kv_overcommit="on", prefix_cache=2,
              kv_blocks=14)
    runs = {}
    makers = dict(_engines(peaked_export, **kw))
    makers["port-off"] = lambda: BatchedEngine(peaked_export, device="cpu",
                                               **kw)
    for name, make in makers.items():
        eng = make()
        try:
            tok = eng.tokenizer
            prompts = [tok.encode("the elder session, which keeps its slot"),
                       tok.encode("the younger one, preempted by growth")]
            reqs = []
            gate, _ = _hold(eng, lambda: len(reqs) < 2, lambda: False)
            try:
                for p in prompts:
                    reqs.append(eng.submit(p, max_new_tokens=120))
            finally:
                gate.set()
            for r in reqs:
                assert r.done.wait(120) and r.error is None, r.error
            # a preempt event names the request's sequence number, which
            # counts per process in one package: compare request indices
            index = {r.seq: i for i, r in enumerate(reqs)}
            runs[name] = dict(
                streams=[r.tokens for r in reqs],
                warm=_keep_warm_events(eng), entries=_entries(eng),
                trace=[e if e[0] != "preempt" else (e[0], e[1], index[e[2]])
                       for e in eng.sched_trace if e[0] in (
                           "admit", "grow", "preempt", "resume",
                           "keep_warm", "finish")],
                preempt=dict(eng.preempt_stats), free=eng.free_kv_blocks)
        finally:
            del eng._service_migrations
            eng.close()
    want, got = runs["jax"], runs["port"]
    assert want["preempt"].get("exported", 0) >= 1, want["preempt"]
    assert want["preempt"].get("resumed", 0) >= 1, want["preempt"]
    assert len(want["warm"]) >= 1 and runs["port-off"]["warm"] == []
    # keep-warm is invisible in the port's tokens; the elder session's
    # stream equals the JAX engine's, and the resumed one parts from it at
    # a near-tie with keep-warm off too (``test_torch_kv_overcommit.py``
    # holds those by its near-tie rule)
    assert got["streams"] == runs["port-off"]["streams"]
    assert got["streams"][0] == want["streams"][0]
    for key in ("warm", "entries", "trace", "preempt", "free"):
        assert got[key] == want[key], key


def test_keep_warm_on_drain_export_matches_the_jax_engine(peaked_export):
    """Two sessions mid-decode, their prompts' entries gone from the cache
    (as LRU churn takes them; evicted here while the scheduler is held),
    then a drain export: each slot publishes a no_reuse entry. A request
    that extends one of the prompts then admits through a COW strict-prefix
    hit on it (``cow_extend``) and prefills only the extension."""
    kw = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
              kv_block_size=16, kv_overcommit="on", prefix_cache=4,
              kv_blocks=32)
    runs = {}
    for name, make in _engines(peaked_export, **kw):
        eng = make()
        try:
            tok = eng.tokenizer
            prompts = [tok.encode("keep the first session's prompt warm"),
                       tok.encode("and the second one, a little longer, "
                                  "across the drain")]
            reqs = []

            def three_out():
                return len(reqs) == 2 and all(len(r.tokens) >= 3
                                              for r in reqs)

            # admitted in one pass, then held at the first tick that
            # starts with three tokens out on both
            gate, parked = _hold(eng, lambda: len(reqs) < 2 or three_out(),
                                 three_out)
            try:
                for p in prompts:
                    reqs.append(eng.submit(p, max_new_tokens=96))
                assert parked.wait(120), "decode never reached 3 tokens"
                n_tokens = [len(r.tokens) for r in reqs]
                while True:  # the churn: the prompts' entries leave
                    ent = eng._prefix.pop_lru_block_entry()
                    if ent is None:
                        break
                    eng._free_prefix_entry(ent)
                assert _entries(eng) == {}
                doc = eng.export_sessions()
            finally:
                gate.set()
            for r in reqs:
                assert r.done.wait(60)
            entries = _entries(eng)
            warm = _keep_warm_events(eng)
            mark = len(eng.sched_trace)
            ext = prompts[1] + tok.encode(" and then a next turn")
            stream = eng.generate(ext, max_new_tokens=24)
            admits = [e for e in list(eng.sched_trace)[mark:]
                      if e[0] in ("admit", "prefill")]
            runs[name] = dict(entries=entries, warm=warm, stream=stream,
                              admits=admits, n_tokens=n_tokens,
                              exported=len(doc["sessions"]),
                              cursors=[s["cursor"] for s in doc["sessions"]])
        finally:
            del eng._service_migrations
            eng.close()
    want, got = runs["jax"], runs["port"]
    assert want["exported"] == 2 and len(want["warm"]) == 2
    assert all(e["no_reuse"] for e in want["entries"].values())
    assert sorted(want["entries"]) == sorted(tuple(p) for p in prompts)
    for e in want["entries"].values():
        assert (e["full"], e["rem"]) == divmod(e["cursor"], 16)
        assert len(e["blocks"]) == e["full"] + (1 if e["rem"] else 0)
    assert [e[3] for e in want["admits"] if e[0] == "admit"] \
        == ["cow_extend"]
    assert got == want
