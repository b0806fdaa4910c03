"""Prefix-cache reuse in the port's ``BatchedEngine`` (``tests/
test_prefix_cache.py`` ported, on the dense and the paged layout): exact hits
skip prefill, shared-prefix prompts extend a cached row, the LRU evicts, and
every reuse path produces exactly the cold path's tokens. Plus greedy parity
with the JAX engine with the prefix cache on, on the same weights (the JAX
``preset:debug`` export), under ``tests/test_torch_engine.py``'s near-tie
rule.

The reference's ``/metrics`` prefix counters
(``test_metrics_endpoint_exposes_prefix_counters``) are held on the port's
server too, on both layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.decoding import prepare_prompt
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.serving.batched_engine import (
    BatchedEngine,
    _PrefixCache,
)

BASE = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4)
LAYOUTS = {"dense": dict(kv_block_size=0),
           "paged": dict(kv_block_size=16, paged_kernel="on")}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def engines(request):
    kw = dict(BASE, device="cpu", **LAYOUTS[request.param])
    cold = BatchedEngine("preset:debug", **kw)
    cached = BatchedEngine("preset:debug", prefix_cache=3, **kw)
    yield cold, cached
    cold.close()
    cached.close()


# ----------------------------------------------------------- unit: LRU

def test_lru_unit():
    pc = _PrefixCache(2)
    pc.put(((1, 2), 0), {"cursor": 2})
    pc.put(((1, 2, 3), 0), {"cursor": 3})
    assert pc.get(((1, 2), 0)) is not None  # refresh
    pc.put(((9,), 0), {"cursor": 1})        # evicts (1,2,3)
    assert pc.get(((1, 2, 3), 0)) is None
    assert pc.get(((1, 2), 0)) is not None
    key, _ = pc.longest_prefix((1, 2, 7, 8), 0)
    assert key == ((1, 2), 0)
    # strict prefix only: the full tuple itself must not match
    assert pc.longest_prefix((1, 2), 0)[0] is None
    # adapter isolation
    assert pc.longest_prefix((1, 2, 7), 1)[0] is None


def test_trie_deepest_wins_and_eviction_prunes():
    pc = _PrefixCache(4)
    pc.put(((5,), 0), {"cursor": 1})
    pc.put(((5, 6), 0), {"cursor": 2})
    pc.put(((5, 6, 7), 0), {"cursor": 3})
    assert pc.longest_prefix((5, 6, 7, 8, 9), 0)[0] == ((5, 6, 7), 0)
    pc.get(((5,), 0))
    pc.get(((5, 6), 0))
    pc.put(((1,), 0), {"cursor": 1})
    pc.put(((2,), 0), {"cursor": 1})  # evicts (5,6,7) (LRU)
    assert pc.get(((5, 6, 7), 0)) is None
    assert pc.longest_prefix((5, 6, 7, 8, 9), 0)[0] == ((5, 6), 0)
    assert pc.evictions == 1


def test_trie_update_existing_key_keeps_single_terminal():
    evicted = []
    pc = _PrefixCache(2, on_evict=evicted.append)
    pc.put(((3, 4), 0), {"cursor": 2})
    pc.put(((3, 4), 0), {"cursor": 9})  # update, not insert
    assert len(pc) == 1
    assert evicted == [{"cursor": 2}]  # same-key replacement reaches the hook
    key, ent = pc.longest_prefix((3, 4, 5), 0)
    assert key == ((3, 4), 0) and ent["cursor"] == 9
    pc.put(((8,), 0), {"cursor": 1})
    pc.put(((9,), 0), {"cursor": 1})
    assert pc.longest_prefix((3, 4, 5), 0) == (None, None)


def test_trie_adapter_roots_isolated():
    pc = _PrefixCache(4)
    pc.put(((1, 2), 0), {"cursor": 2})
    pc.put(((1, 2), 1), {"cursor": 2})
    assert pc.longest_prefix((1, 2, 3), 0)[0] == ((1, 2), 0)
    assert pc.longest_prefix((1, 2, 3), 1)[0] == ((1, 2), 1)
    pc.put(((7,), 0), {"cursor": 1})
    pc.put(((8,), 0), {"cursor": 1})
    pc.put(((9,), 0), {"cursor": 1})  # capacity 4: evicts ((1,2),0)
    assert pc.longest_prefix((1, 2, 3), 0) == (None, None)
    assert pc.longest_prefix((1, 2, 3), 1)[0] == ((1, 2), 1)


def test_pop_lru_block_entry_skips_row_entries():
    pc = _PrefixCache(4)
    pc.put(((1,), 0), {"cursor": 1, "cache": {}})
    pc.put(((2,), 0), {"cursor": 1, "blocks": [3]})
    pc.put(((3,), 0), {"cursor": 1, "blocks": [4]})
    assert pc.pop_lru_block_entry()["blocks"] == [3]
    assert pc.longest_prefix((2, 9), 0) == (None, None)
    assert pc.pop_lru_block_entry()["blocks"] == [4]
    assert pc.pop_lru_block_entry() is None
    assert len(pc) == 1


# ------------------------------------------------- engine: reuse paths

def test_exact_reuse_matches_cold(engines):
    cold, cached = engines
    prompt = cold.tokenizer.encode("the quick brown fox jumps")
    want = cold.generate(prompt, max_new_tokens=10)
    got1 = cached.generate(prompt, max_new_tokens=10)
    full_after_first = cached.prefill_stats["full"]
    got2 = cached.generate(prompt, max_new_tokens=10)
    assert got1 == want and got2 == want
    assert cached.prefill_stats["full"] == full_after_first  # no new prefill
    assert cached.prefill_stats["reuse"] >= 1


def test_prefix_extension_matches_cold(engines):
    cold, cached = engines
    base = cold.tokenizer.encode("shared system preamble for every request")
    longer = base + cold.tokenizer.encode(" user question one")
    want = cold.generate(longer, max_new_tokens=10)
    cached.generate(base, max_new_tokens=1)  # seed the prefix entry
    before = dict(cached.prefill_stats)
    assert cached.generate(longer, max_new_tokens=10) == want
    assert cached.prefill_stats["extend"] == before["extend"] + 1
    assert cached.prefill_stats["full"] == before["full"]


def test_extension_chain_and_second_hit(engines):
    """The extended entry is itself cached: a repeat of the longer prompt
    is an exact hit, and a yet-longer prompt extends the extended row."""
    _, cached = engines
    tok = cached.tokenizer
    base = tok.encode("chain base segment")
    mid = base + tok.encode(" plus middle")
    long_ = mid + tok.encode(" plus tail")
    cached.generate(base, max_new_tokens=1)
    cached.generate(mid, max_new_tokens=1)
    before = dict(cached.prefill_stats)
    r1 = cached.generate(mid, max_new_tokens=4)
    assert cached.prefill_stats["reuse"] == before["reuse"] + 1
    r2 = cached.generate(long_, max_new_tokens=4)
    assert cached.prefill_stats["extend"] == before["extend"] + 1
    assert r1 and r2


def test_long_generation_after_extension_matches_cold(engines):
    """Decode continues at the row's REAL KV depth (the cursor), not at the
    prompt's own bucketed plen: an extended row sits deeper, and a cursor
    reset to plen would overwrite the cached suffix's KV."""
    cold, cached = engines
    base = cold.tokenizer.encode("kv depth regression base prompt")
    longer = base + cold.tokenizer.encode(" with extra tail words")
    want = cold.generate(longer, max_new_tokens=110)
    cached.generate(base, max_new_tokens=1)
    before = dict(cached.prefill_stats)
    got = cached.generate(longer, max_new_tokens=110)
    assert cached.prefill_stats["extend"] == before["extend"] + 1
    assert got == want


def test_reuse_never_shrinks_decode_budget(engines):
    """A budget the cold path fits but the deeper cached row does not must
    take the cold path: cache state never changes the response."""
    cold, cached = engines
    tok = cached.tokenizer
    base = tok.encode("budget parity base")
    longer = base + tok.encode(" tail")
    cached.generate(base, max_new_tokens=1)
    cached.generate(longer, max_new_tokens=1)  # extended entry, deep cursor
    want = cold.generate(longer, max_new_tokens=180)
    before = dict(cached.prefill_stats)
    assert cached.generate(longer, max_new_tokens=180) == want
    # the exact entry's cursor (128) cannot serve 180 new tokens
    assert cached.prefill_stats["reuse"] == before["reuse"]
    assert cached.prefill_stats["full"] == before["full"] + 1


def test_metrics_endpoint_exposes_prefix_counters(engines):
    """``GET /metrics`` on the port's server surfaces the prefix cache's
    hit, miss and eviction counters and its entries gauge, and an exact
    repeat counts a hit (the reference's test of the same name)."""
    import threading
    import urllib.request

    from datatunerx_tpu_torch.serving import server as srv_mod

    _, cached = engines
    prompt = cached.tokenizer.encode("metrics endpoint probe")
    cached.generate(prompt, max_new_tokens=2)
    cached.generate(prompt, max_new_tokens=2)  # exact hit
    state = srv_mod.ServingState()
    state.engine = cached
    handler = type("H", (srv_mod.Handler,), {"state": state})
    srv = srv_mod.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    for name in ("dtx_serving_prefix_cache_hits_total",
                 "dtx_serving_prefix_cache_misses_total",
                 "dtx_serving_prefix_cache_evictions_total",
                 "dtx_serving_prefix_cache_entries"):
        assert name in body
    hits = [line for line in body.splitlines()
            if line.startswith("dtx_serving_prefix_cache_hits_total")]
    assert hits and float(hits[0].split()[-1]) >= 1


def test_reuse_does_not_corrupt_shared_entry(engines):
    """Requests admitted from one cached prefix do not interfere: stored
    rows are never written, slots get copies."""
    _, cached = engines
    prompt = cached.tokenizer.encode("immutability probe prompt")
    a = cached.generate(prompt, max_new_tokens=8)
    reqs = [cached.submit(prompt, max_new_tokens=8) for _ in range(2)]
    for r in reqs:
        assert r.done.wait(300) and r.error is None
    c = cached.generate(prompt, max_new_tokens=8)
    assert a == reqs[0].tokens == reqs[1].tokens == c
    if cached.paged:
        assert cached.free_kv_blocks == cached.total_kv_blocks


# ------------------------------------------------- parity with the JAX engine

@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _near_tie(export_dir, prompt, prefix, new) -> bool:
    cfg, params, tok = jload(export_dir, dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, new)
    seq = ids + list(prefix)
    pos = positions + list(range(n, n + len(prefix)))
    msk = mask + [1] * len(prefix)
    logits, _ = jforward(params, jnp.asarray([seq]), cfg,
                         positions=jnp.asarray([pos]),
                         attention_mask=jnp.asarray([msk]),
                         compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1][:2]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
    return (top[0] - top[1]) <= 2 * ulp


def _traffic(engine):
    """Cold, exact hit, extension, and a two-request batch off one entry."""
    tok = engine.tokenizer
    base = tok.encode("a shared preamble that many requests start with")
    longer = base + tok.encode(" and then a question")
    out = [engine.generate(base, max_new_tokens=10),
           engine.generate(base, max_new_tokens=10),
           engine.generate(longer, max_new_tokens=10)]
    reqs = [engine.submit(p, max_new_tokens=10) for p in (longer, base)]
    for r in reqs:
        assert r.done.wait(300) and r.error is None
        out.append(r.tokens)
    return [base, base, longer, longer, base], out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_parity_with_jax_engine_prefix_cache_on(export_dir, layout):
    kw = dict(BASE, prefix_cache=3, **LAYOUTS[layout])
    jeng = JEngine(export_dir, **kw)
    try:
        prompts, want = _traffic(jeng)
        jstats = dict(jeng.prefill_stats)
    finally:
        jeng.close()
    teng = BatchedEngine(export_dir, device="cpu", **kw)
    try:
        _, got = _traffic(teng)
        assert teng.prefill_stats == jstats
    finally:
        teng.close()
    for p, w, g in zip(prompts, want, got):
        div = next((i for i in range(min(len(w), len(g))) if g[i] != w[i]),
                   None)
        if div is not None or len(g) != len(w):
            assert _near_tie(export_dir, p, w[:div or len(g)], 10)
