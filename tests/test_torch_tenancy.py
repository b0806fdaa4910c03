"""The tenancy plane of the port (``datatunerx_tpu_torch/tenancy/`` and the
engine's tier-aware preemption), held against the JAX package: the
directory's round-trip and validation against the reference's, the host-RAM
adapter tier, pinned-tier eviction immunity with reloads from the host
tier, tier-aware preemption token for token against the JAX engine on the
same export, and the gating contract: with no tenant config the victim is
the youngest session and a tenant header changes nothing (the cases of
``tests/test_tenancy.py`` that concern one replica)."""

import json
import threading

import numpy as np
import pytest
import torch

from datatunerx_tpu.tenancy import load_tenants as jload_tenants
from datatunerx_tpu.tenancy.directory import TIER_RANK as JTIER_RANK
from datatunerx_tpu_torch.adapters import AdapterRegistry, AdapterStore
from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.models.lora import target_dims
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from datatunerx_tpu_torch.tenancy import HostAdapterTier, load_tenants
from datatunerx_tpu_torch.tenancy.directory import (
    TIER_RANK,
    TIERS,
    TenantDirectory,
    TenantSpec,
    tenant_entry_from_crd,
    validate_tenant_entry,
)
from datatunerx_tpu_torch.tenancy.host_tier import _entry_bytes

MODEL = "preset:debug"


# ------------------------------------------------------------ directory

def test_directory_roundtrip_and_resolution(tmp_path):
    cfg = {"plat": {"tier": "pinned", "adapters": ["plat-a"], "share": 4,
                    "ttft_p95_ms": 500},
           "batch": {"tier": "bulk", "share": 1, "kv_block_quota": 24}}
    for source in (cfg, json.dumps(cfg), json.dumps({"tenants": cfg})):
        d = load_tenants(source)
        assert isinstance(d, TenantDirectory)
        assert sorted(d.names()) == ["batch", "plat"]
        # the same directory as the reference's, entry for entry
        assert d.to_dict() == jload_tenants(source).to_dict()
    p = tmp_path / "tenants.json"
    p.write_text(json.dumps(cfg))
    d = load_tenants(str(p))
    assert d.get("plat").tier == "pinned"
    assert d.get("plat").share == 4.0
    assert d.get("batch").kv_block_quota == 24
    spec = d.get("plat")
    assert (TenantSpec.from_dict("plat", spec.to_dict()).to_dict()
            == spec.to_dict())
    assert load_tenants(d) is d

    assert d.resolve(tenant="batch", adapter="plat-a").name == "batch"
    assert d.resolve(adapter="plat-a").name == "plat"
    assert d.resolve(tenant="ghost", adapter="plat-a").name == "plat"
    assert d.resolve(tenant="ghost") is None
    assert d.resolve() is None
    assert d.pinned_adapters() == {"plat-a"}
    assert d.shares() == {"plat": 4.0, "batch": 1.0}

    g0 = d.generation
    d.upsert("batch", {"tier": "standard", "share": 2})
    assert d.generation > g0 and d.get("batch").tier == "standard"
    assert d.remove("batch") and not d.remove("batch")
    assert d.get("batch") is None
    assert load_tenants(None) is None
    assert load_tenants("") is None


@pytest.mark.parametrize("entry, field", [
    ({"tier": "gold"}, "tier"), ({"adapters": "not-a-list"}, "adapters"),
    ({"adapters": [""]}, "adapters"), ({"share": 0}, "share"),
    ({"kv_block_quota": -1}, "kv_block_quota"),
    ({"ttft_p95_ms": -5}, "ttft_p95_ms")])
def test_tenant_entry_validation_names_the_field(entry, field):
    with pytest.raises(ValueError, match=field):
        validate_tenant_entry("t", entry)


def test_tenant_entry_crd_keys_and_tiers():
    validate_tenant_entry("t", {"tier": "bulk", "adapters": ["a"],
                                "share": 2, "kv_block_quota": 8,
                                "ttft_p95_ms": 300})
    entry = tenant_entry_from_crd({"tier": "pinned", "kvBlockQuota": 8,
                                   "ttftP95Ms": 250})
    assert entry["kv_block_quota"] == 8 and entry["ttft_p95_ms"] == 250
    validate_tenant_entry("t", entry)
    # the scheduling contract: bulk gives way before standard before pinned
    assert TIER_RANK["bulk"] < TIER_RANK["standard"] < TIER_RANK["pinned"]
    assert set(TIERS) == set(TIER_RANK)
    assert TIER_RANK == JTIER_RANK


# ------------------------------------------------------------ host tier

def test_host_tier_entry_bytes_of_nested_trees():
    t = torch.zeros((4, 8))
    assert _entry_bytes({"q_proj": {"a": t, "b": t},
                         "v_proj": {"a": t, "b": t}}) == 4 * t.nbytes
    assert _entry_bytes([t, (t, t)]) == 3 * t.nbytes
    assert _entry_bytes({"q": [{"a": t}]}) == t.nbytes
    assert _entry_bytes({}) == 0
    assert _entry_bytes({"a": np.zeros((4, 8), np.float32)}) == 128
    tier = HostAdapterTier(max_bytes=8 * t.nbytes)
    assert tier.put("t", "ck:t", {"q_proj": {"a": t, "b": t}}, 2.0)
    assert tier.stats()["bytes"] == 2 * t.nbytes


def test_host_tier_lru_bounds_and_drop():
    t = torch.ones((16, 16))  # 1 KiB
    one = t.nbytes
    tier = HostAdapterTier(max_bytes=int(2.5 * one))
    assert tier.put("a", "ck:a", {"q": {"a": t}}, 1.0)
    assert tier.put("b", "ck:b", {"q": {"a": t}}, 1.0)
    assert tier.get("a", "ck:a") is not None  # b is now the coldest
    assert tier.put("c", "ck:c", {"q": {"a": t}}, 1.0)  # evicts b
    assert tier.get("b", "ck:b") is None
    assert tier.get("a", "ck:a") is not None
    s = tier.stats()
    assert s["evictions"] == 1 and s["entries"] == 2
    assert s["bytes"] <= s["max_bytes"]
    big = torch.ones((64, 16))
    assert not tier.put("big", "ck:big", {"q": {"a": big}}, 1.0)
    assert tier.get("a", "ck:other") is None  # keyed by (name, checkpoint)
    assert tier.drop("a") == 1 and tier.get("a", "ck:a") is None


def test_registry_pin_immunity_and_host_tier_reload():
    """Pinned-tier adapters never LRU-evict, and an evicted adapter reloads
    from the host tier with no checkpoint read."""
    cfg = get_config("debug")
    store = AdapterStore(cfg, pool_slots=2, rank_max=8)
    loads = []

    def loader(path):
        name = path.split(":", 1)[1]
        loads.append(name)
        out = {}
        for t in ("q_proj", "v_proj"):
            d_in, d_out = target_dims(cfg, t)
            out[t] = {"a": torch.full((cfg.num_layers, d_in, 2), 0.5),
                      "b": torch.full((cfg.num_layers, 2, d_out), 0.5)}
        return {"lora": {"layers": out}, "_scaling": 4.0}

    tier = HostAdapterTier(max_bytes=64 << 20)
    reg = AdapterRegistry(store, loader=loader, host_tier=tier)
    for n in ("p", "a", "b"):
        reg.register(n, f"ck:{n}")
    reg.set_pinned({"p"})
    assert reg.acquire("p", wait=True) is not None
    reg.release("p")
    assert reg.acquire("a", wait=True) is not None
    reg.release("a")
    # pool full; p is the coldest but PINNED, so a is the victim
    assert reg.acquire("b", wait=True) is not None
    reg.release("b")
    res = reg.resident()
    assert "p" in res and "a" not in res, res
    assert reg.acquire("a", wait=True) is not None  # from the host tier
    reg.release("a")
    assert loads == ["p", "a", "b"]
    assert reg.host_hits == 1 and reg.orbax_loads == 3
    hs = reg.host_tier_stats()
    assert hs["host_hits"] == 1 and hs["entries"] >= 1
    reg.set_pinned({"p", "a"})
    with pytest.raises(RuntimeError, match="exhausted"):
        reg.preload("b")
    reg.set_pinned({"p"})
    reg.unregister("a")
    assert tier.get("a", "ck:a") is None  # a deleted adapter stays deleted


# ---------------------------------------------- tier-aware preemption

TENANTS = {"plat": {"tier": "pinned", "share": 4},
           "batch": {"tier": "bulk", "share": 1}}
OVER = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
            kv_block_size=16)
CONTENDED = dict(OVER, kv_blocks=20, kv_overcommit="on")


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    import jax

    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer(MODEL)
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _storm_prompts(tok):
    """Three 60-token bulk prompts and a 17-token pinned one: admission
    reserves 5 blocks of 16 a session (the 64-token bucket plus a tick),
    so the four fill the 20-block pool, and every session needs a sixth
    block at the same tick, while the pinned one (28 new tokens) lives."""
    bulk = [list(tok.encode(f"storm lane {i} bulk probe " * 15)[:60])
            for i in range(3)]
    pin = list(tok.encode("pinned latency probe " * 5)[:17])
    assert all(len(p) == 60 for p in bulk) and len(pin) == 17
    return bulk, pin


def _near_tie(export_dir, prompt, prefix, max_new) -> bool:
    """JAX's bf16 logits for the step after ``prompt + prefix`` put the top
    two within 2 bf16 ulps (``tests/test_torch_engine.py``'s rule)."""
    import jax.numpy as jnp

    from datatunerx_tpu.models.llama import forward
    from datatunerx_tpu.utils.decoding import prepare_prompt
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, tok = load_model_and_tokenizer(export_dir,
                                                dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, max_new)
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


def _storm(eng, bulk, pin, kws):
    """The three bulk sessions (tenant "batch") and then the pinned one
    (tenant "plat", the YOUNGEST) handed to the scheduler in one admission
    pass. Returns (streams, preempted request indices, the trace's
    preempt/resume events with requests as indices)."""
    gate, parked = threading.Event(), threading.Event()
    admit = eng._admit_waiting

    def gated_admit():
        if not gate.is_set():
            parked.set()
            gate.wait()
        admit()

    eng._admit_waiting = gated_admit
    eng._wake.set()
    assert parked.wait(60), "the scheduler never reached its gate"
    reqs = [eng.submit(p, max_new_tokens=80, tenant="batch", **kw)
            for p, kw in zip(bulk, kws)]
    reqs.append(eng.submit(pin, max_new_tokens=28, tenant="plat"))
    gate.set()
    for i, r in enumerate(reqs):
        assert r.done.wait(300), f"request {i} stalled"
        assert r.error is None, (i, r.error)
    index = {r.seq: i for i, r in enumerate(reqs)}
    events = [(e[0], index[e[2]]) for e in eng.sched_trace
              if e[0] in ("preempt", "preempt_prefill")]
    return [r.tokens for r in reqs], {i for _, i in events}, events


def test_tier_aware_preemption_token_exact(export_dir):
    """On a starved pool the pinned tenant's session (the youngest, the one
    youngest-first would take) survives the bulk sessions' storm: with the
    directory the same bulk sessions are preempted as in the JAX engine,
    the pinned one never is, and every stream equals the eager engine's
    (the sampled one too: a parked session keeps its threefry key); without
    the directory the same engine preempts the pinned session. Greedy
    streams are held against the JAX engine's with the near-tie rule of
    ``tests/test_torch_kv_overcommit.py``."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine

    greedy = [{}, {}, {}]
    sampled = [{}, {"temperature": 0.8, "top_p": 0.9, "seed": 3}, {}]
    ref = BatchedEngine(export_dir, device="cpu", **OVER)
    try:
        bulk, pin = _storm_prompts(ref.tokenizer)
        want = {name: [ref.generate(p, max_new_tokens=80, **kw)
                       for p, kw in zip(bulk, kws)]
                + [ref.generate(pin, max_new_tokens=28)]
                for name, kws in (("greedy", greedy), ("sampled", sampled))}
    finally:
        ref.close()
    runs = {}
    for name, make, kws in (
            ("jax", lambda: JEngine(export_dir, tenants=TENANTS,
                                    **CONTENDED), greedy),
            ("qos", lambda: BatchedEngine(export_dir, tenants=TENANTS,
                                          device="cpu", **CONTENDED),
             greedy),
            ("qos-sampled", lambda: BatchedEngine(
                export_dir, tenants=TENANTS, device="cpu", **CONTENDED),
             sampled),
            ("control", lambda: BatchedEngine(export_dir, device="cpu",
                                              **CONTENDED), sampled)):
        eng = make()
        try:
            runs[name] = _storm(eng, bulk, pin, kws)
            if name != "control":
                usage = eng.tenant_usage()
                assert usage["plat"]["requests"] == 1
                assert usage["plat"]["tier"] == "pinned"
                assert usage["batch"]["requests"] == 3
                assert usage["batch"]["tokens_in"] == 180
            else:
                assert eng.tenant_usage() is None
        finally:
            eng.close()
    # the port: every stream exact, sampled included
    assert runs["qos"][0] == want["greedy"]
    assert runs["qos-sampled"][0] == want["sampled"]
    assert runs["control"][0] == want["sampled"]
    for name in ("qos", "qos-sampled"):
        assert runs[name][1], f"{name}: the pool was never contended"
        assert 3 not in runs[name][1], "a bulk requester preempted a pin"
    assert 3 in runs["control"][1], "tenancy off spared the youngest"
    # against the JAX engine: the same victims, the same events
    assert runs["qos"][1] == runs["jax"][1]
    assert runs["qos"][2] == runs["jax"][2]
    prompts = bulk + [pin]
    for i, (w, g) in enumerate(zip(runs["jax"][0], runs["qos"][0])):
        div = next((j for j in range(min(len(w), len(g))) if g[j] != w[j]),
                   None)
        if div is not None or len(g) != len(w):
            assert _near_tie(export_dir, prompts[i],
                             w[:div if div is not None else len(g)],
                             28 if i == 3 else 80), i


# ---------------------------------------------------- no-config identity

def test_no_tenant_config_byte_identity():
    """With no directory every tenancy hook is inert: a tenant header
    changes no token, the victim filter passes everything through and the
    pick is the youngest."""
    eng = BatchedEngine(MODEL, device="cpu", **dict(OVER, slots=2))
    try:
        assert eng.tenants is None and eng.tenant_usage() is None
        prompt = eng.tokenizer.encode("identity probe")
        plain = eng.generate(prompt, max_new_tokens=8)
        assert eng.generate(prompt, max_new_tokens=8,
                            tenant="ghost") == plain

        class _R:
            def __init__(self, seq, tier):
                self.seq, self.tenant_tier = seq, tier

        req_of = {0: _R(5, "bulk"), 1: _R(9, "pinned"), 2: _R(7, "bulk")}
        assert eng._tenant_filter_victims(_R(1, "bulk"), [0, 1, 2],
                                          req_of) == [0, 1, 2]
        assert eng._pick_victim([0, 1, 2], req_of) == 1  # the youngest
    finally:
        eng.close()


def test_directory_orders_victims_by_tier_then_age():
    eng = BatchedEngine(MODEL, device="cpu", tenants=TENANTS,
                        **dict(OVER, slots=2))
    try:
        class _R:
            def __init__(self, seq, tier):
                self.seq, self.tenant_tier = seq, tier

        req_of = {0: _R(5, "bulk"), 1: _R(9, "pinned"), 2: _R(7, "bulk"),
                  3: _R(8, "standard")}
        # a bulk requester never takes the pinned session
        assert eng._tenant_filter_victims(_R(1, "bulk"), [0, 1, 2, 3],
                                          req_of) == [0, 2, 3]
        assert eng._tenant_filter_victims(_R(1, "standard"), [0, 1],
                                          req_of) == [0, 1]
        # the lowest tier pays first, the youngest within it
        assert eng._pick_victim([0, 1, 2, 3], req_of) == 2
        assert eng._pick_victim([1, 3], req_of) == 3
        # the tenant resolves from the header, else from the adapter
        r = eng.submit([5, 6, 7], max_new_tokens=2, tenant="plat")
        assert r.tenant == "plat" and r.tenant_tier == "pinned"
        r2 = eng.submit([5, 6, 7], max_new_tokens=2, tenant="ghost")
        assert r2.tenant == "ghost" and r2.tenant_tier == "standard"
        assert r.done.wait(60) and r2.done.wait(60)
        usage = eng.tenant_usage()
        assert usage["plat"]["tokens_in"] == 3
        assert usage["plat"]["tokens_out"] == len(r.tokens)
        assert usage["ghost"]["requests"] == 1
    finally:
        eng.close()


def test_pinned_tenants_pin_their_adapters_in_the_pool(tmp_path):
    """The pinned tenants' adapters are the registry's pinned set, and a
    directory change reaches it through ``refresh_tenant_pins``."""
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep

    cks = make_adapter_sweep(str(tmp_path), MODEL, 2, ranks=(2,))
    a, b = sorted(cks)
    eng = BatchedEngine(MODEL, device="cpu", adapters=cks, adapter_pool=1,
                        tenants={"acme": {"tier": "pinned", "adapters": [a]}},
                        host_adapter_cache_mb=8, **dict(OVER, slots=2))
    try:
        assert eng.adapter_registry.pinned_names() == {a}
        eng.tenants.upsert("bolt", {"tier": "pinned", "adapters": [b]})
        eng.refresh_tenant_pins()
        assert eng.adapter_registry.pinned_names() == {a, b}
        usage = eng.tenant_usage()
        assert usage["acme"]["tier"] == "pinned"
        assert usage["acme"]["adapters_resident"] == 0
    finally:
        eng.close()
