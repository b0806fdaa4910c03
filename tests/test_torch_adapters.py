"""Adapters on the port's serving engines, held against the JAX package.

- The stacked-adapter projection and forward (``lora_idx``: each row
  gathers its own adapter from ``[E, ...]`` leaves) against the JAX
  ``_proj``/``forward`` at f32 (atol 2e-4, rtol 2e-3, the tolerance of
  ``tests/test_torch_lora.py``), and in bf16 with a scale bf16 cannot
  represent (32 / 6), bit for bit.
- The static mixed-adapter engine's greedy streams against the JAX
  ``BatchedEngine`` serving the same adapters on the same export (paged
  kernel, gather and dense; bf16 and int8 KV), with the near-tie rule of
  ``tests/test_torch_engine.py``.
- The pooled engine equal to the static one token for token (rank padding
  is invisible).
- The cases of ``tests/test_adapter_plane.py`` that concern one replica:
  store padding and clear, geometry errors, the registry (LRU, pins,
  re-register, non-blocking acquire), the FIFO wait on an exhausted pool, a
  rebind dropping the prefix cache, a warm failure, decode during a load,
  and the ``/admin/adapters`` contract including a static engine's 501.
- ``--checkpoint_path`` end to end: the port's trainer CLI trains a LoRA
  run, and both packages serve the same leaves (the JAX side through its
  own ``CheckpointManager``): the batched engines name it ``"default"`` and
  answer a request without ``model`` with the BASE model, the
  single-request engines merge it.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import _proj as jproj
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
from datatunerx_tpu.training.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.decoding import prepare_prompt
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.adapters import (
    AdapterPinnedError,
    AdapterRankError,
    AdapterRegistry,
    AdapterStore,
    AdapterTargetError,
    hbm_bytes,
)
from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.models.convert import params_from_jax
from datatunerx_tpu_torch.models.llama import _proj as tproj
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.lora import target_dims
from datatunerx_tpu_torch.serving import server as tserver
from datatunerx_tpu_torch.serving.adapters import (
    make_adapter_checkpoint,
    make_adapter_sweep,
)
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from datatunerx_tpu_torch.training.checkpoint import load_raw_state

MODEL = "preset:debug"
TOL = dict(atol=2e-4, rtol=2e-3)
ENGINE = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
              prefill_chunk=64, prefill_token_budget=64)
LAYOUTS = {
    "dense": dict(kv_block_size=0, paged_kernel="auto",
                  sampling_epilogue="off"),
    "gather": dict(kv_block_size=16, paged_kernel="off",
                   sampling_epilogue="off"),
    "kernel": dict(kv_block_size=16, paged_kernel="on",
                   sampling_epilogue="on"),
}
NEW = 8
POOLED = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
              kv_block_size=16, device="cpu")


# ----------------------------------------------------- stacked projection

def _stack(rng, E, d_in, r, d_out, scale=0.1):
    a = (rng.standard_normal((E, d_in, r)) * scale).astype(np.float32)
    b = (rng.standard_normal((E, r, d_out)) * scale).astype(np.float32)
    a[0] = 0.0  # row 0: the all-zero base adapter
    b[0] = 0.0
    return a, b


def test_stacked_proj_matches_jax_f32():
    rng = np.random.default_rng(0)
    B, T, D, O, E, r = 3, 5, 64, 48, 4, 6
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, O)) * 0.05).astype(np.float32)
    a, b = _stack(rng, E, D, r, O)
    scales = np.array([0.0, 32 / 6, 2.0, 32 / 3], np.float32)
    idx = np.array([0, 1, 3], np.int32)
    want = jproj(jnp.asarray(h), {"kernel": jnp.asarray(w)},
                 {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                 jnp.asarray(scales), lora_idx=jnp.asarray(idx))
    got = tproj(torch.tensor(h), {"kernel": torch.tensor(w)},
                {"a": torch.tensor(a), "b": torch.tensor(b)},
                torch.tensor(scales), lora_idx=torch.tensor(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the base row is the base projection exactly
    np.testing.assert_array_equal(got[0].numpy(), (torch.tensor(h[0])
                                                   @ torch.tensor(w)).numpy())


def test_stacked_proj_rounds_the_scale_to_bf16_as_jax():
    """32 / 6 is 5.3333 in f32 and 5.34375 in bf16. With h·A·B = 7 and a
    zero base weight, the rounded scale gives 37.5 and the unrounded one
    37.25 after the bf16 rounding of the product: the port must give JAX's
    37.5 on both branches (stacked and single adapter)."""
    B, T, D, O, E, r = 2, 1, 8, 4, 2, 6
    h = np.zeros((B, T, D), np.float32)
    h[:, :, 0] = 1.0
    w = np.zeros((D, O), np.float32)
    a = np.zeros((E, D, r), np.float32)
    a[1, 0, 0] = 7.0
    b = np.zeros((E, r, O), np.float32)
    b[1, 0, :] = 1.0
    scales = np.array([0.0, 32 / 6], np.float32)
    idx = np.array([1, 0], np.int32)
    bf = jnp.bfloat16
    want = np.asarray(jproj(
        jnp.asarray(h, bf), {"kernel": jnp.asarray(w)},
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(scales),
        lora_idx=jnp.asarray(idx)).astype(jnp.float32))
    got = tproj(torch.tensor(h).bfloat16(), {"kernel": torch.tensor(w)},
                {"a": torch.tensor(a), "b": torch.tensor(b)},
                torch.tensor(scales), lora_idx=torch.tensor(idx)).float()
    assert want[0, 0, 0] == 37.5 and (want[1] == 0).all()
    np.testing.assert_array_equal(got.numpy(), want)
    one = tproj(torch.tensor(h[:1]).bfloat16(), {"kernel": torch.tensor(w)},
                {"a": torch.tensor(a[1]), "b": torch.tensor(b[1])},
                32 / 6).float()
    np.testing.assert_array_equal(one.numpy(), want[:1])


def test_stacked_forward_matches_jax_and_the_single_adapter_forward():
    """The whole forward at f32 with a mixed-adapter batch: logits against
    JAX's, and each row against the port's single-adapter forward with
    that row's adapter alone, unpadded."""
    jcfg = jget_config("debug")
    cfg = get_config("debug")
    params_j = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_jax(jax.device_get(params_j), cfg)
    rng = np.random.default_rng(1)
    L, E, ranks = cfg.num_layers, 3, (0, 2, 4)
    targets = ("q_proj", "v_proj", "down_proj")
    layers = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        a, b = _stack(rng, E, d_in, max(ranks), d_out)
        a[1, :, 2:] = 0.0  # adapter 1 is rank 2, zero-padded to 4
        b[1, 2:, :] = 0.0
        layers[t] = {"a": np.broadcast_to(a, (L,) + a.shape).copy(),
                     "b": np.broadcast_to(b, (L,) + b.shape).copy()}
    scales = np.array([0.0, 32 / 6, 8.0], np.float32)
    B, T = 3, 12
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    idx = np.array([2, 0, 1], np.int32)
    jl = ({"layers": jax.tree_util.tree_map(jnp.asarray, layers)},
          jnp.asarray(scales))
    want, _ = jforward(params_j, jnp.asarray(tokens), jcfg, lora=jl,
                       lora_adapter_idx=jnp.asarray(idx))
    tl = ({"layers": {t: {k: torch.tensor(v) for k, v in ab.items()}
                      for t, ab in layers.items()}}, torch.tensor(scales))
    got, _ = tforward(params, torch.tensor(tokens), cfg, lora=tl,
                      lora_adapter_idx=torch.tensor(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for row, e in enumerate(idx):
        if e == 0:
            alone, _ = tforward(params, torch.tensor(tokens[row:row + 1]),
                                cfg)
        else:
            r = ranks[e]
            one = {"layers": {t: {"a": torch.tensor(ab["a"][:, e, :, :r]),
                                  "b": torch.tensor(ab["b"][:, e, :r, :])}
                              for t, ab in layers.items()}}
            alone, _ = tforward(params, torch.tensor(tokens[row:row + 1]),
                                cfg, lora=(one, float(scales[e])))
        np.testing.assert_allclose(got[row:row + 1].numpy(), alone.numpy(),
                                   **TOL)


# ------------------------------------------ mixed-adapter engines vs JAX

@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload(MODEL)
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def jax_twin(port_ckpt: str, out: str) -> str:
    """The same adapter leaves as a JAX (Orbax) checkpoint at step 1."""
    state = load_raw_state(port_ckpt, 1)
    layers = {t: {k: v.numpy() for k, v in ab.items()}
              for t, ab in state["lora"]["layers"].items()}
    mngr = JCheckpointManager(out)
    mngr.maybe_save({"lora": {"layers": layers}}, step=1, force=True)
    mngr.close()
    return out


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Three adapters of ranks 2, 6 (scale 32 / 6) and 8, on q/v and on
    q/o/down (mixed target sets), in both packages' formats."""
    d = tmp_path_factory.mktemp("adapters")
    port = make_adapter_sweep(str(d / "torch"), MODEL, 2, ranks=(2, 6))
    port["ad2-r8"] = make_adapter_checkpoint(
        str(d / "torch" / "ad2-r8"), MODEL, seed=2, rank=8,
        targets=("q_proj", "o_proj", "down_proj"))
    jx = {n: jax_twin(p, str(d / "jax" / n)) for n, p in port.items()}
    return port, jx


def _prompts(tok):
    return {"": tok.encode("plain base request"),
            "ad0-r2": tok.encode("tenant zero asks " * 6),
            "ad1-r6": tok.encode("tenant one"),
            "ad2-r8": tok.encode("the third tenant wants " * 4)}


def _serve_mixed(engine, prompts):
    reqs = {n: engine.submit(p, max_new_tokens=NEW, adapter=n)
            for n, p in prompts.items()}
    out = {}
    for n, r in reqs.items():
        assert r.done.wait(300), n
        assert r.error is None, (n, r.error)
        out[n] = r.tokens
    return out


def _near_tie(jeng, name, prompt, prefix) -> bool:
    """JAX's bf16 logits for the step after ``prompt + prefix``, under
    ``name``'s row of the JAX engine's stack, put the top two within 2
    bf16 ulps."""
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, jeng.tokenizer.eos_token_id, 256, NEW)
    seq = ids + list(prefix)
    pos = positions + list(range(n, n + len(prefix)))
    msk = mask + [1] * len(prefix)
    idx = jnp.asarray([jeng._static_adapter_ids[name]], jnp.int32)
    logits, _ = jforward(jeng.params, jnp.asarray([seq]), jeng.cfg,
                         positions=jnp.asarray([pos]),
                         attention_mask=jnp.asarray([msk]),
                         lora=jeng.lora_stack, lora_adapter_idx=idx,
                         compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1][:2]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
    return (top[0] - top[1]) <= 2 * ulp


def _hold(want, got, jeng, prompts):
    for name, w in want.items():
        g = got[name]
        assert len(w) == NEW, name
        div = next((i for i in range(min(len(g), len(w))) if g[i] != w[i]),
                   None)
        if div is not None or len(g) != len(w):
            assert _near_tie(jeng, name, prompts[name],
                             w[:div if div is not None else len(g)]), \
                (name, div, g, w)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mixed_adapter_streams_match_jax_engine(export_dir, adapters,
                                                layout, kv_quant):
    port, jx = adapters
    kw = dict(ENGINE, kv_quant=kv_quant, **LAYOUTS[layout])
    jeng = JEngine(export_dir, adapters=jx, **kw)
    try:
        prompts = _prompts(jeng.tokenizer)
        want = _serve_mixed(jeng, prompts)
        teng = BatchedEngine(export_dir, adapters=port, device="cpu", **kw)
        try:
            assert teng.adapter_ids == jeng.adapter_ids
            stack, scales = teng.lora_stack
            assert sorted(stack["layers"]) == ["down_proj", "o_proj",
                                               "q_proj", "v_proj"]
            assert stack["layers"]["q_proj"]["a"].shape[-1] == 8
            np.testing.assert_array_equal(
                scales.numpy(), np.asarray(jeng.lora_stack[1]))
            got = _serve_mixed(teng, prompts)
        finally:
            teng.close()
        _hold(want, got, jeng, prompts)
    finally:
        jeng.close()


@pytest.mark.parametrize("layout", ["kernel", "dense"])
def test_pooled_streams_equal_the_static_stack(adapters, layout):
    """The pool pads every adapter to rank_max 8 and holds two of three at
    a time; the streams equal the static stack's token for token, and so
    does /perplexity's NLL under each adapter."""
    port, _ = adapters
    kw = dict(ENGINE, device="cpu", **LAYOUTS[layout])
    static = BatchedEngine(MODEL, adapters=port, **kw)
    pooled = BatchedEngine(MODEL, adapters=port, adapter_pool=2,
                           adapter_rank_max=8,
                           adapter_targets=("q_proj", "v_proj", "o_proj",
                                            "down_proj"), **kw)
    try:
        prompts = _prompts(static.tokenizer)
        want = _serve_mixed(static, prompts)
        assert _serve_mixed(pooled, prompts) == want
        occ = pooled.adapter_occupancy()
        assert occ["loads"] >= 3 and occ["evictions"] >= 1, occ
        assert occ["pinned"] == 0
        for name in port:
            p = prompts[name]
            assert (pooled.perplexity(p, [7, 8, 9], adapter=name)
                    == static.perplexity(p, [7, 8, 9], adapter=name))
    finally:
        static.close()
        pooled.close()


# --------------------------------------------------------------- store

def _cfg():
    return get_config("debug")


def _layers(cfg, rank, targets=("q_proj", "v_proj"), fill=0.5):
    out = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        out[t] = {"a": torch.full((cfg.num_layers, d_in, rank), fill),
                  "b": torch.full((cfg.num_layers, rank, d_out), fill)}
    return out


def test_store_insert_pads_rank_and_clear_zeroes():
    cfg = _cfg()
    store = AdapterStore(cfg, pool_slots=2, rank_max=8)
    before = store.tree
    rank = store.insert(1, _layers(cfg, rank=4), scaling=2.0, name="t")
    assert rank == 4
    tree, scales = store.tree
    a = tree["layers"]["q_proj"]["a"]
    assert a.shape[1] == 3 and a.dtype == torch.bfloat16
    assert (a[:, 1, :, :4] == 0.5).all()
    assert (a[:, 1, :, 4:] == 0.0).all()  # rank padding
    assert (a[:, 0] == 0.0).all() and (a[:, 2] == 0.0).all()
    assert float(scales[1]) == 2.0 and float(scales[0]) == 0.0
    # a write publishes NEW buffers: a reader's snapshot is untouched
    assert (before[0]["layers"]["q_proj"]["a"] == 0.0).all()
    assert float(before[1][1]) == 0.0
    store.clear(1)
    tree, scales = store.tree
    assert (tree["layers"]["q_proj"]["a"] == 0.0).all()
    assert float(scales[1]) == 0.0


def test_store_rejects_bad_geometry():
    cfg = _cfg()
    store = AdapterStore(cfg, pool_slots=1, rank_max=4)
    with pytest.raises(AdapterRankError, match="rank 8 exceeds"):
        store.insert(1, _layers(cfg, rank=8), scaling=1.0, name="big")
    with pytest.raises(AdapterTargetError, match="o_proj"):
        store.insert(1, _layers(cfg, rank=2, targets=("o_proj",)),
                     scaling=1.0, name="wide")
    with pytest.raises(ValueError, match="slot 0"):
        store.insert(0, _layers(cfg, rank=2), scaling=1.0)
    assert hbm_bytes(cfg, 8, 8) == AdapterStore(
        cfg, pool_slots=8, rank_max=8).nbytes()
    # r8 on q_proj,v_proj in bf16: 2 bytes an element, E = 2 rows
    L, D, KV = cfg.num_layers, cfg.hidden_size, cfg.kv_dim
    assert hbm_bytes(cfg, 1, 8) == 4 * 2 + 2 * 2 * L * 8 * (
        (D + cfg.q_dim) + (D + KV))


# ------------------------------------------------------------- registry

def _registry(pool_slots=2, rank_max=8, ranks=None):
    """Registry over a fake loader: checkpoint 'ck:<name>' loads
    constant-filled layers at the configured rank."""
    cfg = _cfg()
    store = AdapterStore(cfg, pool_slots=pool_slots, rank_max=rank_max)
    ranks = ranks or {}
    loads = []

    def loader(path):
        name = path.split(":", 1)[1]
        loads.append(name)
        return {"lora": {"layers": _layers(cfg, ranks.get(name, 2))},
                "_scaling": 4.0}

    return AdapterRegistry(store, loader=loader), loads


def test_registry_load_on_miss_hit_and_lru_eviction():
    reg, loads = _registry(pool_slots=2)
    for n in ("a", "b", "c"):
        reg.register(n, f"ck:{n}")
    assert reg.acquire("a", wait=True) == 1
    assert reg.acquire("b", wait=True) == 2
    reg.release("a")
    reg.release("b")
    assert reg.acquire("a", wait=True) == 1  # hit: no reload
    reg.release("a")
    assert loads == ["a", "b"]
    assert reg.stats == {"loads": 2, "evictions": 0, "hits": 1, "misses": 2}
    # pool full: the COLDEST unpinned resident (b) makes room for c
    assert reg.acquire("c", wait=True) == 2
    reg.release("c")
    assert reg.resident() == {"a": 1, "c": 2}
    assert reg.stats["evictions"] == 1 and loads == ["a", "b", "c"]
    assert reg.acquire("b", wait=True) is not None
    reg.release("b")


def test_registry_acquire_is_nonblocking_and_resolves():
    cfg = _cfg()
    store = AdapterStore(cfg, pool_slots=1, rank_max=8)
    release = threading.Event()

    def slow_loader(path):
        release.wait(10)
        return {"lora": {"layers": _layers(cfg, 2)}, "_scaling": 4.0}

    reg = AdapterRegistry(store, loader=slow_loader)
    reg.register("a", "ck:a")
    assert reg.acquire("a") is None  # load started, not waited for
    assert reg.acquire("a") is None  # still loading: no second load
    assert reg.stats["misses"] == 1
    with pytest.raises(AdapterPinnedError):  # mid-load: not removable
        reg.unregister("a")
    release.set()
    deadline = time.time() + 10
    idx = None
    while idx is None and time.time() < deadline:
        idx = reg.acquire("a")
        if idx is None:
            time.sleep(0.005)
    assert idx == 1 and reg.stats["loads"] == 1
    assert reg.stats["misses"] == 1 and reg.stats["hits"] == 0
    reg.release("a")


def test_registry_pinning_blocks_eviction_and_unload():
    reg, _ = _registry(pool_slots=1)
    reg.register("a", "ck:a")
    reg.register("b", "ck:b")
    assert reg.acquire("a", wait=True) == 1
    assert reg.acquire("b") is None  # a pinned: nothing evictable
    with pytest.raises(AdapterPinnedError):
        reg.unregister("a")
    reg.release("a")
    assert reg.acquire("b", wait=True) == 1
    reg.release("b")
    assert reg.unregister("b") and reg.names() == ["a"]


def test_registry_reregister_contract():
    reg, _ = _registry()
    reg.register("a", "ck:a")
    reg.register("a", "ck:a")  # idempotent
    reg.acquire("a", wait=True)
    with pytest.raises(AdapterPinnedError):  # live name, other weights
        reg.register("a", "ck:other")
    reg.release("a")
    with pytest.raises(AdapterPinnedError):  # still resident
        reg.register("a", "ck:other")
    reg.unregister("a")
    reg.register("a", "ck:other")


def test_registry_rank_over_max_rejected_and_not_inserted():
    reg, _ = _registry(rank_max=4, ranks={"big": 16})
    reg.register("big", "ck:big")
    with pytest.raises(AdapterRankError, match="rank 16 exceeds"):
        reg.acquire("big", wait=True)
    occ = reg.occupancy()
    assert occ["resident"] == 0 and occ["free"] == 2
    with pytest.raises(KeyError):
        reg.acquire("never-registered")


def test_registry_books_balance_under_concurrent_acquire_release():
    """Sixteen threads (more than the cores) acquire and release four
    adapters on a two-slot pool with a short switch interval: every pin is
    released, each adapter sits in at most one slot, free + resident slots
    make up the pool, and every load answers a miss."""
    import sys

    reg, _ = _registry(pool_slots=2)
    names = ["a", "b", "c", "d"]
    for n in names:
        reg.register(n, f"ck:{n}")
    errors = []

    def worker(i):
        try:
            for j in range(30):
                name = names[(i + j) % 4]
                if reg.acquire(name, wait=True) is not None:
                    reg.release(name)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    occ = reg.occupancy()
    assert occ["pinned"] == 0
    assert all(reg.describe(n)["pinned_by"] == 0 for n in names)
    slots = sorted(reg.resident().values())
    assert len(slots) == len(set(slots)) and occ["resident"] == len(slots)
    assert occ["free"] + occ["resident"] == 2
    assert reg.stats["loads"] == reg.stats["misses"]
    assert reg.stats["evictions"] == reg.stats["loads"] - occ["resident"]


def test_pool_republish_during_decode_keeps_live_streams():
    """While a pooled engine decodes an adapter row and a base row, other
    threads load and unload adapters through the pool's free slots (each a
    clone, a write and a republish); both live streams equal the ones
    decoded without that traffic. The card test of the same name runs it
    on the card."""
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cks = make_adapter_sweep(tmp, MODEL, 4)
        live, *others = sorted(cks)
        kw = dict(POOLED, adapters={live: cks[live]}, adapter_pool=3)
        quiet = BatchedEngine(MODEL, **kw)
        try:
            p = quiet.tokenizer.encode("republish probe")
            want = [quiet.generate(p, max_new_tokens=48, adapter=live),
                    quiet.generate(p, max_new_tokens=48)]
        finally:
            quiet.close()
        eng = BatchedEngine(MODEL, **kw)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            reqs = [eng.submit(p, max_new_tokens=48, adapter=live),
                    eng.submit(p, max_new_tokens=48)]
            swaps = 0
            while not reqs[0].done.is_set() or not swaps:
                for name in others:
                    eng.load_adapter(name, cks[name])
                    eng.unload_adapter(name)
                    swaps += 1
            for r in reqs:
                assert r.done.wait(300) and r.error is None, r.error
            assert [r.tokens for r in reqs] == want
        finally:
            sys.setswitchinterval(old)
            eng.close()


# ----------------------------------------------------- engine admission



def test_engine_fifo_waits_on_adapter_pool_exhaustion(tmp_path):
    """A one-slot pool under two-adapter traffic: the second request waits
    for the first to release its pin, then loads; nobody errors."""
    cks = make_adapter_sweep(str(tmp_path), MODEL, 2, ranks=(2,))
    eng = BatchedEngine(MODEL, adapters=cks, adapter_pool=1,
                        adapter_rank_max=8, **POOLED)
    try:
        names = sorted(cks)
        prompt = eng.tokenizer.encode("contention probe")
        reqs = [eng.submit(prompt, max_new_tokens=8, adapter=n)
                for n in names]
        for n, r in zip(names, reqs):
            assert r.done.wait(300), f"{n} stalled under pool exhaustion"
            assert r.error is None, (n, r.error)
        assert ("adapter_wait", names[1]) in list(eng.sched_trace)
        occ = eng.adapter_occupancy()
        assert occ["pinned"] == 0 and occ["evictions"] >= 1
    finally:
        eng.close()


def test_rebind_invalidates_prefix_cache(tmp_path):
    ck1 = make_adapter_checkpoint(str(tmp_path / "v1"), MODEL, seed=3, rank=4)
    ck2 = make_adapter_checkpoint(str(tmp_path / "v2"), MODEL, seed=8, rank=4)
    eng = BatchedEngine(MODEL, adapter_pool=2, adapter_rank_max=8,
                        prefix_cache=8, **POOLED)
    try:
        prompt = eng.tokenizer.encode("system preamble for the tenant")
        eng.load_adapter("t", ck1)
        eng.load_adapter("ref", ck2)  # ck2's truth, under another name
        want_v2 = eng.generate(prompt, max_new_tokens=8, adapter="ref")
        out_v1 = eng.generate(prompt, max_new_tokens=8, adapter="t")
        assert eng.generate(prompt, max_new_tokens=8,
                            adapter="t") == out_v1  # a prefix-cache hit
        assert eng.prefill_stats["reuse"] >= 1
        eng.unload_adapter("t")
        eng.load_adapter("t", ck2)  # same name, NEW weights
        got = eng.generate(prompt, max_new_tokens=8, adapter="t")
        assert got == want_v2, (got, want_v2)
        assert got != out_v1
    finally:
        eng.close()


def test_warm_failure_keeps_existing_registration(tmp_path):
    """Warming a busy pool fails with RuntimeError and leaves a registered
    adapter registered; a bad checkpoint registered by the same call is
    rolled back, and its error reaches the caller."""
    cks = make_adapter_sweep(str(tmp_path), MODEL, 2, ranks=(2,))
    a, b = sorted(cks)
    eng = BatchedEngine(MODEL, adapters=cks, adapter_pool=1,
                        adapter_rank_max=8, **POOLED)
    try:
        prompt = eng.tokenizer.encode("hold the pool slot")
        req = eng.submit(prompt, max_new_tokens=160, adapter=a)
        deadline = time.time() + 300
        while not req.tokens and time.time() < deadline:
            time.sleep(0.002)
        assert req.tokens, "the pin holder never started decoding"
        with pytest.raises(RuntimeError, match="exhausted"):
            eng.load_adapter(b, cks[b])
        assert b in eng.adapter_ids
        assert req.done.wait(300) and req.error is None
        assert eng.generate(prompt, max_new_tokens=4, adapter=b)
        with pytest.raises(FileNotFoundError):
            eng.load_adapter("ghost", str(tmp_path / "nowhere"))
        assert "ghost" not in eng.adapter_ids
    finally:
        eng.close()


def test_failed_load_reaches_the_request_as_an_error(tmp_path):
    """No fallback: a request whose adapter cannot load fails, and the base
    request beside it is served."""
    eng = BatchedEngine(MODEL, adapters={"bad": str(tmp_path / "none")},
                        adapter_pool=1, **POOLED)
    try:
        prompt = eng.tokenizer.encode("who am I")
        bad = eng.submit(prompt, max_new_tokens=4, adapter="bad")
        base = eng.submit(prompt, max_new_tokens=4)
        assert bad.done.wait(300) and base.done.wait(300)
        assert bad.error and "no checkpoint" in bad.error
        assert base.error is None and len(base.tokens) == 4
    finally:
        eng.close()


def test_decode_continues_during_adapter_load(tmp_path):
    ck = make_adapter_checkpoint(str(tmp_path / "cold"), MODEL, seed=4,
                                 rank=4)
    eng = BatchedEngine(MODEL, adapters={"cold": ck}, adapter_pool=1,
                        adapter_rank_max=8, **POOLED)
    gate = threading.Event()
    orig_loader = eng.adapter_registry._loader

    def gated_loader(path):
        assert gate.wait(60), "test gate never opened"
        return orig_loader(path)

    eng.adapter_registry._loader = gated_loader
    try:
        prompt = eng.tokenizer.encode("latency isolation probe")
        cold = eng.submit(prompt, max_new_tokens=6, adapter="cold")
        base = eng.submit(prompt, max_new_tokens=6)
        assert base.done.wait(300) and base.error is None
        assert not cold.done.is_set()
        gate.set()
        assert cold.done.wait(300) and cold.error is None, cold.error
        assert "cold" in eng.resident_adapters
    finally:
        gate.set()
        eng.close()


# ------------------------------------------------------ admin HTTP plane

@pytest.fixture()
def pooled_server():
    eng = BatchedEngine(MODEL, adapter_pool=2, adapter_rank_max=8, **POOLED)
    saved = (tserver.STATE.engine, tserver.STATE.model_path,
             tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.model_path = eng, MODEL
    tserver.STATE.error = None
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserver.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", eng
    finally:
        srv.shutdown()
        srv.server_close()
        (tserver.STATE.engine, tserver.STATE.model_path,
         tserver.STATE.error) = saved
        eng.close()


def _req(url, method="GET", body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


CHAT = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}


def test_admin_adapters_http_contract(pooled_server, tmp_path):
    url, eng = pooled_server
    code, doc = _req(url + "/admin/adapters")
    assert code == 200 and doc["dynamic"] and doc["registered"] == []

    ck = make_adapter_checkpoint(str(tmp_path / "t1"), MODEL, seed=5, rank=4)
    code, doc = _req(url + "/admin/adapters", "POST",
                     {"name": "t1", "checkpoint": ck})
    assert code == 200 and doc["resident"] and doc["rank"] == 4
    code, doc = _req(url + "/admin/adapters")
    assert doc["registered"] == ["t1"] and doc["resident"] == ["t1"]
    assert doc["pool"]["slots"] == 2 and doc["pool"]["free"] == 1

    code, doc = _req(url + "/chat/completions", "POST",
                     dict(CHAT, model="t1"))
    assert code == 200, doc
    assert eng.adapter_occupancy()["requests"]["t1"] == 1
    code, doc = _req(url + "/perplexity", "POST",
                     {"prompt": "hi", "completion": "there", "model": "t1"})
    assert code == 200 and doc["num_tokens"] > 0

    big = make_adapter_checkpoint(str(tmp_path / "big"), MODEL, seed=6,
                                  rank=16)
    code, doc = _req(url + "/admin/adapters", "POST",
                     {"name": "big", "checkpoint": big})
    assert code == 400 and "rank 16 exceeds" in doc["error"]
    code, _ = _req(url + "/admin/adapters", "POST", {"name": "x"})
    assert code == 400
    code, _ = _req(url + "/admin/adapters", "POST",
                   {"name": "t1", "checkpoint": big})  # a live name
    assert code == 409

    code, doc = _req(url + "/admin/adapters/t1", "DELETE")
    assert code == 200 and doc == {"unloaded": "t1"}
    code, _ = _req(url + "/admin/adapters/t1", "DELETE")
    assert code == 404
    code, doc = _req(url + "/chat/completions", "POST",
                     dict(CHAT, model="t1"))
    assert code == 400 and "unknown model/adapter" in doc["error"]
    code, doc = _req(url + "/admin/adapters")
    assert doc["registered"] == [] and doc["pool"]["free"] == 2


def test_admin_adapters_static_engine_501():
    class _Static:
        adapter_ids = {"": 0, "s": 1}

    saved = tserver.STATE.engine
    tserver.STATE.engine = _Static()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserver.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        code, doc = _req(url + "/admin/adapters")
        assert code == 200 and doc == {"dynamic": False,
                                       "registered": ["s"],
                                       "resident": ["s"]}
        code, _ = _req(url + "/admin/adapters", "POST",
                       {"name": "n", "checkpoint": "p"})
        assert code == 501
        code, _ = _req(url + "/admin/adapters/s", "DELETE")
        assert code == 501
    finally:
        srv.shutdown()
        srv.server_close()
        tserver.STATE.engine = saved


@pytest.mark.parametrize("extra", [
    ["--adapters", "a=/x"], ["--adapter_pool", "2"],
    ["--tenants_config", '{"t": {"tier": "bulk"}}'],
    ["--host_adapter_cache_mb", "8"]])
def test_batched_only_adapter_flags_need_the_batched_engine(extra):
    """As in the reference server: these flags on the single-request engine
    fail the load rather than serve the base model under a tenant's
    adapter name."""
    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    try:
        args = tserver.parse_args(
            ["--model_path", MODEL, "--template", "vanilla",
             "--max_seq_len", "256", "--device", "cpu", "--slots", "1",
             *extra])
        tserver.load_engine_async(
            args.model_path, template=args.template,
            max_seq_len=args.max_seq_len, slots=args.slots,
            device=args.device, adapters=args.adapters,
            adapter_pool=args.adapter_pool,
            tenants_config=args.tenants_config,
            host_adapter_cache_mb=args.host_adapter_cache_mb).join(60)
        assert tserver.STATE.engine is None
        assert "requires the batched engine" in tserver.STATE.error
    finally:
        tserver.STATE.engine, tserver.STATE.error = saved


def test_adapters_flag_parses_names():
    args = tserver.parse_args(["--model_path", MODEL,
                               "--adapters", "a=/x, b=/y",
                               "--adapter_targets", "q_proj, o_proj"])
    assert args.adapters == {"a": "/x", "b": "/y"}
    assert args.adapter_targets == ["q_proj", "o_proj"]
    with pytest.raises(SystemExit):
        tserver.parse_args(["--model_path", MODEL, "--adapters", "nameless"])


# --------------------------------------- --checkpoint_path, end to end

@pytest.fixture(scope="module")
def trained_run(export_dir, tmp_path_factory):
    """Three LoRA steps with the port's trainer CLI on the shared export,
    alpha 12 on rank 6 (scale 2, not the fallback 32 / 6); returns the
    checkpoints root and the JAX twin of its newest step under a run with
    the same manifest scaling."""
    from datatunerx_tpu.training.checkpoint import (
        write_manifest as jwrite_manifest,
    )
    from datatunerx_tpu_torch.tuning.train import main as train_main

    d = tmp_path_factory.mktemp("trained")
    csv = d / "train.csv"
    rows = ["instruction,response"] + [
        f"say {w},{w} {w} {w}" for w in ("red", "green", "blue", "gold")] * 4
    csv.write_text("\n".join(rows) + "\n")
    rc = train_main([
        "--model_name_or_path", export_dir, "--train_path", str(csv),
        "--storage_path", str(d / "store"), "--output_dir", str(d / "run"),
        "--template", "vanilla", "--block_size", "64",
        "--finetuning_type", "lora", "--lora_rank", "6",
        "--lora_alpha", "12", "--lora_target", "q_proj,v_proj",
        "--per_device_train_batch_size", "2", "--max_steps", "3",
        "--learning_rate", "5e-2", "--bf16", "false", "--device", "cpu"])
    assert rc == 0
    root = str(d / "store" / "run" / "checkpoints")
    manifest = json.loads((d / "store" / "run" / "manifest.json")
                          .read_text())
    assert manifest["lora_scaling"] == 2.0
    step = int(os.path.basename(manifest["checkpoint"]))
    jroot = str(d / "jstore" / "run" / "checkpoints")
    state = load_raw_state(root, step)
    layers = {t: {k: v.float().numpy() for k, v in ab.items()}
              for t, ab in state["lora"]["layers"].items()}
    mngr = JCheckpointManager(jroot)
    mngr.maybe_save({"lora": {"layers": layers}}, step=step, force=True)
    mngr.close()
    jwrite_manifest(str(d / "jstore"), "run", os.path.join(jroot, str(step)),
                    extra={"lora_scaling": 2.0})
    return root, jroot, step


def test_checkpoint_path_serves_the_trained_adapter_in_both_packages(
        export_dir, trained_run):
    """The batched engines of both packages serve the trained adapter as
    ``"default"`` at the manifest's scaling (streams under the near-tie
    rule, NLL within 1e-3), a request WITHOUT ``model`` gets the base model
    in both (the reference's behaviour, kept), and the single-request
    engines merge the adapter, so there a request without ``model`` is
    answered by the tuned model."""
    from datatunerx_tpu.serving.engine import InferenceEngine as JSingle
    from datatunerx_tpu_torch.serving.engine import InferenceEngine

    root, jroot, step = trained_run
    kw = dict(ENGINE, **LAYOUTS["kernel"])
    jeng = JEngine(export_dir, jroot, **kw)
    teng = BatchedEngine(export_dir, os.path.join(root, str(step)),
                         device="cpu", **kw)
    base = BatchedEngine(export_dir, device="cpu", **kw)
    try:
        assert jeng.adapter_ids == teng.adapter_ids == {"": 0, "default": 1}
        assert float(teng.lora_stack[1][1]) == 2.0
        tok = teng.tokenizer
        prompts = {"default": tok.encode("say red"),
                   "": tok.encode("say blue")}
        want = _serve_mixed(jeng, prompts)
        got = _serve_mixed(teng, prompts)
        _hold(want, got, jeng, prompts)
        # no "model": the base, in both packages
        p = prompts[""]
        assert got[""] == base.generate(p, max_new_tokens=NEW)
        assert got["default"] != base.generate(prompts["default"],
                                               max_new_tokens=NEW)
        c = tok.encode(" red red", add_special_tokens=False)
        tn = teng.perplexity(prompts["default"], c, adapter="default")
        jn = jeng.perplexity(prompts["default"], c, adapter="default")
        assert abs(tn["nll_sum"] - jn["nll_sum"]) <= 1e-3 * abs(jn["nll_sum"])
        assert (teng.perplexity(p, c) == base.perplexity(p, c))
        # the single-request engines merge: no "model" = the tuned model
        single = InferenceEngine(export_dir, root, template="vanilla",
                                 max_seq_len=256, device="cpu")
        jsingle = JSingle(export_dir, jroot, template="vanilla",
                          max_seq_len=256)
        sn = single.perplexity(prompts["default"], c)
        jsn = jsingle.perplexity(prompts["default"], c)
        assert abs(sn["nll_sum"] - jsn["nll_sum"]) <= 1e-3 * abs(jsn["nll_sum"])
        assert abs(sn["nll_sum"] - tn["nll_sum"]) <= 1e-2 * abs(tn["nll_sum"])
        assert single.adapter_for("default") == ""
    finally:
        jeng.close()
        teng.close()
        base.close()


def test_server_checkpoint_path_default_adapter_over_http(trained_run,
                                                          export_dir):
    """``--checkpoint_path`` through the port's server: ``"model":
    "default"`` routes to the adapter, no ``model`` to the base, an unknown
    name is a 400; ``--checkpoint_path`` of a directory holding no
    checkpoint fails the load."""
    root, _, _ = trained_run
    saved = (tserver.STATE.engine, tserver.STATE.error,
             tserver.STATE.model_path)
    tserver.STATE.engine, tserver.STATE.error = None, None
    srv = tserver.start(tserver.parse_args(
        ["--model_path", export_dir, "--checkpoint_path", root,
         "--template", "vanilla", "--max_seq_len", "256", "--device", "cpu",
         "--kv_block_size", "16", "--host", "127.0.0.1", "--port", "0"]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        deadline = time.time() + 120
        while tserver.STATE.engine is None and time.time() < deadline:
            assert not tserver.STATE.error, tserver.STATE.error
            time.sleep(0.05)
        eng = tserver.STATE.engine
        assert eng.adapter_ids == {"": 0, "default": 1}
        body = {"prompt": "say gold", "completion": "gold gold"}
        code, tuned = _req(url + "/perplexity", "POST",
                           dict(body, model="default"))
        assert code == 200
        code, plain = _req(url + "/perplexity", "POST", body)
        assert code == 200 and plain["nll_sum"] != tuned["nll_sum"]
        code, doc = _req(url + "/chat/completions", "POST",
                         dict(CHAT, model="default"))
        assert code == 200, doc
        code, doc = _req(url + "/chat/completions", "POST",
                         dict(CHAT, model="nope"))
        assert code == 400
        code, doc = _req(url + "/admin/adapters")
        assert doc == {"dynamic": False, "registered": ["default"],
                       "resident": ["default"]}
    finally:
        srv.shutdown()
        srv.server_close()
        if tserver.STATE.engine is not None:
            tserver.STATE.engine.close()
        (tserver.STATE.engine, tserver.STATE.error,
         tserver.STATE.model_path) = saved
