"""The port's speculative decoding (``serving/speculative.py`` and the
``BatchedEngine`` spec tick) against the JAX package's, on the CPU.

Units take the same numpy inputs in both packages: the masks, the tree
parser and ragged widths (equal arrays), ``sampling_probs`` (1e-6),
``accept_tokens`` / ``accept_tree_tokens`` on the same probabilities and
keys (equal acceptance counts, branches, extra tokens and new keys: exact),
``attention_allow``'s window and ``compact_window`` on both cache layouts
(exact), the controllers' state sequences under the same observations
(exact), and the distribution-exactness of the residual and sibling rules
(empirical, as the reference's tests). Engines run ``preset:debug``:
greedy spec streams are token-exact against the same engine without a
draft over dense, paged, int8 and pooled-adapter caches, chain and tree,
and the port's spec engine equals the JAX spec engine on the same weights
and seeds, sampled and greedy, chain and tree, with the epilogue off and
on (token for token, and equal acceptance counts)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops import attention as jatt
from datatunerx_tpu.serving import speculative as jspec
from datatunerx_tpu_torch.ops import attention as tatt
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.ops.paged_attention import blocks_for_depth
from datatunerx_tpu_torch.serving import speculative as tspec
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

MODEL = "preset:debug"
BASE = dict(template="vanilla", max_seq_len=256, slots=3, decode_chunk=4,
            device="cpu")
NEW = 20


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _probs(rng, shape):
    x = rng.random(shape).astype(np.float32) ** 3
    return x / x.sum(-1, keepdims=True)


# ------------------------------------------------------------ topology units
def test_parse_spec_tree_and_validation():
    for spec in ("2x3", " 4X2 ", "1x1", "64x16"):
        assert tspec.parse_spec_tree(spec) == tuple(
            jspec.parse_spec_tree(spec).__dict__.values()) or \
            str(tspec.parse_spec_tree(spec)) == str(
                jspec.parse_spec_tree(spec))
        assert tspec.parse_spec_tree(spec).step_tokens == \
            jspec.parse_spec_tree(spec).step_tokens
    for bad in ("2", "ax3", "0x2", "65x1", "2x17", "2x3x4"):
        with pytest.raises(ValueError):
            tspec.parse_spec_tree(bad)
        with pytest.raises(ValueError):
            jspec.parse_spec_tree(bad)


@pytest.mark.parametrize("shape", [(2, 3), (3, 1), (1, 4), ((3, 2, 2),),
                                   ((4, 4, 1),)])
def test_tree_masks_match_reference(shape):
    np.testing.assert_array_equal(tspec.tree_verify_mask(*shape),
                                  jspec.tree_verify_mask(*shape))
    ws = tspec._widths_tuple(*shape)
    assert ws == jspec._widths_tuple(*shape)
    assert tspec._width_offsets(ws) == jspec._width_offsets(ws)
    for j in range(1, len(ws) + 1):
        arg = shape[0] if len(shape) == 2 else ws
        np.testing.assert_array_equal(tspec.tree_draft_mask(arg, j),
                                      jspec.tree_draft_mask(arg, j))


def test_ragged_widths_validation():
    for bad in ((), (0, 1), (1, 2), (2, 3, 1)):
        with pytest.raises(ValueError):
            tspec._widths_tuple(bad)
        with pytest.raises(ValueError):
            jspec._widths_tuple(bad)


# ------------------------------------------------------------ sampling units
@pytest.mark.parametrize("exact", [True, False])
def test_sampling_probs_matches_reference(exact):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 3, 300)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    top_ps = np.array([1.0, 0.8, 1.0, 0.5], np.float32) if exact else \
        np.ones(4, np.float32)
    want = jax.vmap(lambda row, t, p: jax.vmap(
        lambda lg: jspec.sampling_probs(lg, t, p, exact_topp=exact))(row))(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps))
    got = tspec.sampling_probs(_t(logits), _t(temps), _t(top_ps), exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_accept_tokens_matches_reference():
    """Rows sampled, greedy, drafting and not, on the same probabilities
    and keys: equal n_accept, extra token and new key."""
    rng = np.random.default_rng(1)
    S, k, V = 6, 4, 50
    p = _probs(rng, (S, k + 1, V))
    q = _probs(rng, (S, k, V))
    d = rng.integers(0, V, (S, k)).astype(np.int32)
    # make some proposals likely: the target's own argmax
    d[1] = p[1, :k].argmax(-1)
    d[2, :2] = p[2, :2].argmax(-1)
    temps = np.array([1.0, 0.0, 0.0, 0.8, 1.0, 1.0], np.float32)
    on = np.array([True, True, True, True, False, True])
    keys = np.stack([prng.PRNGKey(10 + i) for i in range(S)])
    ja, je, jk = jax.vmap(jspec.accept_tokens)(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(d), jnp.asarray(temps),
        jnp.asarray(keys), jnp.asarray(on))
    ta, te, tk = tspec.accept_tokens(_t(p), _t(q), _t(d), _t(temps), keys,
                                     _t(on))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tk, np.asarray(jk))


def _accept_one(p, q, d, temp, seed, on=True):
    a, e, _ = tspec.accept_tokens(_t(p[None]), _t(q[None]),
                                  _t(np.asarray(d, np.int32)[None]),
                                  _t(np.array([temp], np.float32)),
                                  prng.PRNGKey(seed)[None], _t([on]))
    return int(a[0]), int(e[0])


def test_accept_greedy_is_argmax_comparison():
    V, k = 6, 3
    p = np.zeros((k + 1, V), np.float32)
    p[0, 2] = p[1, 4] = p[2, 1] = p[3, 5] = 1.0
    q = np.zeros((k, V), np.float32)
    q[:, 0] = 1.0
    assert _accept_one(p, q, [2, 4, 0], 0.0, 0) == (2, 1)
    assert _accept_one(p, q, [2, 4, 1], 0.0, 0) == (3, 5)
    assert _accept_one(p, q, [0, 0, 0], 0.0, 0) == (0, 2)
    assert _accept_one(p, q, [2, 4, 1], 0.0, 0, on=False) == (0, 2)


def test_accept_all_accept_and_all_reject_edges():
    k = 2
    p = np.asarray([[0.4, 0.3, 0.2, 0.1]] * (k + 1), np.float32)
    for seed in range(8):
        assert _accept_one(p, p[:k], [0, 1], 1.0, seed)[0] == k
    p0 = np.asarray([[0.0, 0.5, 0.5, 0.0]] * (k + 1), np.float32)
    q0 = np.zeros((k, 4), np.float32)
    q0[:, 0] = 1.0
    for seed in range(16):
        a, extra = _accept_one(p0, q0, [0, 0], 1.0, seed)
        assert a == 0 and extra in (1, 2)


def test_residual_scheme_is_distribution_exact():
    """The emitted first token's frequency over many keys matches the
    target's p although the draft's q is badly mismatched."""
    V, n = 4, 3000
    p = np.asarray([0.5, 0.25, 0.15, 0.1], np.float32)
    q = np.asarray([0.05, 0.05, 0.45, 0.45], np.float32)
    dkeys = prng.split(prng.PRNGKey(7), n)
    d0 = prng.categorical(dkeys, np.log(np.broadcast_to(q, (n, V))))
    keys = prng.split(prng.PRNGKey(42), n)
    a, e, _ = tspec.accept_tokens(
        _t(np.broadcast_to(p, (n, 2, V)).copy()),
        _t(np.broadcast_to(q, (n, 1, V)).copy()),
        _t(d0[:, None].astype(np.int32)), torch.ones(n), keys,
        torch.ones(n, dtype=torch.bool))
    toks = np.where(a.numpy() > 0, d0, e.numpy())
    np.testing.assert_allclose(np.bincount(toks, minlength=V) / n, p,
                               atol=0.04)


@pytest.mark.parametrize("widths", [(2, 2, 2), (3, 2, 1), (1, 1, 1), (3,)])
def test_accept_tree_tokens_matches_reference(widths):
    rng = np.random.default_rng(sum(widths))
    ws = tuple(widths)
    W, D, T, V, S = ws[0], len(ws), 1 + sum(ws), 40, 5
    p = _probs(rng, (S, T, V))
    q = _probs(rng, (S, D, W, V))
    d = rng.integers(0, V, (S, D, W)).astype(np.int32)
    offs = tspec._width_offsets(ws)
    for j in range(D):  # dead ragged lanes: token -1, zero draft mass
        d[:, j, ws[j]:] = -1
        q[:, j, ws[j]:] = 0.0
    # a branch that follows the target's argmax, for acceptances
    for s in range(S):
        d[s, 0, 0] = p[s, 0].argmax()
        for j in range(1, D):
            d[s, j, 0] = p[s, offs[j - 1]].argmax()
    temps = np.array([1.0, 0.0, 0.7, 0.0, 1.0], np.float32)
    on = np.array([True, True, True, False, False])
    keys = np.stack([prng.PRNGKey(3 + i) for i in range(S)])
    want = jax.vmap(lambda pp, qq, dd, t, r, o: jspec.accept_tree_tokens(
        pp, qq, dd, t, r, o, widths=ws))(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(d), jnp.asarray(temps),
        jnp.asarray(keys), jnp.asarray(on))
    got = tspec.accept_tree_tokens(_t(p), _t(q), _t(d), _t(temps), keys,
                                   _t(on), widths=ws)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def test_tree_sibling_rejection_is_distribution_exact():
    """W iid root siblings, recursive rejection: the emitted first token's
    frequency matches p."""
    V, W, n = 4, 3, 3000
    p = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    q = np.asarray([0.7, 0.1, 0.1, 0.1], np.float32)
    dkeys = prng.split(prng.PRNGKey(5), n * W).reshape(n, W, 2)
    d0 = prng.categorical(dkeys, np.log(np.broadcast_to(q, (n, W, V))))
    P = np.broadcast_to(p, (n, 1 + W, V)).copy()
    Q = np.broadcast_to(q, (n, 1, W, V)).copy()
    a, b, e, _ = tspec.accept_tree_tokens(
        _t(P), _t(Q), _t(d0[:, None].astype(np.int32)), torch.ones(n),
        prng.split(prng.PRNGKey(9), n), torch.ones(n, dtype=torch.bool),
        widths=(W,))
    first = np.where(a.numpy() > 0, d0[np.arange(n), b.numpy()], e.numpy())
    np.testing.assert_allclose(np.bincount(first, minlength=V) / n, p,
                               atol=0.04)


# -------------------------------------------------- window and compaction
def test_attention_allow_window_matches_reference():
    rng = np.random.default_rng(4)
    B, T, S, WN = 3, 7, 40, 7
    qpos = rng.integers(5, 30, (B, T)).astype(np.int32)
    kvpos = rng.integers(0, 35, (B, S)).astype(np.int32)
    wm = rng.random((B, T, WN)) > 0.4
    ws = np.array([0, 10, 33], np.int32)
    want = jatt.attention_allow(jnp.asarray(qpos), jnp.asarray(kvpos),
                                window_mask=jnp.asarray(wm),
                                window_start=jnp.asarray(ws))
    got = tatt.attention_allow(_t(qpos), _t(kvpos), window_mask=_t(wm),
                               window_start=_t(ws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_compact_window_matches_reference(paged, quant):
    from datatunerx_tpu.models.config import get_config

    rng = np.random.default_rng(int(paged) + 2 * int(quant))
    cfg = get_config("debug")
    B, W, D, T = 3, 64, 3, 7
    L, KV, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache = {"len": np.array([5, 20, 40], np.int32)}
    if paged:
        bs, nb = 16, 12
        tables = np.full((B, W // bs), -1, np.int32)
        perm = rng.permutation(nb)
        for b in range(B):
            tables[b, :4] = perm[4 * b:4 * b + 4] if 4 * b + 4 <= nb else -1
        tables[2, 3] = -1
        cache["block_tables"] = tables
        lead, pos_shape = (L, nb + 1, bs, KV), (nb + 1, bs)
    else:
        lead, pos_shape = (L, B, W, KV), (B, W)
    if quant:
        cache["k"] = rng.integers(-127, 127, lead + (d,)).astype(np.int8)
        cache["v"] = rng.integers(-127, 127, lead + (d,)).astype(np.int8)
        cache["k_scale"] = rng.random(lead).astype(np.float32)
        cache["v_scale"] = rng.random(lead).astype(np.float32)
    else:
        cache["k"] = rng.standard_normal(lead + (d,)).astype(np.float32)
        cache["v"] = rng.standard_normal(lead + (d,)).astype(np.float32)
    cache["pos"] = rng.integers(0, 100, pos_shape).astype(np.int32)
    part = np.array([True, True, False])
    src = np.array([[1, 4, 5], [2, 4, 6], [3, 5, 6]], np.int32)
    keep = np.array([3, 1, 2], np.int32)
    pos0 = np.array([7, 30, 9], np.int32)
    if paged:
        # the JAX pools have no scratch block: drop it there
        jc = {k: (v[:, :-1] if k in ("k", "v", "k_scale", "v_scale")
                  else v[:-1] if k == "pos" else v) for k, v in cache.items()}
    else:
        jc = dict(cache)
    want = jatt.compact_window({k: jnp.asarray(v) for k, v in jc.items()},
                               jnp.asarray(part), jnp.asarray(cache["len"]),
                               jnp.asarray(src), jnp.asarray(keep),
                               jnp.asarray(pos0), T)
    tc = {k: _t(v.copy()) for k, v in cache.items()}
    tatt.compact_window(tc, _t(part), _t(cache["len"]), _t(src), _t(keep),
                        _t(pos0), T)
    for key in ("k", "v", "k_scale", "v_scale", "pos"):
        if key not in cache:
            continue
        got = tc[key].numpy()
        if paged:
            got = got[:, :-1] if key != "pos" else got[:-1]
        np.testing.assert_array_equal(got, np.asarray(want[key]))


# ----------------------------------------------------------- controllers
def test_adaptive_k_state_sequence_matches_reference():
    seq = [[(0, 0, 4)]] * 6 + [[(1, 4, 4), (2, 1, 4)]] * 5 + [[(0, 2, 4)]]
    for mode in ("auto", "on"):
        t = tspec.AdaptiveK(k_max=4, mode=mode, floor=0.35, min_obs=2,
                            probe_every=3)
        j = jspec.AdaptiveK(k_max=4, mode=mode, floor=0.35, min_obs=2,
                            probe_every=3)
        for i, rows in enumerate(seq):
            for c in (t, j):
                c.observe(rows)
                if i % 3 == 0:
                    c.note_plain_step()
            assert t.snapshot() == j.snapshot()
            assert t.use_spec() == j.use_spec()
            assert t.current_plan() == j.current_plan()
            assert [t.slot_enabled(s) for s in range(3)] == \
                [j.slot_enabled(s) for s in range(3)]
        t.reset_slot(0)
        j.reset_slot(0)
        assert t.export_slot_state(1) == j.export_slot_state(1)


def test_adaptive_tree_state_sequence_matches_reference():
    tree_t, tree_j = tspec.TreeSpec(4, 3), jspec.TreeSpec(4, 3)
    t = tspec.AdaptiveTree(4, mode="auto", tree=tree_t)
    j = jspec.AdaptiveTree(4, mode="auto", tree=tree_j)
    evid = [([0.9, 0.5, 0.2], 0.1), ([0.4, 0.3, 0.1], 0.95),
            ([0.2, 0.1, 0.0], 0.99), ([0.95, 0.9, 0.8], 0.2)] * 3
    for fracs, dec in evid:
        for c in (t, j):
            c.observe_tree(fracs, dec)
            c.observe([(0, int(4 * fracs[0]), 4)])
        assert t.snapshot() == j.snapshot()
        assert t.current_plan() == j.current_plan()
    state = j.export_slot_state(0)
    assert t.export_slot_state(0) == state
    t2 = tspec.AdaptiveTree(4, mode="auto", tree=tree_t)
    j2 = jspec.AdaptiveTree(4, mode="auto", tree=tree_j)
    t2.import_slot_state(0, state)
    j2.import_slot_state(0, state)
    assert t2.snapshot() == j2.snapshot()


def test_blocks_for_depth_reserve_math():
    assert blocks_for_depth(32, 16) == 2
    assert blocks_for_depth(32, 16, overshoot=5) == 3
    assert blocks_for_depth(250, 16, overshoot=16, cap_depth=256) == 16


def test_build_draft_take_and_validation():
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer,
    )

    cfg, params, _ = load_model_and_tokenizer(MODEL, device="cpu")
    dcfg, dparams = tspec.build_draft("take:1", cfg, params)
    assert dcfg.num_layers == 1 and dcfg.paged_kernel is False
    assert dparams["embed_tokens"]["embedding"] is \
        params["embed_tokens"]["embedding"]
    # the draft's layers are views of the target's: no copy
    q = dparams["layers"]["q_proj"]["kernel"]
    assert q.shape[0] == 1
    assert q.data_ptr() == params["layers"]["q_proj"]["kernel"].data_ptr()
    with pytest.raises(ValueError, match="out of range"):
        tspec.build_draft("take:9", cfg, params)
    with pytest.raises(ValueError, match="vocab"):
        tspec.build_draft("preset:tinyllama-1.1b", cfg, params)


# ----------------------------------------------------------------- engines
def _greedy(eng, prompts, new=NEW, **kw):
    reqs = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
    for r in reqs:
        assert r.done.wait(300) and r.error is None, r.error
    return [r.tokens for r in reqs]


def _prompts(eng, n=3):
    tok = eng.tokenizer
    return [tok.encode(f"hello spec {i} " * (2 * i + 1)) for i in range(n)]


@pytest.fixture(scope="module")
def plain_streams():
    """Greedy streams of the engine without a draft, per cache layout."""
    out = {}
    for name, extra in LAYOUTS.items():
        eng = BatchedEngine(MODEL, **BASE, **extra)
        try:
            out[name] = _greedy(eng, _prompts(eng))
        finally:
            eng.close()
    return out


LAYOUTS = {
    "dense": {},
    "paged": dict(kv_block_size=16, paged_kernel="on"),
    "int8": dict(kv_block_size=16, paged_kernel="on", kv_quant="int8"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("draft,tree", [("take:2", None), ("take:1", None),
                                        ("take:1", "2x3")])
def test_spec_greedy_is_token_exact(plain_streams, layout, draft, tree):
    """Concurrent ragged requests: spec greedy streams equal the engine's
    without a draft. take:2 is the whole 2-layer model (every proposal
    accepted), take:1 a weak draft (rejections, ragged advance)."""
    eng = BatchedEngine(MODEL, **BASE, **LAYOUTS[layout], spec_draft=draft,
                        spec_k=3, spec_mode="on", spec_tree=tree)
    try:
        assert _greedy(eng, _prompts(eng)) == plain_streams[layout]
        info = eng.spec_info()
        assert info["spec_steps"] > 0 and info["proposed"] > 0
        if draft == "take:2" and layout != "int8":
            assert info["accepted"] == info["proposed"]
        elif draft == "take:2":
            # the target reads its int8 cache, the draft its bf16 one
            assert info["accepted"] >= 0.9 * info["proposed"]
        else:
            assert info["accepted"] < info["proposed"]
        if tree:
            assert info["tree"]["spec"] == tree
            assert eng._spec_overshoot == 1 + 2 * 3
        else:
            assert eng._spec_overshoot == 3 + 1
    finally:
        eng.close()


def test_spec_stop_and_budget_truncate_as_plain_decode():
    off = BatchedEngine(MODEL, **BASE, kv_block_size=16)
    on = BatchedEngine(MODEL, **BASE, kv_block_size=16, spec_draft="take:2",
                       spec_k=3, spec_mode="on")
    try:
        p = _prompts(off, 1)[0]
        full = _greedy(off, [p], new=12)[0]
        stop = full[5]
        for eng in (off, on):
            got = _greedy(eng, [p], new=12, stop_ids={stop})[0]
            assert got == full[:full.index(stop)]
        for n in (1, 2, 5):
            assert _greedy(on, [p], new=n)[0] == full[:n]
        # sampled requests keep their budget and are seed-deterministic
        a = _greedy(on, [p, p], new=9, temperature=0.8, top_p=0.9, seed=3)
        b = _greedy(on, [p], new=9, temperature=0.8, top_p=0.9, seed=3)
        assert all(len(x) <= 9 for x in a) and a[0] == a[1] == b[0]
    finally:
        off.close()
        on.close()


def test_spec_mode_off_is_the_plain_engine(plain_streams):
    eng = BatchedEngine(MODEL, **BASE, kv_block_size=16, paged_kernel="on",
                        spec_draft="take:1", spec_mode="off")
    try:
        assert eng.spec is None and eng.spec_info() is None
        assert eng._spec_overshoot == 0 and eng._tick_advance == eng.chunk
        assert _greedy(eng, _prompts(eng)) == plain_streams["paged"]
    finally:
        eng.close()


def test_spec_auto_falls_back_and_stays_exact(plain_streams):
    eng = BatchedEngine(MODEL, **BASE, kv_block_size=16, paged_kernel="on",
                        spec_draft="take:1", spec_k=3, spec_mode="auto")
    try:
        eng.spec_ctrl.min_obs = 1
        eng.spec_ctrl.floor = 0.9  # the weak draft sits under it
        assert _greedy(eng, _prompts(eng)) == plain_streams["paged"]
        info = eng.spec_info()
        assert info["plain_steps"] > 0 and info["spec_steps"] > 0
        assert info["disabled_events"] >= 1
    finally:
        eng.close()


def test_spec_tree_does_not_leak_rejected_siblings(plain_streams):
    """After tree steps, a slot's next tenant and later tokens read no
    rejected sibling: a second round through the same slots is exact, and
    every live window lane past each cursor reads the sentinel."""
    eng = BatchedEngine(MODEL, **BASE, **LAYOUTS["paged"],
                        spec_draft="take:1", spec_k=3, spec_mode="on",
                        spec_tree="3x2")
    try:
        for _ in range(2):
            assert _greedy(eng, _prompts(eng)) == plain_streams["paged"]
        assert eng.spec_info()["tree_steps"] > 0
    finally:
        eng.close()


def test_spec_with_pooled_mixed_rank_adapters(tmp_path):
    """Pooled adapters of ranks 4 and 8 in one verify batch (the draft runs
    the base, as the reference's): spec greedy equals plain greedy."""
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep

    paths = make_adapter_sweep(str(tmp_path), MODEL, 2)
    kw = dict(BASE, kv_block_size=16, paged_kernel="on", adapter_pool=2,
              adapter_rank_max=8)
    out = []
    for spec in (dict(), dict(spec_draft="take:1", spec_k=3,
                              spec_mode="on")):
        eng = BatchedEngine(MODEL, **kw, **spec)
        try:
            for name, path in paths.items():
                eng.load_adapter(name, path)
            names = ["", *paths]
            p = _prompts(eng)
            reqs = [eng.submit(p[i], max_new_tokens=NEW, adapter=names[i])
                    for i in range(3)]
            for r in reqs:
                assert r.done.wait(300) and r.error is None, r.error
            out.append([r.tokens for r in reqs])
            if spec:
                assert eng.spec_info()["spec_steps"] > 0
        finally:
            eng.close()
    assert out[0] == out[1]
    assert out[0][1] != out[0][0] or out[0][2] != out[0][0]


def test_spec_slot_preempted_under_overcommit_resumes_exactly():
    """A pool too small for every session: spec-form slots settle, park
    and resume; greedy streams equal an unpreempted plain engine's."""
    plain = BatchedEngine(MODEL, **BASE, kv_block_size=16)
    try:
        prompts = _prompts(plain)
        want = _greedy(plain, prompts, new=100)
    finally:
        plain.close()
    eng = BatchedEngine(MODEL, **BASE, kv_block_size=16, paged_kernel="on",
                        kv_overcommit="on", kv_blocks=16,
                        spec_draft="take:2", spec_k=3, spec_mode="on")
    try:
        assert _greedy(eng, prompts, new=100) == want
        assert eng.preempt_stats.get("resumed", 0) >= 1
        assert any(e[0] == "spec_settle" for e in eng.sched_trace)
    finally:
        eng.close()


# ------------------------------------------------- against the JAX engine
LOGIT_SCALE = 64.0  # a head on every step: see test_torch_sampling.py
SAMPLED = [(0.8, 1.0, 100), (0.8, 0.9, 101), (1.2, 1.0, 102), (0.0, 1.0, 103)]


@pytest.fixture(scope="module")
def peaked_export(tmp_path_factory):
    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer(MODEL)
    params = dict(params)
    params["norm"] = {"scale": params["norm"]["scale"] * LOGIT_SCALE}
    d = tmp_path_factory.mktemp("peaked_spec_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _sampled(eng):
    """The SAMPLED requests' streams. The scheduler waits at its admission
    gate until all four are queued, so both packages' engines decode the
    same batch from the first step (a row's sampling mode depends on the
    rows beside it; under load a request could otherwise join a tick
    late)."""
    tok = eng.tokenizer
    gate = threading.Event()
    admit = eng._admit_waiting

    def gated():
        gate.wait()
        admit()

    eng._admit_waiting = gated
    reqs = [eng.submit(tok.encode(f"prompt number {i} " * (i + 1)),
                       max_new_tokens=12, temperature=t, top_p=p, seed=s)
            for i, (t, p, s) in enumerate(SAMPLED)]
    gate.set()
    for r in reqs:
        assert r.done.wait(300) and r.error is None, r.error
    return [r.tokens for r in reqs]


def _sampled_in_two_ticks(eng):
    """The same four requests as ``_sampled``, but the last two reach the
    queue only after the scheduler has admitted the first two and run a
    tick: they join the batch a tick later."""
    tok = eng.tokenizer
    calls, first, second, reached = [0], *(threading.Event()
                                           for _ in range(3))
    admit = eng._admit_waiting

    def gated():
        calls[0] += 1
        if calls[0] == 1:
            first.wait()
        elif calls[0] == 2:
            reached.set()
            second.wait()
        admit()

    eng._admit_waiting = gated
    reqs = []
    for i, (t, p, s) in enumerate(SAMPLED):
        if i == 2:
            first.set()
            assert reached.wait(120)
        reqs.append(eng.submit(tok.encode(f"prompt number {i} " * (i + 1)),
                               max_new_tokens=12, temperature=t, top_p=p,
                               seed=s))
    second.set()
    for r in reqs:
        assert r.done.wait(300) and r.error is None, r.error
    return [r.tokens for r in reqs]


def test_seeded_spec_streams_depend_on_the_schedule_in_both_packages(
        peaked_export):
    """A seeded sampled stream on a spec engine depends on when its
    neighbours were admitted and on what the engine's spec controllers
    learned before, in the reference as in the port: a request that joins
    a tick later changes the batch's sampling mode, and a rerun on the same
    engine starts from another k, so other steps draw each row's tokens.
    Both packages give the same streams in each case, and the same rows
    change: a repeat check holds only on a fresh engine with the schedule
    held fixed."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JE

    kw = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
              prefill_chunk=64, kv_block_size=16, paged_kernel="on",
              sampling_epilogue="off", spec_draft="take:1", spec_k=3,
              spec_mode="on")
    runs = {}
    for pkg, make in (("jax", lambda: JE(peaked_export, **kw)),
                      ("port", lambda: BatchedEngine(peaked_export,
                                                     device="cpu", **kw))):
        eng = make()
        try:
            runs[pkg, "fixed"] = _sampled(eng)
            runs[pkg, "rerun"] = _sampled(eng)
        finally:
            eng.close()
        eng = make()
        try:
            runs[pkg, "late"] = _sampled_in_two_ticks(eng)
        finally:
            eng.close()
    for case in ("fixed", "rerun", "late"):
        assert runs["port", case] == runs["jax", case], case
        moved = [a != b for a, b in zip(runs["jax", "fixed"],
                                        runs["jax", case])]
        # the greedy row never moves; a sampled row does
        assert not moved[3] and (case == "fixed" or any(moved[:3])), (
            case, moved)


@pytest.mark.parametrize("tree", [None, "2x2"])
def test_spec_plan_depends_on_the_slot_order_in_both_packages(tree):
    """Both engines fold a verify step's acceptances into the controller in
    slot order (``obs`` is built over ``range(slots)``), and the global EMA
    that picks the next k (or tree width) is not symmetric in its inputs:
    the same rows in other slots give another plan, in the reference as in
    the port. So a seeded sampled stream on a spec engine also depends on
    which slot each request took, i.e. on the order it reached the queue;
    a repeat check must queue its batch in a fixed order."""
    spec = jspec.parse_spec_tree(tree) if tree else None
    tspec_ = tspec.parse_spec_tree(tree) if tree else None
    rows = [(0, 0, 4), (1, 4, 4), (2, 1, 4), (3, 4, 4)]
    by_slot = [[(s, a, k) for s, (_, a, k) in enumerate(order)]
               for order in (rows, rows[::-1])]
    plans = {}
    for pkg, ctrl in (("jax", lambda: jspec.AdaptiveK(4, mode="on",
                                                      tree=spec)),
                      ("port", lambda: tspec.AdaptiveK(4, mode="on",
                                                       tree=tspec_))):
        for i, obs in enumerate(by_slot):
            c = ctrl()
            c.observe(obs)
            plans[pkg, i] = (tuple(c.current_plan()), c.global_ema)
    assert plans["port", 0] == plans["jax", 0]
    assert plans["port", 1] == plans["jax", 1]
    # the same acceptances, reversed over the slots: another plan
    assert plans["jax", 0][0] != plans["jax", 1][0], plans


@pytest.mark.parametrize("tree", [None, "2x2"])
@pytest.mark.parametrize("epilogue", ["off", "on"])
def test_spec_engine_matches_jax_spec_engine(peaked_export, tree, epilogue):
    """The same weights, seeds and flags through both packages' spec
    engines: sampled, top-p and greedy streams equal token for token, and
    the same proposals accepted. The port's epilogue runs K9's plain
    version, the reference's its XLA twin (``impl="xla"`` on the CPU)."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JE

    kw = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
              prefill_chunk=64, kv_block_size=16, paged_kernel="on",
              sampling_epilogue=epilogue, spec_draft="take:1", spec_k=3,
              spec_mode="on", spec_tree=tree)
    jeng = JE(peaked_export, **kw)
    try:
        want, jinfo = _sampled(jeng), jeng.spec_info()
    finally:
        jeng.close()
    eng = BatchedEngine(peaked_export, device="cpu", **kw)
    try:
        got, info = _sampled(eng), eng.spec_info()
    finally:
        eng.close()
    assert got == want
    assert len({tuple(w) for w in want}) > 1
    for key in ("proposed", "accepted", "spec_steps", "tree_steps"):
        assert info[key] == jinfo[key], key


def test_server_serves_speculatively():
    """``--spec_draft_config`` / ``--spec_k`` / ``--spec_mode`` /
    ``--spec_tree`` reach the engine; a chat is answered."""
    import json
    import threading
    import time
    import urllib.request

    from datatunerx_tpu_torch.serving import server as tserver

    args = tserver.parse_args([
        "--model_path", MODEL, "--template", "vanilla", "--max_seq_len",
        "256", "--slots", "2", "--device", "cpu", "--port", "0",
        "--kv_block_size", "16", "--spec_draft_config", "take:1",
        "--spec_k", "2", "--spec_mode", "on", "--spec_tree", "2x2"])
    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    srv = tserver.start(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for _ in range(600):
            if tserver.STATE.engine is not None or tserver.STATE.error:
                break
            time.sleep(0.05)
        assert tserver.STATE.error is None, tserver.STATE.error
        eng = tserver.STATE.engine
        assert eng.spec_k == 2 and str(eng.spec_tree) == "2x2"
        port = srv.server_address[1]
        body = json.dumps({"messages": [{"role": "user", "content": "hi"}],
                           "max_tokens": 6}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/chat/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            doc = json.loads(resp.read())
        assert doc["choices"][0]["message"]["role"] == "assistant"
        assert eng.spec_info()["spec_steps"] > 0
    finally:
        srv.shutdown()
        srv.server_close()
        if tserver.STATE.engine is not None:
            tserver.STATE.engine.close()
        tserver.STATE.engine, tserver.STATE.error = saved
