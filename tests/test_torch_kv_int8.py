"""The int8 KV cache of the port held against the JAX package on the CPU.

Inputs come from a numpy seed and go to both sides as numpy arrays.

Tolerances, each with its reason:

- ``kv_quantize`` / ``kv_dequantize``: int8 bytes, f32 scales and the
  dequantized values are EXACT (the same f32 divide, round-half-even and
  clip, then one f32 product rounded once).
- paged writes and gathers with scale pools, ``cache_from_jax``: exact
  (copies).
- the plain versions of the int8 K7/K8 instantiations against the Pallas
  kernels in interpret mode, over the cases of
  ``tests/test_pallas_paged_attention.py``'s int8 tests: float32 at rtol 1e-5
  / atol 1e-6 (f32 sums in another order); bf16 bitwise, both against the
  Pallas kernel and against the port's own gather path on the dequantized
  view (every input of the f32 sums is a bf16 value, the staged tiles and
  the rounded probabilities are equal bit for bit, and the sums over at most
  32 lanes agree after the one rounding to bf16).
- forward logits over int8 caches against the JAX forward at float32: atol
  2e-4, rtol 2e-3 (``tests/test_torch_llama.py``'s bound) with the int8
  bytes of the two caches at most one code apart (a value that sits on a
  rounding boundary of ``x / scale`` may fall either way when the f32
  projections differ in their last bits); paged against dense inside the
  port: exact, as ``tests/test_paged_engine.py`` holds the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_cache as jinit_dense
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops import attention as jatt
from datatunerx_tpu.ops import paged_attention as jpa
from datatunerx_tpu.ops import pallas_paged_attention as jpk
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import cache_from_jax, params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.llama import init_cache as tinit_dense
from datatunerx_tpu_torch.ops import attention as tatt
from datatunerx_tpu_torch.ops import cuda_paged_attention as tpk
from datatunerx_tpu_torch.ops import paged_attention as tpa

BS = 8
SENT = jpa.POS_SENTINEL
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


# ------------------------------------------------- quantize / dequantize
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_quantize_is_bit_equal_to_reference(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero vector: scale 0
    x[0, 1, 1] *= 1e-12                   # below the 1e-8 floor of the divide
    x[1, 2, 3, :4] = [0.5, 1.5, 2.5, 127]  # ties of x / scale (scale = 1)
    x[1, 2, 3, 4:] = 0.0
    x[2] *= 300.0
    jx = jnp.asarray(x).astype(JDT[dt])
    tx = torch.from_numpy(x).to(TDT[dt])
    jq, js = jatt.kv_quantize(jx)
    tq, ts = tatt.kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out in ("f32", "bf16"):
        jd = jatt.kv_dequantize(jq, js, JDT[out])
        td = tatt.kv_dequantize(tq, ts, TDT[out])
        assert td.dtype == TDT[out]
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd, np.float32))


# ------------------------------------------------------------ cache dicts
def test_init_paged_cache_int8_matches_reference_plus_scratch():
    jcfg, tcfg = jget_config("debug"), tget_config("debug")
    jc = jpa.init_paged_cache(jcfg, 2, 6, BS, 3, quantize="int8")
    tc = tpa.init_paged_cache(tcfg, 2, 6, BS, 3, quantize="int8")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        shape = list(jc[name].shape)
        if name in ("k", "v", "k_scale", "v_scale"):
            shape[1] += 1  # the scratch block of invalid writes
        elif name == "pos":
            shape[0] += 1
        assert list(tc[name].shape) == shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name
    with pytest.raises(ValueError, match="unsupported cache quantization"):
        tpa.init_paged_cache(tcfg, 2, 6, BS, 3, quantize="int4")
    with pytest.raises(ValueError, match="unsupported cache quantization"):
        jpa.init_paged_cache(jcfg, 2, 6, BS, 3, quantize="int4")


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_cache_from_jax_carries_every_leaf(layout, quant):
    jcfg = jget_config("debug")
    rng = np.random.default_rng(1)
    if layout == "paged":
        jc = jpa.init_paged_cache(jcfg, 2, 5, BS, 3, quantize=quant)
        jc["block_tables"] = jnp.asarray([[0, 2, -1], [4, 1, 3]], jnp.int32)
    else:
        jc = jinit_dense(jcfg, 2, 24, per_slot=True, quantize=quant)
    jc = dict(jc)
    for name in ("k", "v"):
        vals = rng.integers(-100, 100, size=jc[name].shape)
        jc[name] = jnp.asarray(vals).astype(jc[name].dtype)
    jc["pos"] = jnp.asarray(rng.integers(0, 50, size=jc["pos"].shape),
                            jnp.int32)
    tc = cache_from_jax(jax.device_get(jc))
    assert sorted(tc) == sorted(jc)
    for name, leaf in jc.items():
        got = tc[name]
        if layout == "paged" and name in ("k", "v", "k_scale", "v_scale"):
            assert not got[:, -1].any()       # the appended scratch block
            got = got[:, :-1]
        elif layout == "paged" and name == "pos":
            assert (got[-1] == SENT).all()
            got = got[:-1]
        assert str(got.dtype).split(".")[1] == str(leaf.dtype), name
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("T", [1, 3])
def test_paged_int8_writes_and_gathers_match_reference(T):
    """Values AND scales scatter through the tables (invalid targets dropped
    by JAX, routed to the scratch block by the port); the gathered values and
    scales agree element for element."""
    rng = np.random.default_rng(2)
    slots, NB, nbps, KV, d = 3, 10, 4, 2, 8
    tables = np.full((slots, nbps), -1, np.int32)
    tables[0, :3] = [4, 1, 7]
    tables[1, :1] = [2]
    tables[2, :4] = [0, 3, 5, 6]
    lens = np.array([5, 7, nbps * BS - 1], np.int32)  # slot 2 runs out
    k = rng.integers(-127, 127, size=(NB, BS, KV, d)).astype(np.int8)
    ks = rng.random((NB, BS, KV)).astype(np.float32)
    jc = {"len": jnp.asarray(lens), "block_tables": jnp.asarray(tables),
          "pos": jnp.full((NB, BS), SENT, jnp.int32),
          "k": jnp.asarray(k)[None], "v": jnp.asarray(k[::-1].copy())[None],
          "k_scale": jnp.asarray(ks)[None],
          "v_scale": jnp.asarray(ks[::-1].copy())[None]}
    tc = cache_from_jax(jax.device_get(jc))
    kw = rng.standard_normal((slots, T, KV, d)).astype(np.float32)
    vw = rng.standard_normal((slots, T, KV, d)).astype(np.float32)
    jcache = {"block_tables": jc["block_tables"], "len": jc["len"]}
    jout = jatt.kv_cache_update(jcache, jc["k"][0], jc["v"][0],
                                jc["k_scale"][0], jc["v_scale"][0],
                                jnp.asarray(kw), jnp.asarray(vw))
    tout = tatt.kv_cache_update(tc, tc["k"][0], tc["v"][0], tc["k_scale"][0],
                                tc["v_scale"][0], torch.from_numpy(kw),
                                torch.from_numpy(vw))
    assert tout[0].data_ptr() == tc["k"][0].data_ptr()  # updated in place
    for i in range(4):  # pools and scale pools, scratch block aside
        np.testing.assert_array_equal(tout[i][:-1].numpy(),
                                      np.asarray(jout[i]))
    for i in (4, 5):    # the dequantized gathered views
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    # the kernel path's write alone leaves the same pools
    tc2 = cache_from_jax(jax.device_get(jc))
    w = tatt.kv_cache_write_paged(tc2, tc2["k"][0], tc2["v"][0],
                                  tc2["k_scale"][0], tc2["v_scale"][0],
                                  torch.from_numpy(kw), torch.from_numpy(vw))
    for i in range(4):
        np.testing.assert_array_equal(w[i].numpy(), tout[i].numpy())


# ------------------------------------------- K7/K8 int8: plain vs Pallas
def _pool(rng, B, NB, KV, d, lens, tables):
    """A block pool whose gathered view holds ``lens[b]`` tokens per slot
    (positions 0..len-1, sentinel elsewhere), quantized by the reference."""
    k = np.zeros((NB, BS, KV, d), np.float32)
    v = np.zeros((NB, BS, KV, d), np.float32)
    pos = np.full((NB, BS), SENT, np.int32)
    for b in range(B):
        for i in range(int(lens[b])):
            blk, off = tables[b, i // BS], i % BS
            k[blk, off] = rng.standard_normal((KV, d))
            v[blk, off] = rng.standard_normal((KV, d))
            pos[blk, off] = i
    kq, ks = jatt.kv_quantize(jnp.asarray(k))
    vq, vs = jatt.kv_quantize(jnp.asarray(v))
    return kq, vq, ks, vs, pos


def _tables(B, nbps, lens):
    rows, nxt = [], 0
    for b in range(B):
        need = max(1, -(-int(lens[b]) // BS))
        rows.append(list(range(nxt, nxt + need)) + [-1] * (nbps - need))
        nxt += need
    return np.asarray(rows, np.int32)


def _torch_pools(kq, vq, ks, vs, pos):
    """The reference's pools as the port holds them (scratch block added)."""
    c = cache_from_jax({"k": np.asarray(kq)[None], "v": np.asarray(vq)[None],
                        "k_scale": np.asarray(ks)[None],
                        "v_scale": np.asarray(vs)[None], "pos": pos,
                        "block_tables": np.zeros((1, 1), np.int32)})
    return c["k"][0], c["v"][0], c["k_scale"][0], c["v_scale"][0], c["pos"]


def _assert_kernel_parity(got, want, dt, live=None):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if live is not None:
        got, want = got[live], want[live]
    if dt == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _gather_path(q, tk, tv, tks, tvs, tables, kv_pos, qpos, dtype):
    """The port's own oracle: gather, dequantize, bias, xla_attention."""
    B = q.shape[0]
    tbl = torch.from_numpy(np.maximum(tables, 0)).long()
    k_all = tatt.kv_dequantize(tk[tbl], tks[tbl], dtype).reshape(
        B, -1, tk.shape[-2], tk.shape[-1])
    v_all = tatt.kv_dequantize(tv[tbl], tvs[tbl], dtype).reshape(
        B, -1, tv.shape[-2], tv.shape[-1])
    bias = tatt.make_causal_bias(torch.from_numpy(qpos),
                                 torch.from_numpy(kv_pos))
    return tatt.xla_attention(q, k_all, v_all, bias)


DECODE_CASES = {
    # tests/test_pallas_paged_attention.py:133 and :165
    "f32": dict(lens=(19, 7), dt="f32"),
    "bf16": dict(lens=(12, 23), dt="bf16"),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_int8_plain_matches_pallas_kernel(case):
    c = DECODE_CASES[case]
    B, NB, nbps, KV, G, d = 2, 8, 3, 2, 2, 16
    rng = np.random.default_rng(3)
    tables = _tables(B, nbps, c["lens"])
    kq, vq, ks, vs, pos = _pool(rng, B, NB, KV, d, c["lens"], tables)
    q = rng.standard_normal((B, KV * G, d)).astype(np.float32)
    qpos = np.asarray([n - 1 for n in c["lens"]], np.int32)
    want = jpk.paged_decode_attention(
        jnp.asarray(q).astype(JDT[c["dt"]]), kq, vq, ks, vs,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(qpos),
        interpret=True)
    tk, tv, tks, tvs, tpos = _torch_pools(kq, vq, ks, vs, pos)
    tq = torch.from_numpy(q).to(TDT[c["dt"]])
    before = tpk.paged_decode_attention.launches
    got = tpk.paged_decode_attention(
        tq, tk, tv, tks, tvs, torch.from_numpy(tables), tpos,
        torch.from_numpy(qpos))
    assert tpk.paged_decode_attention.launches == before  # plain on the CPU
    assert got.dtype == TDT[c["dt"]]
    _assert_kernel_parity(got, want, c["dt"])
    kv_pos = np.where((tables >= 0)[:, :, None], pos[np.maximum(tables, 0)],
                      SENT).reshape(B, -1)
    oracle = _gather_path(tq[:, None], tk, tv, tks, tvs, tables, kv_pos,
                          qpos[:, None], TDT[c["dt"]])[:, 0]
    _assert_kernel_parity(got, oracle.float().numpy(), c["dt"])


MT_CASES = {
    # tests/test_pallas_paged_attention.py:300 and :317
    "gqa_f32": dict(KV=4, G=3, d=8, lens=(11, 20), T=3, dt="f32"),
    "bf16": dict(KV=2, G=2, d=16, lens=(12, 23), T=5, dt="bf16"),
}


@pytest.mark.parametrize("case", sorted(MT_CASES))
def test_multitoken_int8_plain_matches_pallas_kernel(case):
    c = MT_CASES[case]
    B, NB, nbps, KV, G, d, T = 2, 8, 3, c["KV"], c["G"], c["d"], c["T"]
    rng = np.random.default_rng(4)
    tables = _tables(B, nbps, c["lens"])
    kq, vq, ks, vs, pos = _pool(rng, B, NB, KV, d, c["lens"], tables)
    q = rng.standard_normal((B, T, KV * G, d)).astype(np.float32)
    qpos = np.asarray([[max(int(n) - T + t, t) for t in range(T)]
                       for n in c["lens"]], np.int32)
    kv_pos = np.where((tables >= 0)[:, :, None], pos[np.maximum(tables, 0)],
                      SENT).reshape(B, -1)
    allow = np.array(jatt.attention_allow(jnp.asarray(qpos),
                                          jnp.asarray(kv_pos)))
    want = jpk.paged_multitoken_attention(
        jnp.asarray(q).astype(JDT[c["dt"]]), kq, vq, ks, vs,
        jnp.asarray(tables), jnp.asarray(allow), interpret=True)
    tk, tv, tks, tvs, _ = _torch_pools(kq, vq, ks, vs, pos)
    tq = torch.from_numpy(q).to(TDT[c["dt"]])
    got = tpk.paged_multitoken_attention(
        tq, tk, tv, tks, tvs, torch.from_numpy(tables),
        torch.from_numpy(allow))
    assert got.dtype == TDT[c["dt"]]
    live = allow.any(-1)  # rows with no attendable lane hold junk
    _assert_kernel_parity(got, want, c["dt"], live)
    oracle = _gather_path(tq, tk, tv, tks, tvs, tables, kv_pos, qpos,
                          TDT[c["dt"]])
    _assert_kernel_parity(got, oracle.float().numpy(), c["dt"], live)


# ------------------------------------------------------- forward, int8 KV
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("debug")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.device_get(jparams), tget_config("debug"))
    return jcfg, jparams, tparams


def _drive(fwd, params, cfg, cache, asarray, prompt, mask, pos, steps):
    """A two-chunk prefill, then greedy decode steps fed with ``steps``'
    tokens. Returns the logits of every call and the final cache."""
    outs = []
    for lo in (0, 16):
        sl = slice(lo, lo + 16)
        logits, cache = fwd(params, asarray(prompt[:, sl]), cfg,
                            positions=asarray(pos[:, sl]),
                            attention_mask=asarray(mask[:, sl]), cache=cache)
        outs.append(np.asarray(logits.detach() if hasattr(logits, "detach")
                               else logits))
    nxt = pos[:, -1] + 1
    for i, tok in enumerate(steps):
        p = (nxt + i)[:, None].astype(np.int32)
        logits, cache = fwd(params, asarray(tok[:, None]), cfg,
                            positions=asarray(p), cache=cache)
        outs.append(np.asarray(logits.detach() if hasattr(logits, "detach")
                               else logits))
    return outs, cache


def _inputs(vocab):
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, vocab, size=(2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, :3] = 0  # slot 1 is left-padded, as prepare_prompt pads
    pos = np.stack([np.arange(32), np.maximum(np.arange(32) - 3, 0)])
    steps = [rng.integers(0, vocab, size=(2,)).astype(np.int32)
             for _ in range(3)]
    return prompt, mask, pos.astype(np.int32), steps


TABLES = np.array([[3, 0, 5, -1], [1, 6, 2, -1]], np.int32)


def _caches(layout, jcfg, tcfg):
    if layout == "dense":
        jc = jinit_dense(jcfg, 2, 48, dtype=jnp.float32, per_slot=True,
                         quantize="int8")
        tc = tinit_dense(tcfg, 2, 48, dtype=torch.float32, per_slot=True,
                         quantize="int8")
        return jc, tc
    jc = jpa.init_paged_cache(jcfg, 2, 8, 16, 4, quantize="int8")
    jc["block_tables"] = jnp.asarray(TABLES)
    tc = tpa.init_paged_cache(tcfg, 2, 8, 16, 4, quantize="int8")
    tc["block_tables"] = torch.from_numpy(TABLES.copy())
    return jc, tc


@pytest.mark.parametrize("layout", ["dense", "gather", "kernel"])
def test_int8_cache_forward_matches_reference(weights, layout):
    jcfg, jparams, tparams = weights
    kernel = layout == "kernel"
    jcfg = dataclasses.replace(jcfg, paged_kernel=kernel)
    tcfg = dataclasses.replace(tget_config("debug"), paged_kernel=kernel)
    jc, tc = _caches(layout, jcfg, tcfg)
    prompt, mask, pos, steps = _inputs(jcfg.vocab_size)
    jouts, jc = _drive(jforward, jparams, jcfg, jc, jnp.asarray, prompt, mask,
                       pos, steps)
    touts, tc = _drive(tforward, tparams, tcfg, tc,
                       lambda a: torch.from_numpy(np.array(a)), prompt, mask,
                       pos, steps)
    live = [mask[:, :16].astype(bool), mask[:, 16:].astype(bool)]
    for i, (t, j) in enumerate(zip(touts, jouts)):
        if i < 2:
            t, j = t[live[i]], j[live[i]]
        np.testing.assert_allclose(t, j, **TOL)
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].dtype == torch.float32
    trim = (lambda t: t[:, :-1]) if layout != "dense" else (lambda t: t)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for name in ("k", "v"):
        diff = np.abs(trim(tc[name]).numpy().astype(np.int32)
                      - np.asarray(jc[name], np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-2, name
        np.testing.assert_allclose(trim(tc[name + "_scale"]).numpy(),
                                   np.asarray(jc[name + "_scale"]),
                                   rtol=1e-5, atol=1e-7)


def test_paged_int8_cache_matches_dense_int8(weights):
    """The port's counterpart of the reference's own test of that name: the
    gathered, dequantized block view is element-identical to the dense row,
    so int8 logits are equal bit for bit on the two layouts, through a
    prefill and decode steps."""
    _, _, tparams = weights
    tcfg = tget_config("debug")
    prompt, mask, pos, steps = _inputs(tcfg.vocab_size)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dense = tinit_dense(tcfg, 2, 64, dtype=torch.float32, per_slot=True,
                        quantize="int8")
    paged = tpa.init_paged_cache(tcfg, 2, 8, 16, 4, quantize="int8")
    paged["block_tables"] = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]],
                                         dtype=torch.int32)
    douts, dense = _drive(tforward, tparams, tcfg, dense, as_t, prompt, mask,
                          pos, steps)
    pouts, paged = _drive(tforward, tparams, tcfg, paged, as_t, prompt, mask,
                          pos, steps)
    for d, p in zip(douts, pouts):
        np.testing.assert_array_equal(d, p)
    # ragged: slot 1 holds only the blocks its request needs
    ragged = tpa.init_paged_cache(tcfg, 2, 8, 16, 4, quantize="int8")
    ragged["block_tables"] = torch.tensor([[0, 1, 2, 3], [4, 5, 6, -1]],
                                          dtype=torch.int32)
    routs, _ = _drive(tforward, tparams, tcfg, ragged, as_t, prompt, mask,
                      pos, steps)
    for d, r in zip(douts, routs):
        np.testing.assert_array_equal(d, r)
