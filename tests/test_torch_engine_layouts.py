"""Every cache layout of the port's ``BatchedEngine`` against the JAX
package's: the dense cache (``kv_block_size=0``), the paged gather path and
the paged kernel path (JAX: Pallas kernels in interpret mode; the port: the
kernels' plain versions on the CPU), each with a bf16 and an int8 KV cache.
Both engines serve the SAME weights — the JAX ``preset:debug`` export written
by ``export_merged_model`` and loaded by each package's own loader.

Greedy streams must be equal. A divergence is allowed only at a near-tie:
where JAX's logits for the step (a bf16 forward over the prompt plus the
agreed prefix) put the top two within 2 bf16 ulps, since bf16 matmuls round
in different places in the two frameworks (``tests/test_torch_engine.py``'s
rule). With an int8 cache a quantized K/V value may also differ by one code
between the frameworks, which moves logits by less than that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.decoding import prepare_prompt
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

BASE = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
            prefill_chunk=64, prefill_token_budget=64,
            sampling_epilogue="off")
LAYOUTS = {
    "dense": dict(kv_block_size=0, paged_kernel="auto"),
    "gather": dict(kv_block_size=16, paged_kernel="off"),
    "kernel": dict(kv_block_size=16, paged_kernel="on"),
}
PATHS = {"dense": ("dense", "dense"), "gather": ("gather", "gather"),
         "kernel": ("pallas", "kernel")}  # (JAX's name, the port's)
NEW = 10


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _run(engine, prompts):
    out = {"long": engine.generate(prompts["long"], max_new_tokens=NEW)}
    reqs = {n: engine.submit(prompts[n], max_new_tokens=NEW)
            for n in ("pair_a", "pair_b")}  # concurrent, ragged lengths
    for n, r in reqs.items():
        assert r.done.wait(300), n
        assert r.error is None, r.error
        out[n] = r.tokens
    # a second request through a slot the first left behind
    out["reuse"] = engine.generate(prompts["pair_a"], max_new_tokens=NEW)
    return out


def _near_tie(export_dir, prompt, prefix) -> bool:
    cfg, params, tok = jload(export_dir, dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, NEW)
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


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_match_jax_engine(export_dir, layout, kv_quant):
    kw = dict(BASE, kv_quant=kv_quant, **LAYOUTS[layout])
    jeng = JEngine(export_dir, **kw)
    try:
        assert jeng.decode_path == PATHS[layout][0]
        tok = jeng.tokenizer
        prompts = {"long": tok.encode("long context " * 8),  # 2 chunks paged
                   "pair_a": tok.encode("pair one"),
                   "pair_b": tok.encode("pair two is longer " * 3)}
        want = _run(jeng, prompts)
    finally:
        jeng.close()
    teng = BatchedEngine(export_dir, device="cpu", **kw)
    try:
        assert teng.decode_path == PATHS[layout][1]
        assert teng.kv_quant == kv_quant
        cache = teng._cache
        assert cache["k"].dtype == (torch.int8 if kv_quant
                                    else torch.bfloat16)
        assert ("k_scale" in cache) == bool(kv_quant)
        got = _run(teng, prompts)
        modes = {e[3] for e in teng.sched_trace if e[0] == "admit"}
        if layout == "dense":
            assert modes == {"dense"}
            assert teng.total_kv_blocks is None
            assert teng.free_kv_blocks is None
            assert tuple(cache["len"].shape) == (2,)
        else:
            assert modes == {"chunked"}
            assert teng.free_kv_blocks == teng.total_kv_blocks
    finally:
        teng.close()
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w) == NEW, name
        div = next((i for i in range(NEW) if g[i] != w[i]), None)
        if div is not None:
            assert _near_tie(export_dir, prompts[name], w[:div]), (name, div)


def test_int8_cache_is_about_half_the_bytes():
    kw = dict(BASE, kv_block_size=16, paged_kernel="off", device="cpu")
    full = BatchedEngine("preset:debug", **kw)
    half = BatchedEngine("preset:debug", kv_quant="int8", **kw)
    try:
        cfg = full.cfg
        lanes = full._cache["k"].shape[1] * 16 * cfg.num_layers  # per K, V
        per_vec = cfg.num_kv_heads
        assert full.kv_cache_bytes == 2 * lanes * per_vec * cfg.head_dim * 2
        assert half.kv_cache_bytes == 2 * lanes * per_vec * (cfg.head_dim + 4)
    finally:
        full.close()
        half.close()


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_dense_engine_equals_paged_gather_engine(kv_quant):
    """Inside the port the gathered block view equals the dense row element
    for element, so the two layouts serve the same greedy and the same
    seeded sampled streams."""
    kw = dict(BASE, kv_quant=kv_quant, device="cpu")
    dense = BatchedEngine("preset:debug", **dict(kw, kv_block_size=0))
    paged = BatchedEngine("preset:debug",
                          **dict(kw, kv_block_size=16, paged_kernel="off"))
    try:
        for text in ("the quick brown fox jumps over", "long context " * 12):
            p = dense.tokenizer.encode(text)
            assert dense.generate(p, max_new_tokens=12) == \
                paged.generate(p, max_new_tokens=12)
            assert dense.generate(p, max_new_tokens=8, temperature=0.8,
                                  seed=3) == \
                paged.generate(p, max_new_tokens=8, temperature=0.8, seed=3)
    finally:
        dense.close()
        paged.close()
