"""The slice as a whole: the port's paged ``BatchedEngine`` (CPU, kernels'
plain versions) against the JAX package's ``BatchedEngine`` with its Pallas
paged kernels and sampling epilogue on (interpret mode), both serving the
SAME weights — the JAX ``preset:debug`` export written by
``export_merged_model`` and loaded by each package's own loader.

Greedy streams must be equal. A divergence is allowed only at a near-tie:
where JAX's logits for the step (a bf16 forward over the prompt plus the
agreed prefix) put the top two within 2 bf16 ulps, since bf16 matmuls round
in different places in the two frameworks."""

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

KW = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
          kv_block_size=16, prefill_chunk=64, prefill_token_budget=64,
          paged_kernel="on", sampling_epilogue="on")
NEW = 12


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _prompts(tok):
    return {
        "short": tok.encode("hi"),
        "chunked": tok.encode("long context " * 12),  # 156 tokens: 3 chunks
        "pair_a": tok.encode("pair one"),
        "pair_b": tok.encode("pair two is longer " * 3),
    }


def _run(engine, prompts):
    out = {n: engine.generate(prompts[n], max_new_tokens=NEW)
           for n in ("short", "chunked")}
    reqs = {n: engine.submit(prompts[n], max_new_tokens=NEW)
            for n in ("pair_a", "pair_b")}  # concurrent, ragged lengths
    for n, r in reqs.items():
        assert r.done.wait(300), n
        assert r.error is None, r.error
        out[n] = r.tokens
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


def test_greedy_streams_match_jax_engine(export_dir):
    jeng = JEngine(export_dir, **KW)
    try:
        prompts = _prompts(jeng.tokenizer)
        want = _run(jeng, prompts)
    finally:
        jeng.close()
    teng = BatchedEngine(export_dir, device="cpu", **KW)
    try:
        assert teng.decode_path == "kernel"
        assert teng.sampling_epilogue == "on"
        got = _run(teng, prompts)
        assert teng.free_kv_blocks == teng.total_kv_blocks
        chunks = [e for e in teng.sched_trace if e[0] == "prefill"]
        assert max(sum(1 for e in chunks if e[1] == s)
                   for s in range(2)) >= 2  # the long prompt chunk-prefilled
        assert teng.sampling_stats["fused_steps"] > 0
    finally:
        teng.close()
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w) == NEW, name
        div = next((i for i in range(NEW) if g[i] != w[i]), None)
        if div is not None:
            assert _near_tie(export_dir, prompts[name], w[:div]), (name, div)


def test_sampled_streams_are_seeded_and_paths_agree(export_dir):
    """Sampled streams differ from JAX's (another RNG), but a seed fixes
    them, and the kernel path (plain versions here) and the gather path with
    the legacy sampler serve the same greedy stream."""
    kern = BatchedEngine(export_dir, device="cpu", **KW)
    plain = BatchedEngine(export_dir, device="cpu",
                          **dict(KW, paged_kernel="off",
                                 sampling_epilogue="off"))
    try:
        assert plain.decode_path == "gather"
        p = kern.tokenizer.encode("sampled probe")
        a = kern.generate(p, max_new_tokens=8, temperature=0.8, seed=7)
        b = kern.generate(p, max_new_tokens=8, temperature=0.8, seed=7)
        assert a == b and len(a) == 8
        assert kern.generate(p, max_new_tokens=8) == \
            plain.generate(p, max_new_tokens=8)
        assert plain.sampling_stats["legacy_steps"] > 0
    finally:
        kern.close()
        plain.close()


@pytest.mark.parametrize("kwargs, item", [
    ({"kv_block_size": 0}, "item 1"),
    ({"prefix_cache": 4}, "item 2"),
    ({"kv_overcommit": "on"}, "item 2"),
    ({"adapters": {"a": "/nowhere"}}, "item 3"),
    ({"kv_quant": "int8"}, "item 4"),
    ({"spec_draft": "take:1"}, "item 5"),
])
def test_flags_outside_the_slice_are_refused(kwargs, item):
    kw = dict(KW, device="cpu")
    kw.update(kwargs)
    with pytest.raises(ValueError, match=f"ROADMAP Queue 1 {item}"):
        BatchedEngine("preset:debug", **kw)


def test_bad_modes_raise():
    with pytest.raises(ValueError, match="auto|on|off"):
        BatchedEngine("preset:debug", device="cpu",
                      **dict(KW, paged_kernel="sometimes"))


def test_auto_resolves_off_on_the_cpu():
    eng = BatchedEngine("preset:debug", device="cpu",
                        **dict(KW, paged_kernel="auto",
                               sampling_epilogue="auto"))
    try:
        assert eng.decode_path == "gather"
        assert eng.sampling_epilogue == "off"
        assert eng.generate([5, 6, 7], max_new_tokens=3)
        assert isinstance(eng._cache["k"], torch.Tensor)
    finally:
        eng.close()
