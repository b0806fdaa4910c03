"""The port's generative eval against the JAX package on the CPU: the text
metrics (equal floats), ``greedy_generate`` over the dense bf16 cache on a
``preset:debug`` export whose final norm is scaled by 64 (so every step has
a head), and ``generative_eval``'s ``generated_predictions.jsonl`` and
scores, with and without an unmerged adapter.

The near-tie rule: the two packages round their bf16 matmuls in other
places, so a stream may part only where the reference's own logits, over
the common prefix, hold the two tokens within 2 bf16 ulps of the top;
the tokens before the parting step are equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_cache as jinit_cache
from datatunerx_tpu.scoring import metrics as jmetrics
from datatunerx_tpu.training import generate as jgen
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.models.convert import lora_from_jax
from datatunerx_tpu_torch.scoring import metrics as tmetrics
from datatunerx_tpu_torch.training import generate as tgen
from datatunerx_tpu_torch.utils.model_loader import (
    load_model_and_tokenizer as tload,
)

LOGIT_SCALE = 64.0
NEAR_TIE_ULPS = 2.0


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    from datatunerx_tpu.training.checkpoint import export_merged_model

    cfg, params, _ = jload("preset:debug")
    params = dict(params)
    params["norm"] = {"scale": params["norm"]["scale"] * LOGIT_SCALE}
    d = tmp_path_factory.mktemp("peaked_generate_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


@pytest.fixture(scope="module")
def models(export):
    jcfg, jparams, jtok = jload(export)
    tcfg, tparams, ttok = tload(export, device="cpu")
    return jcfg, jparams, jtok, tcfg, tparams, ttok


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "d", "e", "f"]
    for _ in range(40):
        cand = " ".join(rng.choice(words, int(rng.integers(0, 9))))
        ref = " ".join(rng.choice(words, int(rng.integers(1, 9))))
        assert tmetrics.generation_scores(cand, ref) == \
            jmetrics.generation_scores(cand, ref)
        assert tmetrics.bleu4(cand, ref, zero_unigram_zero=True) == \
            jmetrics.bleu4(cand, ref, zero_unigram_zero=True)
    assert tmetrics.generation_scores("你好世界", "你好") == \
        jmetrics.generation_scores("你好世界", "你好")


def _ref_logits(jcfg, jparams, prompt, prefix, lora=None):
    """The reference's next-token logits after ``prompt + prefix`` (one
    bf16 prefill over a dense cache, as its generation computes them)."""
    ids = list(prompt) + list(prefix)
    cache = jinit_cache(jcfg, 1, len(ids), dtype=jnp.bfloat16)
    logits, _ = jforward(jparams, jnp.asarray([ids], jnp.int32), jcfg,
                         cache=cache, lora=lora, compute_dtype=jnp.bfloat16)
    return np.asarray(logits[0, -1], np.float32)


def _same_up_to_a_near_tie(got, want, logits_at):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            row = logits_at(want[:i])
            ulp = np.spacing(np.float32(np.abs(row).max())) * 2 ** 16
            assert abs(row[a] - row[b]) <= NEAR_TIE_ULPS * ulp, (i, a, b)
            return i
    assert len(got) == len(want)
    return None


def _lora(jcfg, tcfg):
    from datatunerx_tpu.models.lora import init_lora_params

    jl = init_lora_params(jcfg, jax.random.PRNGKey(4), rank=4)
    rng = np.random.default_rng(2)
    jl = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.1, jnp.float32),
        jl)
    return jl, lora_from_jax(jax.device_get(jl), tcfg)


@pytest.mark.parametrize("adapter", [False, True])
def test_greedy_generate_matches_reference(models, adapter):
    jcfg, jparams, jtok, tcfg, tparams, ttok = models
    jl = tl = None
    if adapter:
        jl, tl = _lora(jcfg, tcfg)
    for i, text in enumerate(("the quick brown fox", "hello " * 30)):
        prompt = jtok.encode(text)
        assert prompt == ttok.encode(text)
        want = jgen.greedy_generate(jparams, jcfg, jtok, prompt,
                                    lora=(jl, 4.0) if adapter else None,
                                    max_new_tokens=24 + i)
        got = tgen.greedy_generate(tparams, tcfg, ttok, prompt,
                                   lora=(tl, 4.0) if adapter else None,
                                   max_new_tokens=24 + i)
        assert got
        _same_up_to_a_near_tie(got, want, lambda pre: _ref_logits(
            jcfg, jparams, prompt, pre, (jl, 4.0) if adapter else None))


def test_generated_predictions_match_reference(models, tmp_path):
    from datatunerx_tpu.data.templates import get_template as jtemplate
    from datatunerx_tpu_torch.data.templates import get_template

    jcfg, jparams, jtok, tcfg, tparams, ttok = models
    records = [{"q": f"add {k} and {k}", "a": f"the sum is {2 * k}"}
               for k in range(5)] + [{"q": "", "a": "skipped"}]
    columns = {"q": "instruction", "a": "response"}
    kw = dict(max_new_tokens=16, max_examples=5, columns=columns)
    want = jgen.generative_eval(jparams, jcfg, jtok,
                                jtemplate("alpaca", jtok), records,
                                str(tmp_path / "jax"), **kw)
    got = tgen.generative_eval(tparams, tcfg, ttok,
                               get_template("alpaca", ttok), records,
                               str(tmp_path / "port"), **kw)

    def rows(d):
        with open(tmp_path / d / "generated_predictions.jsonl") as f:
            return [json.loads(line) for line in f]

    jrows, trows = rows("jax"), rows("port")
    assert len(trows) == len(jrows) == 5
    for a, b in zip(trows, jrows):
        assert (a["prompt"], a["label"]) == (b["prompt"], b["label"])
    if trows == jrows:
        assert got == want
    else:  # a near-tie parted a stream: held token by token above
        assert sorted(got) == sorted(want)
    assert sorted(got) == ["bleu-4", "rouge-1", "rouge-2", "rouge-l"]
    empty = tgen.generative_eval(tparams, tcfg, ttok,
                                 get_template("alpaca", ttok), records[-1:],
                                 str(tmp_path / "none"), columns=columns)
    assert empty == {}
    assert (tmp_path / "none" / "generated_predictions.jsonl").read_text() \
        == ""
    assert torch.is_tensor(tparams["norm"]["scale"])
