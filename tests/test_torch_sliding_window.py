"""The slice as a whole on HF checkpoint directories (written here by
``save_pretrained``; nothing is downloaded): Mistral's sliding window in the
port's forward against the JAX forward and ``MistralForCausalLM`` at T = 40
past a window of 16 (no cache, dense-cache decode, paged gather — the
paged kernels stay off, as in the reference), the port's ``BatchedEngine``
greedy streams against the JAX ``BatchedEngine`` on the mistral directory,
the single-request engine (plain and int8) against the JAX one on both
directories, one LoRA ``Trainer.train_step`` against the JAX ``Trainer``,
and the trainer
CLI and the server on an HF llama directory against the JAX CLI and server.
Forward tolerance atol 2e-4 / rtol 2e-3 (f32), as tests/test_model_parity.py.
"""

import csv
import dataclasses
import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_hf_dirs import write_hf_dir

from datatunerx_tpu.data.preprocess import pack_to_block as jpack
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.serving import server as jserver
from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu.training.train_lib import Trainer as JTrainer
from datatunerx_tpu.tuning.train import main as jmain
from datatunerx_tpu.utils.decoding import prepare_prompt
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.models import llama as tllama
from datatunerx_tpu_torch.models.convert import lora_from_jax
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.ops.paged_attention import init_paged_cache
from datatunerx_tpu_torch.serving import server as tserver
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer
from datatunerx_tpu_torch.tuning.train import main as tmain
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer

TOL = dict(atol=2e-4, rtol=2e-3)
T = 40  # past the window of 16


@pytest.fixture(scope="module")
def mistral_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("mistral"), "mistral", "BF16")


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("llama"), "llama", "F16",
                        shard_kb=40)


@pytest.fixture(scope="module")
def loaded(mistral_dir):
    """(JAX cfg, JAX params, port cfg, port params, HF logits) at f32."""
    from transformers import MistralForCausalLM

    jcfg, jparams, _ = jload(mistral_dir)
    tcfg, tparams, _ = load_model_and_tokenizer(mistral_dir)
    assert tcfg.sliding_window == jcfg.sliding_window == 16
    hf = MistralForCausalLM.from_pretrained(
        mistral_dir, torch_dtype=torch.float32, attn_implementation="eager")
    tokens = np.random.default_rng(0).integers(
        3, tcfg.vocab_size, size=(2, T)).astype(np.int32)
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.from_numpy(tokens).long()).logits
    return jcfg, jparams, tcfg, tparams, tokens, hf_logits.numpy()


def test_forward_matches_jax_and_hf(loaded):
    jcfg, jparams, tcfg, tparams, tokens, hf_logits = loaded
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg)
    tl, _ = forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), hf_logits, **TOL)
    # the window binds: without it the last position reads otherwise
    nowin, _ = forward(tparams, torch.from_numpy(tokens),
                       dataclasses.replace(tcfg, sliding_window=None))
    assert np.abs(nowin.numpy()[:, -1] - hf_logits[:, -1]).max() > 1e-2


class _Calls:
    """Counts calls of the model's paged kernel steps (K7, K8)."""

    def __init__(self, monkeypatch):
        self.n = {"decode": 0, "multitoken": 0}
        for kind in self.n:
            name = f"paged_attention_{kind}_step"
            real = getattr(tllama, name)

            def wrapped(*a, _real=real, _kind=kind, **kw):
                self.n[_kind] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(tllama, name, wrapped)


@pytest.mark.parametrize("layout", ["dense", "paged-gather", "paged-kernel"])
def test_cached_decode_matches_hf(loaded, layout, monkeypatch):
    """Prefill 24 tokens (chunks of 16 and 8), then teacher-force the other
    16 one at a time: every step's logits equal HF's full-sequence logits
    at that position. ``paged_kernel`` on still takes the gather path."""
    jcfg, jparams, tcfg, tparams, tokens, hf_logits = loaded
    calls = _Calls(monkeypatch)
    if layout == "dense":
        cache = init_cache(tcfg, 2, 64, dtype=torch.float32)
    else:
        tcfg = dataclasses.replace(tcfg,
                                   paged_kernel=layout == "paged-kernel")
        cache = init_paged_cache(tcfg, 2, 8, 16, 4, dtype=torch.float32)
        cache["block_tables"] = torch.tensor([[3, 0, 5, -1], [1, 6, 2, -1]],
                                             dtype=torch.int32)
    got = []
    for lo, hi in [(0, 16), (16, 24)] + [(t, t + 1) for t in range(24, T)]:
        pos = torch.arange(lo, hi, dtype=torch.int32)[None].expand(2, -1)
        logits, cache = forward(tparams, torch.from_numpy(tokens[:, lo:hi]),
                                tcfg, positions=pos.contiguous(), cache=cache)
        got.append(logits.numpy())
    np.testing.assert_allclose(np.concatenate(got, axis=1), hf_logits, **TOL)
    assert calls.n == {"decode": 0, "multitoken": 0}


KW = dict(template="vanilla", max_seq_len=128, slots=2, decode_chunk=4,
          kv_block_size=16, prefill_chunk=32, prefill_token_budget=32,
          paged_kernel="on", sampling_epilogue="on")
NEW = 10


def _near_tie(path, prompt, prefix, engine=None) -> bool:
    """The JAX bf16 forward (the weights of ``path``, or ``engine``'s own,
    quantized ones included) puts the step's top two logits within 2 bf16
    ulps."""
    cfg, params, tok = (jload(path, dtype=jnp.bfloat16) if engine is None
                        else (engine.cfg, engine.params, engine.tokenizer))
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, KW["max_seq_len"], NEW)
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


def _streams(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        assert r.done.wait(300)
        assert r.error is None, r.error
    return [r.tokens for r in reqs]


def test_engine_greedy_streams_match_jax_engine(mistral_dir, llama_dir,
                                                monkeypatch):
    """Prompts past the window, paged kernels asked for: the streams equal
    the JAX engine's up to a near-tie, and no paged kernel step runs on the
    window model (one runs on the llama directory)."""
    jeng = JEngine(mistral_dir, **KW)
    try:
        tok = jeng.tokenizer
        prompts = [tok.encode("the sliding window of a mistral model " * 3),
                   tok.encode("a second prompt, longer than the window " * 2)]
        assert all(len(p) > 16 for p in prompts)
        want = _streams(jeng, prompts)
    finally:
        jeng.close()
    calls = _Calls(monkeypatch)
    teng = BatchedEngine(mistral_dir, device="cpu", **KW)
    try:
        assert teng.tokenizer.encode("x y") == tok.encode("x y")
        got = _streams(teng, prompts)
        assert teng.sampling_stats["fused_steps"] > 0
    finally:
        teng.close()
    assert calls.n == {"decode": 0, "multitoken": 0}
    for p, g, w in zip(prompts, got, want):
        assert len(g) == len(w) == NEW
        div = next((i for i in range(NEW) if g[i] != w[i]), None)
        if div is not None:
            assert _near_tie(mistral_dir, p, w[:div]), div
    ctrl = BatchedEngine(llama_dir, device="cpu", **KW)
    try:
        _streams(ctrl, prompts[:1])
    finally:
        ctrl.close()
    assert calls.n["decode"] > 0 and calls.n["multitoken"] > 0


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_single_request_engine_on_hf_directories(mistral_dir, llama_dir,
                                                 quantization):
    """The single-request engine (``--slots 1``, and serve-time
    ``--quantization``) on HF directories, against the JAX package's: the
    same greedy stream up to a near-tie, past the window on mistral."""
    from datatunerx_tpu.serving.engine import InferenceEngine as JSingle
    from datatunerx_tpu_torch.serving.engine import InferenceEngine

    for path in (mistral_dir, llama_dir):
        kw = dict(template="vanilla", max_seq_len=KW["max_seq_len"],
                  quantization=quantization)
        jeng, teng = JSingle(path, **kw), InferenceEngine(path, device="cpu",
                                                          **kw)
        prompt = teng.tokenizer.encode("one engine, one request, " * 4)
        assert prompt == jeng.tokenizer.encode("one engine, one request, "
                                               * 4)
        assert len(prompt) > 16
        want = jeng.generate(prompt, max_new_tokens=NEW)
        got = teng.generate(prompt, max_new_tokens=NEW)
        assert len(got) == len(want) == NEW
        div = next((i for i in range(NEW) if got[i] != want[i]), None)
        if div is not None:
            assert _near_tie(path, prompt, want[:div], jeng), div


def _batch(vocab, B=2, T_=64):
    """Packed rows of ~30-token sequences: each longer than the window."""
    rng = np.random.default_rng(3)
    exs = []
    for _ in range(4 * B):
        n = int(rng.integers(24, 32))
        ids = rng.integers(3, vocab, size=n).tolist()
        exs.append({"input_ids": ids, "labels": [IGNORE_INDEX] * 4 + ids[4:],
                    "attention_mask": [1] * n})
    b = jpack(exs, T_, use_native=False)
    return {k: v[:B] for k, v in b.items()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lora_train_step_matches_jax_trainer(mistral_dir, impl):
    """flash is off for a window model in both packages: the step takes the
    biased path either way."""
    jcfg, jparams, _ = jload(mistral_dir)
    tcfg, tparams, _ = load_model_and_tokenizer(mistral_dir)
    jcfg = dataclasses.replace(jcfg, attention_impl=impl, remat="full")
    tcfg = dataclasses.replace(tcfg, attention_impl=impl, remat="full")
    common = dict(finetuning_type="lora", lora_dropout=0.0,
                  learning_rate=1e-3, total_steps=10, grad_accum=1,
                  lora_targets=("q_proj", "v_proj"))
    jtr = JTrainer(jcfg, JTrainConfig(compute_dtype=jnp.float32, **common))
    jstate = jtr.init_state(jparams, jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    lora = jax.device_get(jstate.lora)
    for ab in lora["layers"].values():  # B starts at 0: give it values
        ab["b"] = (rng.normal(size=ab["b"].shape) * 0.05).astype(np.float32)
    lora_j = jax.tree_util.tree_map(jnp.asarray, lora)
    jstate = jstate.replace(lora=lora_j, opt_state=jtr.optimizer.init(lora_j))
    ttr = Trainer(tcfg, TrainConfig(compute_dtype=torch.float32, **common),
                  device="cpu")
    tstate = ttr.init_state(tparams, 1)
    tlora = lora_from_jax(lora, tcfg)
    tstate = dataclasses.replace(tstate, lora=tlora,
                                 opt_state=ttr.optimizer.init(tlora))
    batch = _batch(jcfg.vocab_size)
    jnew, jm = jtr.train_step(jstate, batch)
    tnew, tm = ttr.train_step(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jnew.lora):
        node = tnew.lora
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   atol=1e-5, rtol=1e-4)


def _csv(path):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction", "response"])
        w.writerows((f"add {k} and {k}", f"the answer is {2 * k}")
                    for k in range(24))
    return str(path)


def _argv(tmp, name, model, **extra):
    flags = dict(model_name_or_path=model, train_path=_csv(tmp / "t.csv"),
                 storage_path=str(tmp / "storage"),
                 output_dir=str(tmp / name), uid=name, template="alpaca",
                 block_size="64", pack_sequences="true",
                 per_device_train_batch_size="2", max_steps="2",
                 logging_steps="1", bf16="false", remat="none",
                 attention="xla", lora_dropout="0.0")
    flags.update(extra)
    return [x for k, v in flags.items() for x in (f"--{k}", v)]


def _log(tmp, name):
    with open(tmp / name / "watch" / "trainer_log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_trainer_cli_on_an_hf_directory_matches_the_jax_cli(tmp_path,
                                                            llama_dir):
    """Both CLIs on the same HF llama directory and CSV: the same manifest
    and log keys, the same token counts, the first step's loss (the LoRA B
    leaves start at zero) within 1e-4; the port's checkpoint then serves
    over the HF base through ``checkpoint_path``. The JAX CLI's global
    batch spans the host's devices, so the port's batch is that size."""
    assert jmain(_argv(tmp_path, "jax", llama_dir)) == 0
    batch = str(2 * jax.device_count())
    assert tmain(_argv(tmp_path, "port", llama_dir, device="cpu",
                       per_device_train_batch_size=batch)) == 0
    with open(tmp_path / "storage" / "jax" / "manifest.json") as f:
        jm = json.load(f)
    with open(tmp_path / "storage" / "port" / "manifest.json") as f:
        tm = json.load(f)
    assert sorted(tm) == sorted(jm) and sorted(tm["metrics"]) == sorted(
        jm["metrics"])
    jl, tl = _log(tmp_path, "jax"), _log(tmp_path, "port")
    assert len(jl) == len(tl) == 2
    assert [r["tokens"] for r in tl] == [r["tokens"] for r in jl]
    np.testing.assert_allclose(tl[0]["loss"], jl[0]["loss"], rtol=1e-4)
    eng = BatchedEngine(llama_dir, checkpoint_path=tm["checkpoint"],
                        device="cpu", **KW)
    try:
        assert "default" in eng.adapter_ids
        p = eng.tokenizer.encode("add 3 and 3")
        base = eng.perplexity(p, eng.tokenizer.encode(" the answer is 6"))
        tuned = eng.perplexity(p, eng.tokenizer.encode(" the answer is 6"),
                               adapter="default")
        assert base["num_tokens"] == tuned["num_tokens"] > 0
        assert base["nll_sum"] != tuned["nll_sum"]
    finally:
        eng.close()


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(port, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST" if body is not None else "GET", path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read().decode())
    conn.close()
    return out


def test_server_on_an_hf_directory_matches_the_jax_server(llama_dir):
    """Both servers over real engines on the same HF llama directory with
    the chatml template (its stop word is added to the tokenizer): the same
    chat prompt and stop ids, ``usage.prompt_tokens``, ``/v1/models`` and
    ``/perplexity`` (token count equal, ``mean_nll`` within 1e-2)."""
    kw = dict(KW, template="chatml")
    saved = (jserver.STATE.engine, tserver.STATE.engine, tserver.STATE.error)
    jserver.STATE.engine = JEngine(llama_dir, **kw)
    tserver.STATE.engine = BatchedEngine(llama_dir, device="cpu", **kw)
    tserver.STATE.error = None
    jserver.STATE.model_path = tserver.STATE.model_path = llama_dir
    jsrv, tsrv = _serve(jserver.Handler), _serve(tserver.Handler)
    try:
        msgs = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello there, <|im_end|> x"}]
        jp, js = jserver.STATE.engine._encode_chat(msgs)
        tp, ts = tserver.STATE.engine._encode_chat(msgs)
        assert (tp, ts) == (jp, js)
        assert tserver.STATE.engine.tokenizer.convert_tokens_to_ids(
            "<|im_end|>") in ts
        ports = (jsrv.server_address[1], tsrv.server_address[1])
        chat = {"messages": msgs, "max_tokens": 4}
        (jc, jb), (tc, tb) = (_post(p, "/chat/completions", chat)
                              for p in ports)
        assert jc == tc == 200
        assert tb["usage"]["prompt_tokens"] == jb["usage"]["prompt_tokens"]
        assert tb["model"] == jb["model"] == llama_dir
        (_, jmod), (_, tmod) = (_post(p, "/v1/models") for p in ports)
        assert tmod == jmod
        body = {"prompt": "the quick brown fox", "completion": " jumps over"}
        (jc, jb), (tc, tb) = (_post(p, "/perplexity", body) for p in ports)
        assert jc == tc == 200 and set(tb) == set(jb)
        assert tb["num_tokens"] == jb["num_tokens"] > 0
        np.testing.assert_allclose(tb["mean_nll"], jb["mean_nll"], rtol=1e-2)
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        jserver.STATE.engine.close()
        tserver.STATE.engine.close()
        (jserver.STATE.engine, tserver.STATE.engine,
         tserver.STATE.error) = saved
