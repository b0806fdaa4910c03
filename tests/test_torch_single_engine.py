"""The port's single-request ``InferenceEngine`` (``--slots 1`` and every
serve-time ``--quantization``) against the JAX package's, both serving the
SAME weights — the JAX ``preset:debug`` export loaded by each package's own
loader — plus the reference's engine tests (``tests/test_serving_engine.py``)
ported, and the server's engine choice.

Greedy streams must be equal. A divergence is allowed only at a near-tie:
where JAX's logits for the step (a bf16 forward over the prompt plus the
agreed prefix) put the top two within 2 bf16 ulps (``test_torch_engine.py``'s
rule)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.serving.engine import InferenceEngine as JEngine
from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.decoding import prepare_prompt
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.serving import server as tserver
from datatunerx_tpu_torch.serving.engine import InferenceEngine

KW = dict(template="vanilla", max_seq_len=256)
NEW = 12


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine("preset:debug", device="cpu", **KW)


def _near_tie(jeng, prompt, prefix, new) -> bool:
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, jeng.tokenizer.eos_token_id, 256, new)
    seq = ids + list(prefix)
    pos = positions + list(range(n, n + len(prefix)))
    msk = mask + [1] * len(prefix)
    logits, _ = jforward(jeng.params, jnp.asarray([seq]), jeng.cfg,
                         positions=jnp.asarray([pos]),
                         attention_mask=jnp.asarray([msk]),
                         compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1][:2]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
    return (top[0] - top[1]) <= 2 * ulp


def _assert_streams_agree(jeng, prompt, want, got, new):
    assert len(got) == len(want) or _near_tie(
        jeng, prompt, want[:min(len(got), len(want))], new)
    div = next((i for i in range(min(len(got), len(want)))
                if got[i] != want[i]), None)
    if div is not None:
        assert _near_tie(jeng, prompt, want[:div], new), div


PROMPTS = ("the quick brown fox", "hi", "long context " * 12)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_greedy_matches_jax_engine(export_dir, quant):
    """Unquantized and serve-time quantized (``quant_impl`` stays ``xla``:
    dequantize, then the plain product — no kernel on this path)."""
    jeng = JEngine(export_dir, quantization=quant, **KW)
    teng = InferenceEngine(export_dir, quantization=quant, device="cpu",
                           **KW)
    assert teng.cfg.quantization == quant
    assert teng.cfg.quant_impl == "xla"
    if quant:
        assert "quant" in teng.params["layers"]["q_proj"]
        assert "kernel" not in teng.params["layers"]["q_proj"]
    for text in PROMPTS:
        p = teng.tokenizer.encode(text)
        want = jeng.generate(p, max_new_tokens=NEW, stop_ids={-1})
        got = teng.generate(p, max_new_tokens=NEW, stop_ids={-1})
        assert len(got) == NEW
        _assert_streams_agree(jeng, p, want, got, NEW)


def _reference_greedy(engine, prompt_ids, max_new):
    """Stepwise Python-loop decode over an exact-length prompt."""
    cfg, params, tok = engine.cfg, engine.params, engine.tokenizer
    cache = init_cache(cfg, 1, len(prompt_ids) + max_new)
    with torch.inference_mode():
        logits, cache = forward(
            params, torch.tensor([prompt_ids]), cfg,
            positions=torch.arange(len(prompt_ids))[None], cache=cache,
            compute_dtype=torch.bfloat16)
        out, pos = [], len(prompt_ids)
        nxt = int(torch.argmax(logits[0, -1]))
        for _ in range(max_new):
            if nxt == tok.eos_token_id:
                break
            out.append(nxt)
            logits, cache = forward(
                params, torch.tensor([[nxt]]), cfg,
                positions=torch.tensor([[pos]]), cache=cache,
                compute_dtype=torch.bfloat16)
            nxt = int(torch.argmax(logits[0, -1]))
            pos += 1
    return out


def test_decode_loop_matches_stepwise(engine):
    prompt = engine.tokenizer.encode("the quick brown fox")
    # left-pad bucketing must not change greedy output vs exact-length decode
    assert engine.generate(prompt, max_new_tokens=12) == \
        _reference_greedy(engine, prompt, 12)


def test_stop_flag_is_read_every_few_tokens(engine):
    """A stop early in the loop ends it at the next check: the tokens are
    the unstopped stream's prefix, and at most STOP_CHECK forwards ran."""
    from datatunerx_tpu_torch.serving import engine as mod

    prompt = engine.tokenizer.encode("abc")
    full = engine.generate(prompt, max_new_tokens=40, stop_ids={-1})
    assert len(full) == 40
    calls = []
    real = mod.forward

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    mod.forward = counting
    try:
        stopped = engine.generate(prompt, max_new_tokens=40,
                                  stop_ids={full[2]})
    finally:
        mod.forward = real
    first = full.index(full[2])
    assert stopped == full[:first]
    assert len(calls) <= 1 + mod.STOP_CHECK  # the prefill + one window


def test_sampling_deterministic_per_seed(engine):
    prompt = engine.tokenizer.encode("hello")
    a = engine.generate(prompt, max_new_tokens=8, temperature=0.9, seed=7)
    b = engine.generate(prompt, max_new_tokens=8, temperature=0.9, seed=7)
    c = engine.generate(prompt, max_new_tokens=8, temperature=0.9, seed=8)
    assert a == b
    assert a != c or len(a) == 0


def test_chat_assembles_history_and_system(engine):
    msgs = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
        {"role": "assistant", "content": "hello"},
        {"role": "user", "content": "bye"},
    ]
    assert isinstance(engine.chat(msgs, max_new_tokens=4), str)


def test_max_tokens_cap(engine):
    prompt = engine.tokenizer.encode("x" * 10)
    assert len(engine.generate(prompt, max_new_tokens=3, stop_ids={-1})) == 3


def test_oversized_max_tokens_clamped(engine):
    """max_tokens >= max_seq_len degrades gracefully."""
    prompt = engine.tokenizer.encode("hello world " * 50)
    out = engine.generate(prompt, max_new_tokens=512, stop_ids={-1})
    assert 0 < len(out) <= 256


def test_long_prompt_truncated_not_overflowed(engine):
    prompt = engine.tokenizer.encode("x" * 1000)  # >> max_seq_len
    assert len(engine.generate(prompt, max_new_tokens=8,
                               stop_ids={-1})) == 8


def test_empty_prompt_no_nan(engine):
    out = engine.generate([], max_new_tokens=4, stop_ids={-1})
    assert len(out) == 4
    assert all(isinstance(t, int) and 0 <= t < engine.cfg.vocab_size
               for t in out)


def test_numpy_stop_ids_respected(engine):
    prompt = engine.tokenizer.encode("abc")
    full = engine.generate(prompt, max_new_tokens=8, stop_ids={-1})
    if full:  # stop on the first token the model actually produces
        assert engine.generate(prompt, max_new_tokens=8,
                               stop_ids={np.int64(full[0])}) == []


def test_concurrent_chat_requests(engine):
    """Parallel chat() calls (the HTTP server's threads): per-call caches,
    shared weights, grad mode entered on each caller's thread."""
    results, errors = [], []

    def worker(i):
        try:
            results.append(engine.chat(
                [{"role": "user", "content": f"msg {i}"}], max_new_tokens=4))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == 4


def test_concurrent_generate_and_perplexity_stress(engine):
    """More threads than cores, a short switch interval: every concurrent
    call returns what it returns alone (no state crosses calls)."""
    import os
    import sys

    tok = engine.tokenizer
    prompts = [tok.encode(f"stress probe {i}") for i in range(4)]
    alone = [engine.generate(p, max_new_tokens=6, stop_ids={-1})
             for p in prompts]
    ppl = engine.perplexity(prompts[0], alone[0])
    n = 2 * (os.cpu_count() or 4)
    results, errors = {}, []

    def worker(i):
        try:
            if i % 3 == 2:
                results[i] = engine.perplexity(prompts[0], alone[0])
            else:
                results[i] = engine.generate(prompts[i % 4], max_new_tokens=6,
                                             stop_ids={-1})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for i in range(n):
        assert results[i] == (ppl if i % 3 == 2 else alone[i % 4]), i


def test_checkpoint_path_and_cuda_default_refused(tmp_path):
    """A checkpoint_path that holds no checkpoint fails the engine (no
    fallback to the base model); the CUDA default fails without a card."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        InferenceEngine("preset:debug", checkpoint_path=str(tmp_path),
                        device="cpu", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine("preset:debug", **KW)


# ------------------------------------------------------------- the server

ARGS = ["--model_path", "preset:debug", "--template", "vanilla",
        "--max_seq_len", "256", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0"]


def _load(extra):
    """Run the server's async loader for ARGS + extra; returns (engine,
    error) once it settles."""
    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    args = tserver.parse_args(ARGS + extra)
    tserver.load_engine_async(
        args.model_path, template=args.template,
        max_seq_len=args.max_seq_len, quantization=args.quantization,
        slots=args.slots, kv_quant=args.kv_quant,
        prefix_cache=args.prefix_cache, kv_block_size=args.kv_block_size,
        kv_overcommit=args.kv_overcommit, paged_kernel=args.paged_kernel,
        sampling_epilogue=args.sampling_epilogue,
        device=args.device).join(120)
    out = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = saved
    return out


@pytest.mark.parametrize("extra, want", [
    (["--slots", "1"], ("InferenceEngine", None)),
    (["--quantization", "int8"], ("InferenceEngine", "int8")),
    (["--slots", "2", "--quantization", "int4"], ("InferenceEngine", "int4")),
    (["--slots", "2"], ("BatchedEngine", None)),
])
def test_server_chooses_the_engine(extra, want):
    eng, err = _load(extra)
    try:
        assert err is None, err
        assert (type(eng).__name__, eng.cfg.quantization) == want
    finally:
        eng.close()


@pytest.mark.parametrize("extra, flag", [
    (["--slots", "1", "--prefix_cache", "4"], "--prefix_cache"),
    (["--quantization", "int8", "--kv_quant", "int8"], "--kv_quant"),
    (["--slots", "1", "--kv_block_size", "16"], "--kv_block_size"),
    (["--slots", "1", "--kv_block_size", "16", "--kv_overcommit", "on"],
     "--kv_block_size"),
    (["--quantization", "int4", "--sampling_epilogue", "on"],
     "--sampling_epilogue"),
])
def test_batched_only_flags_refused_on_the_single_engine(extra, flag):
    eng, err = _load(extra)
    assert eng is None
    assert err == (f"{flag} requires the batched engine "
                   "(--slots > 1, no --quantization)")


def test_single_engine_serves_chat_and_stream():
    """``/chat/completions`` through the single-request engine, JSON and
    SSE (one terminal delta, as the JAX server streams it)."""
    import http.client
    import json

    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    srv = tserver.start(tserver.parse_args(ARGS + ["--slots", "1"]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        deadline = time.time() + 120
        while tserver.STATE.engine is None and time.time() < deadline:
            assert tserver.STATE.error is None, tserver.STATE.error
            time.sleep(0.05)
        port = srv.server_address[1]
        chat = {"messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 6, "model": "anything"}
        for stream in (False, True):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/chat/completions",
                         body=json.dumps(dict(chat, stream=stream)),
                         headers={"Content-Type": "application/json",
                                  "X-DTX-Trace-Id": "t1"})
            resp = conn.getresponse()
            data = resp.read().decode()
            conn.close()
            assert resp.status == 200, data
            if stream:
                assert data.rstrip().endswith("data: [DONE]")
            else:
                body = json.loads(data)
                assert isinstance(
                    body["choices"][0]["message"]["content"], str)
                assert body["usage"]["prompt_tokens"] > 0
    finally:
        srv.shutdown()
        srv.server_close()
        if tserver.STATE.engine is not None:
            tserver.STATE.engine.close()
        tserver.STATE.engine, tserver.STATE.error = saved


@pytest.fixture(scope="module")
def peaked_export(tmp_path_factory):
    """preset:debug with its final norm scaled by 64, so sampled steps have
    a head (random weights give near-flat distributions, where a bf16
    rounding placed differently by the two frameworks moves any draw)."""
    cfg, params, _ = jload("preset:debug")
    params = dict(params)
    params["norm"] = {"scale": params["norm"]["scale"] * 64.0}
    d = tmp_path_factory.mktemp("peaked_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


@pytest.mark.parametrize("temp,top_p,seed", [(0.8, 1.0, 7), (0.8, 0.9, 8),
                                             (1.3, 1.0, 2**31 + 3)])
def test_sampled_stream_matches_jax_engine(peaked_export, temp, top_p, seed):
    """The same seed draws the same tokens as the JAX engine: the port
    splits the reference's threefry key once a token (``ops/prng.py``) and
    draws ``jax.random.categorical`` over the filtered sorted logits. A
    stream may part only where the logits explain it
    (``test_torch_sampling._parting_explained``), reported."""
    jeng = JEngine(peaked_export, **KW)
    eng = InferenceEngine(peaked_export, device="cpu", **KW)
    prompt = eng.tokenizer.encode("single engine prompt")
    want = jeng.generate(prompt, max_new_tokens=NEW, temperature=temp,
                         top_p=top_p, seed=seed)
    got = eng.generate(prompt, max_new_tokens=NEW, temperature=temp,
                       top_p=top_p, seed=seed)
    if got != want:
        # a stream parts only at a near-tie of the step's draw
        from test_torch_sampling import _parting_explained

        n = next(j for j in range(min(len(got), len(want)))
                 if got[j] != want[j])
        assert _parting_explained(peaked_export, prompt, want[:n], got[n],
                                  temp, top_p, seed), f"parts at step {n}"
        print(f"parts at step {n} (explained by the logits)")
    greedy = eng.generate(prompt, max_new_tokens=NEW)
    assert got != greedy  # the draw really samples
