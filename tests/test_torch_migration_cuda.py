"""Session migration on the card: the checks of ``chip_smoke.py``'s
3-migrate phase that fit a unit test, over ``preset:debug`` engines on the
paged kernels (K7 decode, K8 prefill chunks, K9 sampling).

- A bf16 session exported mid-decode resumes on a second engine of the same
  shape bit for bit: its greedy and seeded-sampled streams equal the
  undisturbed ones, and the destination's K7 and K9 launches are exactly
  what its scheduler trace says it ran.
- A session exported mid-chunked-prefill resumes on the destination, which
  runs only the prompt tail through K8 (launches equal to the trace's
  chunks times the layers).
- A prefix entry moved between the engines admits with zero prefill chunks
  and zero K8 launches.

They need an NVIDIA GPU and skip elsewhere; run them with the other card
tests: ``python -m pytest --noconftest -m cuda
tests/test_torch_migration_cuda.py``."""

import json
import time

import pytest
import torch

from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
from datatunerx_tpu_torch.ops import cuda_sampling as cs

pytestmark = pytest.mark.cuda

MODEL = "preset:debug"
KW = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
          kv_block_size=16, paged_kernel="on", sampling_epilogue="on")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _engine(cuda, **extra):
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    return BatchedEngine(MODEL, device=cuda, **dict(KW, **extra))


def _slowed(eng, attr, delay=0.02):
    orig = getattr(eng, attr)

    def slow(*a, **k):
        time.sleep(delay)
        return orig(*a, **k)

    setattr(eng, attr, slow)
    return lambda: setattr(eng, attr, orig)


def _zero():
    cpa.paged_decode_attention.launches = 0
    cpa.paged_multitoken_attention.launches = 0
    cs.kernel_sample.launches = 0


def _expected(eng, mark):
    """K7, K8 and K9 launches the trace since ``mark`` implies."""
    trace = list(eng.sched_trace)[mark:]
    steps = sum(e[1] for e in trace if e[0] == "decode")
    chunks = sum(1 for e in trace if e[0] == "prefill")
    L = eng.cfg.num_layers
    return L * steps, L * chunks, steps


def _launched():
    return (cpa.paged_decode_attention.launches,
            cpa.paged_multitoken_attention.launches,
            cs.kernel_sample.launches)


def _import(dst, payload):
    meta = dst.import_session(json.loads(json.dumps(payload)))
    handle = meta.pop("_request")
    assert handle.done.wait(300) and handle.error is None, handle.error
    return handle, meta


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "seed": 5}],
                         ids=["greedy", "sampled"])
def test_bf16_resume_is_bit_exact_on_the_card(cuda, sampling):
    src, dst = _engine(cuda), _engine(cuda)
    try:
        prompt = src.tokenizer.encode("the quick brown fox jumps over " * 4)
        want = src.generate(prompt, max_new_tokens=40, **sampling)
        restore = _slowed(src, "_decode_chunk")
        try:
            req = src.submit(prompt, max_new_tokens=40, **sampling)
            while len(req.tokens) < 8:
                time.sleep(0.002)
            doc = src.export_sessions()
        finally:
            restore()
        assert req.done.wait(30) and "session migrated" in req.error
        payload = doc["sessions"][0]
        assert payload["kv"]["wire"] == "bf16"
        mark = len(dst.sched_trace)
        _zero()
        handle, _ = _import(dst, payload)
        assert handle.tokens == want
        k7, k8, k9 = _expected(dst, mark)
        assert _launched() == (k7, 0, k9) and k7 > 0 and k8 == 0
    finally:
        src.close()
        dst.close()


def test_mid_prefill_tail_runs_on_k8(cuda):
    src = _engine(cuda, prefill_chunk=64, prefill_token_budget=64)
    dst = _engine(cuda, prefill_chunk=64, prefill_token_budget=64)
    try:
        prompt = src.tokenizer.encode("chunked prefill handoff target " * 30)
        want = src.generate(prompt, max_new_tokens=16)
        restore = _slowed(src, "_prefill_chunk_fn", delay=0.05)
        try:
            req = src.submit(prompt, max_new_tokens=16)
            deadline = time.monotonic() + 60
            while not any(0 < st["done"] < st["plen"]
                          for st in list(src._pending.values())):
                assert time.monotonic() < deadline
                time.sleep(0.002)
            doc = src.export_sessions(include_prefill=True)
        finally:
            restore()
        assert req.done.wait(30) and "session migrated" in req.error
        payload = doc["sessions"][0]
        tail = len(payload["pending"]["ids"])
        mark = len(dst.sched_trace)
        _zero()
        handle, meta = _import(dst, payload)
        assert meta["prefill"] is True
        assert handle.tokens == want
        trace = list(dst.sched_trace)[mark:]
        assert sum(e[2] for e in trace if e[0] == "prefill") == tail
        k7, k8, k9 = _expected(dst, mark)
        assert k8 > 0 and _launched() == (k7, k8, k9)
    finally:
        src.close()
        dst.close()


def test_prefix_import_admits_with_zero_chunks(cuda):
    src, dst = _engine(cuda, prefix_cache=4), _engine(cuda, prefix_cache=4)
    try:
        prompt = src.tokenizer.encode("shared system preamble " * 10)
        want = src.generate(prompt, max_new_tokens=16)
        entries = src.export_prefix_entries()["entries"]
        assert len(entries) == 1
        assert dst.import_prefix_entry(
            json.loads(json.dumps(entries[0])))["imported"]
        mark = len(dst.sched_trace)
        _zero()
        assert dst.generate(prompt, max_new_tokens=16) == want
        k7, k8, k9 = _expected(dst, mark)
        assert k8 == 0 and _launched() == (k7, 0, k9)
        assert any(e[0] == "admit" and e[3] == "cache"
                   for e in list(dst.sched_trace)[mark:])
    finally:
        src.close()
        dst.close()
