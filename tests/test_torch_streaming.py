"""The port's streaming ingest (``--streaming``) against the JAX package's
on the CPU: the record stream (csv, jsonl, a JSON array, blank lines),
shuffle-buffered batches equal array for array to the reference's for the
same seed, buffer and grad-accum (sft and pt, read-ahead depths 1 to 8),
the per-thread tokenizer copies, and ``ReadAheadIterator`` (order, errors,
an early exit stops its thread): twins of the reference's
``tests/test_streaming.py``."""

import json
import threading
import time

import numpy as np
import pytest

from datatunerx_tpu.data.loader import StreamingBatchIterator as JStreamIt
from datatunerx_tpu.data.loader import StreamingCsvDataset as JStream
from datatunerx_tpu.data.templates import get_template as jtemplate
from datatunerx_tpu_torch.data import loader
from datatunerx_tpu_torch.data.loader import (
    StreamingBatchIterator,
    StreamingCsvDataset,
)
from datatunerx_tpu_torch.data.prefetch import ReadAheadIterator
from datatunerx_tpu_torch.data.templates import get_template
from tests.fake_tokenizer import FakeTokenizer


@pytest.fixture(scope="module")
def tok():
    return FakeTokenizer()


def _write_jsonl(path, n, blank=False):
    with open(path, "w") as f:
        if blank:
            f.write("\n\n")
        for i in range(n):
            f.write(json.dumps({"instruction": f"q {i}",
                                "response": f"answer {i} " * (1 + i % 4)})
                    + "\n")
    return str(path)


def test_record_stream_matches_reference(tmp_path):
    csv_path = tmp_path / "d.csv"
    with open(csv_path, "w") as f:
        f.write("instruction,response\n")
        f.writelines(f"q {i},a {i}\n" for i in range(6))
    arr = tmp_path / "a.json"
    arr.write_text(json.dumps([{"instruction": "x", "response": "y"}] * 3))
    for path in (_write_jsonl(tmp_path / "d.jsonl", 10, blank=True),
                 str(csv_path), str(arr)):
        got = list(StreamingCsvDataset(path))
        assert got == list(JStream(path)) and got
    it = iter(StreamingCsvDataset(str(csv_path)))
    assert next(it)["instruction"] == "q 0"  # lazy: one record at a time
    with pytest.raises(FileNotFoundError):
        StreamingCsvDataset(str(tmp_path / "missing.jsonl"))


@pytest.mark.parametrize("stage,accum,read_ahead",
                         [("sft", 1, 1), ("sft", 2, 8), ("pt", 1, 4)])
def test_streaming_batches_match_reference(tmp_path, tok, monkeypatch, stage,
                                           accum, read_ahead):
    """Two epochs (two shuffle orders) of full batches only, equal arrays,
    at read-ahead depths from one record up."""
    monkeypatch.setattr(loader, "READ_AHEAD", read_ahead)
    path = _write_jsonl(tmp_path / "d.jsonl", 37)
    kw = dict(global_batch=4, block_size=32, pad_id=0, grad_accum=accum,
              buffer_size=8, seed=5, stage=stage)
    for epoch in (0, 1):
        got = list(StreamingBatchIterator(
            StreamingCsvDataset(path), get_template("vanilla", tok), tok,
            **kw).epoch(epoch))
        want = list(JStreamIt(JStream(path), jtemplate("vanilla", tok), tok,
                              read_ahead=read_ahead, **kw).epoch(epoch))
        assert len(got) == len(want) == 37 // 4
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["input_ids"].shape == ((accum, 4 // accum, 32)
                                         if accum > 1 else (4, 32))


def test_thread_safe_encoding_copies_per_thread(tmp_path, tok):
    path = _write_jsonl(tmp_path / "d.jsonl", 8)
    it = StreamingBatchIterator(
        StreamingCsvDataset(path), get_template("vanilla", tok), tok,
        global_batch=2, block_size=32, buffer_size=2)
    assert it.ensure_thread_safe_encoding() is True
    assert it.ensure_thread_safe_encoding() is True  # idempotent
    assert it._thread_tokenizer() is not tok
    assert it._thread_tokenizer() is it._thread_tokenizer()
    seen = {}

    def worker(name):
        seen[name] = it._thread_tokenizer()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen[0] is not seen[1] and tok not in seen.values()
    assert [b["input_ids"].shape[0] for b in it.epoch(0)] == [2] * 4

    class Uncopyable(type(tok)):
        def __deepcopy__(self, memo):
            raise RuntimeError("not copyable")

    bad = Uncopyable()
    it = StreamingBatchIterator(
        StreamingCsvDataset(path), get_template("vanilla", bad), bad,
        global_batch=2, block_size=32, buffer_size=2)
    assert it.ensure_thread_safe_encoding() is False
    assert it._thread_tokenizer() is bad


def test_read_ahead_keeps_order_and_reraises():
    assert list(ReadAheadIterator(iter(range(100)), depth=4)) == list(
        range(100))

    def boom():
        yield 1
        yield 2
        raise RuntimeError("read died")

    it = ReadAheadIterator(boom(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="read died"):
        next(it)
    with pytest.raises(ValueError):
        ReadAheadIterator(iter(()), depth=0)


def test_read_ahead_early_exit_stops_its_thread(tmp_path, tok, monkeypatch):
    monkeypatch.setattr(loader, "READ_AHEAD", 2)
    path = _write_jsonl(tmp_path / "d.jsonl", 64)
    it = StreamingBatchIterator(
        StreamingCsvDataset(path), get_template("vanilla", tok), tok,
        global_batch=4, block_size=64, buffer_size=4)
    gen = it.epoch(0)
    next(gen)
    gen.close()  # an abandoned epoch (max_steps) closes the reader
    for _ in range(50):
        if not any(t.name == "dtx-readahead" and t.is_alive()
                   for t in threading.enumerate()):
            break
        time.sleep(0.1)
    else:
        pytest.fail("the read-ahead thread outlived its epoch")
