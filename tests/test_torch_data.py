"""The port's data path against the JAX package's: the same CSV, template
and tokenizer give the same encoded examples, and ``BatchIterator`` yields
array-equal batches (padded and packed, grad-accum reshaped, the eval
iterator's padded tail) for the same seed. Exact equality: both are integer
numpy pipelines."""

import csv

import numpy as np
import pytest

from datatunerx_tpu.data import BatchIterator as JBatchIterator
from datatunerx_tpu.data import CsvDataset as JCsvDataset
from datatunerx_tpu.data import get_template as jget_template
from datatunerx_tpu.utils.simple_tokenizer import SimpleTokenizer as JTok
from datatunerx_tpu_torch.data.loader import BatchIterator, CsvDataset
from datatunerx_tpu_torch.data.templates import get_template
from datatunerx_tpu_torch.utils.simple_tokenizer import SimpleTokenizer


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "train.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["q", "a", "query"])
        for i in range(40):
            w.writerow([f"question {i} " + "word " * int(rng.integers(1, 12)),
                        "answer " * int(rng.integers(1, 15)),
                        "extra" if i % 5 == 0 else ""])
        w.writerow(["", "skipped: empty instruction", ""])
    return str(path)


COLUMNS = {"q": "instruction", "a": "response"}


def _encoded(csv_path, template, cutoff):
    jex = JCsvDataset(csv_path, columns=COLUMNS).encode(
        jget_template(template, JTok()), JTok(), cutoff_len=cutoff)
    tex = CsvDataset(csv_path, columns=COLUMNS).encode(
        get_template(template, SimpleTokenizer()), SimpleTokenizer(),
        cutoff_len=cutoff)
    return jex, tex


@pytest.mark.parametrize("template", ["llama2", "vanilla", "alpaca"])
def test_encoding_matches_reference(csv_path, template):
    jex, tex = _encoded(csv_path, template, 96)
    assert len(tex) == len(jex) == 40
    assert tex == jex


@pytest.mark.parametrize("pack,accum", [(False, 1), (True, 1), (True, 2),
                                        (False, 2)])
def test_batches_are_array_equal(csv_path, pack, accum):
    jex, tex = _encoded(csv_path, "vanilla", 64)
    kw = dict(global_batch=4, block_size=128, pad_id=0, grad_accum=accum,
              seed=7, pack=pack)
    jit, tit = JBatchIterator(jex, **kw), BatchIterator(tex, **kw)
    assert tit.steps_per_epoch() == jit.steps_per_epoch() > 0
    for epoch in (0, 1):
        jb, tb = list(jit.epoch(epoch)), list(tit.epoch(epoch))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(b[k], a[k])
    if pack:
        seg = next(tit.epoch(0))["segment_ids"]
        assert seg.max() >= 2  # rows really hold several examples


def test_eval_tail_is_padded_like_the_reference(csv_path):
    jex, tex = _encoded(csv_path, "vanilla", 64)
    kw = dict(global_batch=6, block_size=64, shuffle=False,
              drop_remainder=False)
    jb = list(JBatchIterator(jex, **kw).epoch(0))
    tb = list(BatchIterator(tex, **kw).epoch(0))
    assert len(tb) == len(jb) == 7
    for a, b in zip(jb, tb):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
