"""Dataset ingest and deterministic batch iteration (the port of
``datatunerx_tpu/data/loader.py``: ``CsvDataset`` and ``BatchIterator``).

A plain CSV/JSONL reader (local paths; object stores and ``--streaming``
are not ported yet, ROADMAP Queue 1 item 11) and a seedable iterator whose
per-epoch permutation is numpy's ``default_rng(seed + epoch)``, so it yields
the reference's batches array for array.
"""

from __future__ import annotations

import csv
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from datatunerx_tpu_torch.data.preprocess import (
    pack_to_block,
    pad_to_block,
    preprocess_records,
)
from datatunerx_tpu_torch.data.templates import Template, get_template
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.utils import storage


class CsvDataset:
    """Instruction/response records from a .csv, .jsonl or .json file.
    ``columns`` maps source column names to the canonical ones
    (``instruction``, ``response``, optional ``query``/``history``/
    ``system``) — the Dataset CR feature mapping."""

    def __init__(self, path: str, columns: Optional[Dict[str, str]] = None):
        self.path = path
        self.columns = columns
        self.records = self._load(path)

    @staticmethod
    def _load(path: str) -> List[Dict[str, Any]]:
        if not storage.exists(path):
            raise FileNotFoundError(path)
        if path.endswith(".jsonl") or path.endswith(".json"):
            text = storage.read_text(path).strip()
            if text.startswith("["):
                return json.loads(text)
            return [json.loads(line) for line in text.splitlines()
                    if line.strip()]
        with open(path, "r", newline="") as f:
            return list(csv.DictReader(f))

    def encode(self, template: Template | str, tokenizer,
               cutoff_len: int = 1024) -> List[Dict[str, List[int]]]:
        if isinstance(template, str):
            template = get_template(template, tokenizer)
        return preprocess_records(self.records, template, tokenizer,
                                  cutoff_len=cutoff_len,
                                  columns=self.columns)


class BatchIterator:
    """Deterministic shuffled epochs over encoded examples → fixed-shape
    batches: ``global_batch`` examples per step padded (or packed) to
    ``block_size``; ``grad_accum`` reshapes to [A, mb, T]; the trailing
    partial batch is dropped (or, with ``drop_remainder=False``, padded with
    empty rows whose labels are all IGNORE)."""

    def __init__(
        self,
        examples: Sequence[Dict[str, List[int]]],
        *,
        global_batch: int,
        block_size: int,
        pad_id: int = 0,
        grad_accum: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        pack: bool = False,
        drop_remainder: bool = True,
    ):
        if global_batch % max(grad_accum, 1) != 0:
            raise ValueError("global_batch must be divisible by grad_accum")
        self.drop_remainder = drop_remainder
        self.examples = list(examples)
        self.global_batch = global_batch
        self.block_size = block_size
        self.pad_id = pad_id
        self.grad_accum = max(grad_accum, 1)
        self.shuffle = shuffle
        self.seed = seed
        self.pack = pack
        if pack:
            # pack the whole dataset once; epochs shuffle the packed rows
            self._rows = pack_to_block(self.examples, block_size, pad_id)
            self._n_rows = self._rows["input_ids"].shape[0]
        else:
            self._rows = None
            self._n_rows = len(self.examples)

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self._n_rows // self.global_batch
        return -(-self._n_rows // self.global_batch)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self._n_rows)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(
                order)
        for s in range(self.steps_per_epoch()):
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            if self.pack:
                batch = {k: v[idx] for k, v in self._rows.items()}
                if len(idx) < self.global_batch:
                    batch = _pad_rows(batch, self.global_batch)
            else:
                exs = [self.examples[i] for i in idx]
                exs += ([{"input_ids": [], "labels": []}]
                        * (self.global_batch - len(exs)))
                batch = pad_to_block(exs, self.block_size, self.pad_id)
            if self.grad_accum > 1:
                batch = {k: v.reshape(self.grad_accum, -1, *v.shape[1:])
                         for k, v in batch.items()}
            yield batch

    def __iter__(self):
        return self.epoch(0)


def _pad_rows(batch: Dict[str, np.ndarray],
              target_rows: int) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in batch.items():
        pad_val = IGNORE_INDEX if k == "labels" else 0
        extra = np.full((target_rows - v.shape[0],) + v.shape[1:], pad_val,
                        v.dtype)
        out[k] = np.concatenate([v, extra], axis=0)
    return out
