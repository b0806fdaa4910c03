"""Dataset ingest and deterministic batch iteration (the port of
``datatunerx_tpu/data/loader.py``).

- ``CsvDataset``: a plain CSV/JSONL reader over a local path or an
  object-store URI (``utils/storage``).
- ``BatchIterator``: a seedable iterator whose per-epoch permutation is
  numpy's ``default_rng(seed + epoch)``, so it yields the reference's
  batches array for array; ``PreferenceBatchIterator`` runs two of them
  with one seed over chosen and rejected sides (DPO/RM).
- ``StreamingCsvDataset`` / ``StreamingBatchIterator`` (``--streaming``):
  records read line by line (a raw-record read-ahead thread,
  ``data/prefetch.ReadAheadIterator``), encoded on the fly and shuffled
  through a bounded reservoir with the reference's draws, so a seed gives
  its batches too.
- ``PromptBatchIterator``: left-padded prompt batches for PPO rollouts,
  with ``BatchIterator``'s shuffle.
"""

from __future__ import annotations

import copy
import csv
import json
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from datatunerx_tpu_torch.data.prefetch import ReadAheadIterator
from datatunerx_tpu_torch.data.preprocess import (
    pack_to_block,
    pad_to_block,
    preprocess_pretrain_records,
    preprocess_records,
)
from datatunerx_tpu_torch.data.templates import Template, get_template
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.utils import storage

READ_AHEAD = 64  # raw records a streaming epoch's reader thread fetches ahead


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
        with storage.open_uri(path, "r") as f:
            return list(csv.DictReader(f))

    def encode(self, template: Template | str, tokenizer,
               cutoff_len: int = 1024) -> List[Dict[str, List[int]]]:
        if isinstance(template, str):
            template = get_template(template, tokenizer)
        return preprocess_records(self.records, template, tokenizer,
                                  cutoff_len=cutoff_len,
                                  columns=self.columns)


class StreamingCsvDataset:
    """Record stream over a .csv/.jsonl file without reading it whole. A
    JSON array cannot stream: it falls back to one parse."""

    def __init__(self, path: str, columns: Optional[Dict[str, str]] = None):
        if not storage.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.columns = columns

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.path.endswith((".jsonl", ".json")):
            with storage.open_uri(self.path, "r") as f:
                # blank lines before the first record are skipped, as
                # CsvDataset strips the whole text
                first = f.readline()
                while first and not first.strip():
                    first = f.readline()
                if first.lstrip().startswith("["):
                    yield from json.loads(first + f.read())
                    return
                line = first
                while line:
                    if line.strip():
                        yield json.loads(line.strip())
                    line = f.readline()
        else:
            with storage.open_uri(self.path, "r") as f:
                yield from csv.DictReader(f)


class StreamingBatchIterator:
    """Shuffle-buffered streaming batches (tf.data ``shuffle(buffer)``
    semantics): records are encoded on the fly, held in a reservoir of
    ``buffer_size``, and emitted as fixed-shape [global_batch, block]
    batches; the trailing partial batch is dropped. Deterministic per
    (seed, epoch): the reservoir's draws are the reference's. SFT and pt
    only. ``host_id``/``num_hosts`` slice each batch as ``BatchIterator``
    does."""

    def __init__(
        self,
        dataset: StreamingCsvDataset,
        template: Template,
        tokenizer,
        *,
        global_batch: int,
        block_size: int,
        cutoff_len: Optional[int] = None,
        pad_id: int = 0,
        grad_accum: int = 1,
        buffer_size: int = 2048,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        stage: str = "sft",  # sft = templated pairs; pt = plain LM
    ):
        if global_batch % max(grad_accum, 1) != 0:
            raise ValueError("global_batch must be divisible by grad_accum")
        if (global_batch // max(grad_accum, 1)) % num_hosts != 0:
            raise ValueError("per-step batch must be divisible by num_hosts")
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.dataset = dataset
        self.template = template
        self.tokenizer = tokenizer
        self.global_batch = global_batch
        self.block_size = block_size
        self.cutoff_len = cutoff_len or block_size
        self.pad_id = pad_id
        self.grad_accum = max(grad_accum, 1)
        self.buffer_size = max(buffer_size, global_batch)
        self.seed = seed
        self.stage = stage
        self._tls = threading.local()
        self._clone_encoders = False

    def steps_per_epoch(self) -> int:
        return -1  # unknown without a full pass: callers use max_steps

    def ensure_thread_safe_encoding(self) -> bool:
        """Give each encoding thread its own copy of the tokenizer, so this
        iterator can encode in a prefetch worker while another thread
        (in-training generative eval) encodes with the original. False,
        with encoding unchanged, when the tokenizer cannot be copied: the
        caller then keeps the pipeline synchronous."""
        if self._clone_encoders:
            return True
        try:
            copy.deepcopy(self.tokenizer)
        except Exception:  # noqa: BLE001 — not copyable: caller stays sync
            return False
        self._clone_encoders = True
        return True

    def _thread_tokenizer(self):
        if not self._clone_encoders:
            return self.tokenizer
        tok = getattr(self._tls, "tokenizer", None)
        if tok is None:
            tok = self._tls.tokenizer = copy.deepcopy(self.tokenizer)
        return tok

    def _encoded(self) -> Iterator[Dict[str, List[int]]]:
        tokenizer = self._thread_tokenizer()  # one epoch runs on one thread
        reader = ReadAheadIterator(self.dataset, depth=READ_AHEAD)
        try:
            for rec in reader:
                if self.stage == "pt":
                    out = preprocess_pretrain_records(
                        [rec], tokenizer, cutoff_len=self.cutoff_len,
                        columns=self.dataset.columns)
                else:
                    out = preprocess_records(
                        [rec], self.template, tokenizer,
                        cutoff_len=self.cutoff_len,
                        columns=self.dataset.columns)
                if out:
                    yield out[0]
        finally:
            # an early exit (max_steps) stops the reader thread
            reader.close()

    def _emit(self, exs):
        batch = _host_slice(pad_to_block(exs, self.block_size, self.pad_id),
                            self.host_id, self.num_hosts)
        if self.grad_accum > 1:
            batch = {k: v.reshape(self.grad_accum, -1, *v.shape[1:])
                     for k, v in batch.items()}
        return batch

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + epoch)
        buf: List[Dict[str, List[int]]] = []
        pending: List[Dict[str, List[int]]] = []
        for ex in self._encoded():
            buf.append(ex)
            if len(buf) < self.buffer_size:
                continue
            pending.append(buf.pop(int(rng.integers(len(buf)))))
            if len(pending) == self.global_batch:
                yield self._emit(pending)
                pending = []
        # drain the reservoir down to full batches only
        rng.shuffle(buf)
        tail = pending + buf
        for s in range(len(tail) // self.global_batch):
            yield self._emit(tail[s * self.global_batch:
                                  (s + 1) * self.global_batch])

    def __iter__(self):
        return self.epoch(0)


class BatchIterator:
    """Deterministic shuffled epochs over encoded examples → fixed-shape
    batches: ``global_batch`` examples per step padded (or packed) to
    ``block_size``; ``grad_accum`` reshapes to [A, mb, T]; the trailing
    partial batch is dropped (or, with ``drop_remainder=False``, padded with
    empty rows whose labels are all IGNORE). ``host_id``/``num_hosts``
    slice the global batch for a multi-process run (every process draws
    the same permutation from the seed and keeps rows ``[host_id · per,
    (host_id + 1) · per)`` before the grad-accum reshape, as the
    reference slices them); the trainer CLI passes a rank's data-parallel
    index and size."""

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
        host_id: int = 0,
        num_hosts: int = 1,
        drop_remainder: bool = True,
    ):
        if global_batch % max(grad_accum, 1) != 0:
            raise ValueError("global_batch must be divisible by grad_accum")
        if (global_batch // max(grad_accum, 1)) % num_hosts != 0:
            raise ValueError("per-step batch must be divisible by num_hosts")
        self.host_id = host_id
        self.num_hosts = num_hosts
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
            batch = _host_slice(batch, self.host_id, self.num_hosts)
            if self.grad_accum > 1:
                batch = {k: v.reshape(self.grad_accum, -1, *v.shape[1:])
                         for k, v in batch.items()}
            yield batch

    def __iter__(self):
        return self.epoch(0)


def _host_slice(batch: Dict[str, np.ndarray], host_id: int,
                num_hosts: int) -> Dict[str, np.ndarray]:
    """Rows ``[host_id · per, (host_id + 1) · per)`` of a global batch."""
    if num_hosts == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    per = B // num_hosts
    return {k: v[host_id * per:(host_id + 1) * per] for k, v in batch.items()}


class PreferenceBatchIterator:
    """Preference-pair batches (DPO/RM): two ``BatchIterator``s with the
    same seed over equal-length chosen and rejected lists, so their
    permutations agree and pairs stay aligned. Packing would cross pair
    boundaries, so it is ignored."""

    def __init__(self, examples: Sequence[Dict[str, List[int]]], **kw):
        kw.pop("pack", None)
        chosen = [{"input_ids": e["chosen_ids"], "labels": e["chosen_labels"]}
                  for e in examples]
        rejected = [{"input_ids": e["rejected_ids"],
                     "labels": e["rejected_labels"]} for e in examples]
        self._c = BatchIterator(chosen, **kw)
        self._r = BatchIterator(rejected, **kw)

    def steps_per_epoch(self) -> int:
        return self._c.steps_per_epoch()

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for bc, br in zip(self._c.epoch(epoch), self._r.epoch(epoch)):
            yield {"chosen_ids": bc["input_ids"],
                   "chosen_labels": bc["labels"],
                   "rejected_ids": br["input_ids"],
                   "rejected_labels": br["labels"]}

    def __iter__(self):
        return self.epoch(0)


class PromptBatchIterator:
    """Prompt-only batches for PPO rollouts (``training/ppo.py``):
    LEFT-padded ``prompt_ids`` [B, block] and ``prompt_mask``, real tokens
    at the end (the generation convention). ``BatchIterator``'s contract:
    a ``default_rng(seed + epoch)`` permutation, host slicing (host
    ``host_id`` of ``num_hosts`` gets its contiguous rows of each global
    batch), static shapes, the trailing partial batch dropped."""

    def __init__(
        self,
        examples: Sequence[Dict[str, List[int]]],
        *,
        global_batch: int,
        block_size: int,
        pad_id: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        **_ignored,  # grad_accum/pack: the reference's contract, unused
    ):
        if global_batch % num_hosts != 0:
            raise ValueError("global_batch must be divisible by num_hosts")
        self.examples = [e for e in examples if e.get("prompt_ids")]
        self.global_batch = global_batch
        self.block_size = block_size
        self.pad_id = pad_id
        self.shuffle = shuffle
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts

    def steps_per_epoch(self) -> int:
        return len(self.examples) // self.global_batch

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.examples))
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(
                order)
        T = self.block_size
        for s in range(self.steps_per_epoch()):
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            ids = np.full((len(idx), T), self.pad_id, np.int32)
            mask = np.zeros((len(idx), T), np.int32)
            for r, i in enumerate(idx):
                p = self.examples[i]["prompt_ids"][-T:]
                ids[r, T - len(p):] = p
                mask[r, T - len(p):] = 1
            batch = {"prompt_ids": ids, "prompt_mask": mask}
            if self.num_hosts > 1:
                per = self.global_batch // self.num_hosts
                lo = self.host_id * per
                batch = {k: v[lo:lo + per] for k, v in batch.items()}
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
