"""Supervised preprocessing (SFT, pt, DPO/RM preference pairs, PPO
prompts): encode, prompt-mask, fixed-shape padding and greedy packing
(the port of ``datatunerx_tpu/data/preprocess.py``, without its native
C++ fill: the loops below are the reference's own fallback, and the
tests hold the batches equal).

- column-mapped records with ``instruction``/``response`` (+ optional
  ``query`` appended to the instruction with a newline, ``history``,
  ``system``); records with an empty or non-string field are skipped;
- per-turn proportional truncation to cutoff_len, the prompt masked to
  IGNORE_INDEX; efficient_eos templates carry eos as the first label of a
  later turn's source span and append a final eos;
- batches padded to a static block_size, or packed first-fit with
  segment_ids and per-segment positions.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from datatunerx_tpu_torch.data.templates import Template
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX


def map_columns(record: Dict[str, Any],
                columns: Optional[Dict[str, str]]) -> Dict[str, Any]:
    """Rename record keys per the Dataset CR feature map."""
    if not columns:
        return record
    return {columns.get(k, k): v for k, v in record.items()}


def encode_supervised_example(
    template: Template,
    tokenizer,
    query: str,
    response: str,
    history: Optional[List[Tuple[str, str]]] = None,
    system: Optional[str] = None,
    cutoff_len: int = 1024,
) -> Tuple[List[int], List[int]]:
    """Returns (input_ids, labels)."""
    input_ids: List[int] = []
    labels: List[int] = []
    for turn_idx, (source_ids, target_ids) in enumerate(
        template.encode_turns(tokenizer, query, response, history, system)
    ):
        total = len(source_ids) + len(target_ids)
        max_src = int(cutoff_len * (len(source_ids) / total)) if total else 0
        max_tgt = int(cutoff_len * (len(target_ids) / total)) if total else 0
        if len(source_ids) > max_src:
            source_ids = source_ids[:max_src]
        if len(target_ids) > max_tgt:
            target_ids = target_ids[:max_tgt]

        if turn_idx != 0 and template.efficient_eos:
            source_mask = ([tokenizer.eos_token_id]
                           + [IGNORE_INDEX] * (len(source_ids) - 1))
        else:
            source_mask = [IGNORE_INDEX] * len(source_ids)

        input_ids += source_ids + target_ids
        labels += source_mask + target_ids

    if template.efficient_eos:
        input_ids += [tokenizer.eos_token_id]
        labels += [tokenizer.eos_token_id]

    return input_ids[:cutoff_len], labels[:cutoff_len]


def preprocess_records(
    records: Iterable[Dict[str, Any]],
    template: Template,
    tokenizer,
    cutoff_len: int = 1024,
    columns: Optional[Dict[str, str]] = None,
) -> List[Dict[str, List[int]]]:
    out = []
    for rec in records:
        rec = map_columns(rec, columns)
        query, response = rec.get("instruction"), rec.get("response")
        if not (isinstance(query, str) and isinstance(response, str)
                and query != "" and response != ""):
            continue
        if rec.get("query"):
            query = query + "\n" + rec["query"]
        ids, labels = encode_supervised_example(
            template, tokenizer, query, response,
            history=rec.get("history"), system=rec.get("system"),
            cutoff_len=cutoff_len,
        )
        out.append({"input_ids": ids, "labels": labels,
                    "attention_mask": [1] * len(ids)})
    return out


def preprocess_preference_records(
    records: Iterable[Dict[str, Any]],
    template: Template,
    tokenizer,
    cutoff_len: int = 1024,
    columns: Optional[Dict[str, str]] = None,
) -> List[Dict[str, List[int]]]:
    """DPO/RM preference pairs: records carry ``instruction``, ``chosen``
    and ``rejected`` (column-mapped as for SFT). Each side is encoded as an
    SFT example (prompt masked, response labelled), so a sequence's
    log-prob covers its response tokens only."""
    out = []
    for rec in records:
        rec = map_columns(rec, columns)
        query = rec.get("instruction")
        chosen, rejected = rec.get("chosen"), rec.get("rejected")
        if not all(isinstance(v, str) and v != ""
                   for v in (query, chosen, rejected)):
            continue
        if rec.get("query"):
            query = query + "\n" + rec["query"]
        pair = {}
        for side, response in (("chosen", chosen), ("rejected", rejected)):
            ids, labels = encode_supervised_example(
                template, tokenizer, query, response,
                history=rec.get("history"), system=rec.get("system"),
                cutoff_len=cutoff_len)
            pair[f"{side}_ids"] = ids
            pair[f"{side}_labels"] = labels
        out.append(pair)
    return out


def preprocess_prompt_records(
    records: Iterable[Dict[str, Any]],
    template: Template,
    tokenizer,
    cutoff_len: int = 1024,
    columns: Optional[Dict[str, str]] = None,
) -> List[Dict[str, List[int]]]:
    """PPO prompt sets: only ``instruction`` (+ optional query/history/
    system) is read, since the policy generates the response; a
    ``response`` column is ignored. The prompt is encoded as generative
    eval encodes it, keeping its last ``cutoff_len`` tokens."""
    out = []
    for rec in records:
        rec = map_columns(rec, columns)
        query = rec.get("instruction")
        if not (isinstance(query, str) and query):
            continue
        if rec.get("query"):
            query = query + "\n" + rec["query"]
        prompt_ids, _ = template.encode_oneturn(
            tokenizer, query, "", rec.get("history"), rec.get("system"))
        if not prompt_ids:
            continue
        out.append({"prompt_ids": prompt_ids[-cutoff_len:]})
    return out


def preprocess_pretrain_records(
    records: Iterable[Dict[str, Any]],
    tokenizer,
    cutoff_len: int = 1024,
    columns: Optional[Dict[str, str]] = None,
) -> List[Dict[str, List[int]]]:
    """Plain-LM pretraining (``--stage pt``): a ``text`` column, falling
    back to instruction + response; every token is a label."""
    bos = getattr(tokenizer, "bos_token_id", None)
    add_bos = (bool(getattr(tokenizer, "add_bos_token", False))
               and bos is not None)
    eos = tokenizer.eos_token_id
    out = []
    for rec in records:
        rec = map_columns(rec, columns)
        text = rec.get("text")
        if not isinstance(text, str) or not text:
            parts = [rec.get("instruction"), rec.get("response")]
            text = "\n".join(p for p in parts if isinstance(p, str) and p)
        if not text:
            continue
        ids = tokenizer.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [bos] + ids
        if eos is not None:
            ids = ids + [eos]
        ids = ids[:cutoff_len]
        out.append({"input_ids": ids, "labels": list(ids),
                    "attention_mask": [1] * len(ids)})
    return out


def pad_to_block(
    examples: Sequence[Dict[str, List[int]]],
    block_size: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Right-pad each example to the static block_size."""
    B = len(examples)
    input_ids = np.full((B, block_size), pad_id, np.int32)
    labels = np.full((B, block_size), IGNORE_INDEX, np.int32)
    attn = np.zeros((B, block_size), np.int32)
    for i, ex in enumerate(examples):
        n = min(len(ex["input_ids"]), block_size)
        input_ids[i, :n] = ex["input_ids"][:n]
        labels[i, :n] = ex["labels"][:n]
        attn[i, :n] = 1
    return {"input_ids": input_ids, "labels": labels, "attention_mask": attn}


def pack_to_block(
    examples: Sequence[Dict[str, List[int]]],
    block_size: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing of examples (longest first) into block_size
    rows with segment_ids (1, 2, ... per row; 0 = pad) and per-segment
    positions; cross-segment attention is masked by the model."""
    rows: List[List[Dict[str, List[int]]]] = []
    used: List[int] = []
    for ex in sorted(examples, key=lambda e: -len(e["input_ids"])):
        n = min(len(ex["input_ids"]), block_size)
        for i, u in enumerate(used):
            if u + n <= block_size:
                rows[i].append(ex)
                used[i] += n
                break
        else:
            rows.append([ex])
            used.append(n)

    B = len(rows)
    input_ids = np.full((B, block_size), pad_id, np.int32)
    labels = np.full((B, block_size), IGNORE_INDEX, np.int32)
    attn = np.zeros((B, block_size), np.int32)
    segs = np.zeros((B, block_size), np.int32)
    positions = np.zeros((B, block_size), np.int32)
    for i, row in enumerate(rows):
        off = 0
        for j, ex in enumerate(row, start=1):
            n = min(len(ex["input_ids"]), block_size - off)
            input_ids[i, off:off + n] = ex["input_ids"][:n]
            labels[i, off:off + n] = ex["labels"][:n]
            # the shifted loss reads labels[t+1] from position t: a segment's
            # first token is never trained from the previous segment's last
            labels[i, off] = IGNORE_INDEX
            attn[i, off:off + n] = 1
            segs[i, off:off + n] = j
            positions[i, off:off + n] = np.arange(n)
            off += n
    return {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": attn,
        "segment_ids": segs,
        "positions": positions,
    }
