"""Greedy generation for generative eval (the port of
``datatunerx_tpu/training/generate.py``).

``greedy_generate`` decodes one prompt over the dense KV cache
(``models/llama.init_cache``), as the reference does: the prompt
left-padded to a bucket (pads masked, real tokens at rope positions
0..n-1), one prefill forward, then one forward a token, bf16 compute,
adapters applied unmerged through the forward's ``lora``. The paged
kernels (K7/K8) are not on this path; the dense cache's attention is the
biased read.

``generative_eval`` generates for up to ``max_examples`` eval records,
writes ``generated_predictions.jsonl`` (``prompt``, ``label``,
``predict``) and returns the mean rouge-1/2/l and bleu-4.
"""

from __future__ import annotations

import json
import numbers
import os
from typing import Dict, List, Optional

import torch

from datatunerx_tpu_torch.data.preprocess import map_columns
from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.scoring.metrics import generation_scores
from datatunerx_tpu_torch.utils.decoding import prepare_prompt


def _device(params) -> torch.device:
    return params["embed_tokens"]["embedding"].device


@torch.no_grad()
def greedy_generate(
    params,
    cfg: ModelConfig,
    tokenizer,
    prompt_ids: List[int],
    *,
    lora: Optional[tuple] = None,
    max_new_tokens: int = 64,
    stop_ids=None,
) -> List[int]:
    stop_ids = {int(s) for s in (stop_ids or set())
                if isinstance(s, numbers.Integral)}
    stop_ids.add(tokenizer.eos_token_id)
    ids, mask, positions, padded_len, n_prompt, max_new_tokens, buf = (
        prepare_prompt(prompt_ids, tokenizer.eos_token_id, cfg.max_seq_len,
                       max_new_tokens))
    device = _device(params)

    def t(rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)

    cache = init_cache(cfg, 1, padded_len + buf, dtype=torch.bfloat16,
                       device=device)
    logits, cache = forward(params, t([ids]), cfg, positions=t([positions]),
                            attention_mask=t([mask]), cache=cache, lora=lora,
                            compute_dtype=torch.bfloat16)
    out: List[int] = []
    nxt = int(torch.argmax(logits[0, -1]))
    pos = n_prompt
    for _ in range(max_new_tokens):
        if nxt in stop_ids:
            break
        out.append(nxt)
        logits, cache = forward(params, t([[nxt]]), cfg,
                                positions=t([[pos]]), cache=cache, lora=lora,
                                compute_dtype=torch.bfloat16)
        nxt = int(torch.argmax(logits[0, -1]))
        pos += 1
    return out


def generative_eval(
    params,
    cfg: ModelConfig,
    tokenizer,
    template,
    records: List[Dict],
    output_dir: str,
    *,
    lora: Optional[tuple] = None,
    max_new_tokens: int = 64,
    max_examples: int = 32,
    columns: Optional[Dict[str, str]] = None,
) -> Dict[str, float]:
    """Generate for up to ``max_examples`` records with an ``instruction``
    and a ``response``; write ``generated_predictions.jsonl`` under
    ``output_dir`` and return the averaged scores ({} when none ran)."""
    stop_ids = {tokenizer.convert_tokens_to_ids(w)
                for w in template.stop_words}
    totals = {"rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0, "bleu-4": 0.0}
    rows = []
    for rec in records[:max_examples]:
        rec = map_columns(rec, columns)
        query, label = rec.get("instruction"), rec.get("response")
        if not (isinstance(query, str) and isinstance(label, str)
                and query and label):
            continue
        prompt_ids, _ = template.encode_oneturn(
            tokenizer, query, "", rec.get("history"), rec.get("system"))
        out_ids = greedy_generate(params, cfg, tokenizer, prompt_ids,
                                  lora=lora, max_new_tokens=max_new_tokens,
                                  stop_ids=stop_ids)
        predict = tokenizer.decode(out_ids, skip_special_tokens=True)
        for k, v in generation_scores(predict, label).items():
            totals[k] += v
        rows.append({"prompt": query, "label": label, "predict": predict})

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "generated_predictions.jsonl"),
              "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    if not rows:
        return {}
    return {k: v / len(rows) for k, v in totals.items()}
