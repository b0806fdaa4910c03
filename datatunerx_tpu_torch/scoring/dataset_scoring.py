"""Dataset-driven scoring: evaluate a served model over a real eval split.

The reference's scoring sibling only probes the endpoint; SURVEY.md §2.3 notes
the Dataset CR carries train/validate/test split URIs
(reference internal/controller/finetune/finetune_controller.go:466-470).
Here a Scoring CR may reference that Dataset (``spec.datasetRef``) and the
controller scores the serving endpoint over its test (fallback: validate)
split — two metrics:

- ``generation`` (default): ROUGE-L/BLEU of sampled completions against the
  reference column (the metric family the reference logs,
  cmd/tuning/callback.py:103-138), averaged and scaled 0-100;
- ``perplexity``: the serving ``/perplexity`` endpoint returns the mean
  completion NLL under the model; score = 100·exp(−NLL) — the geometric-mean
  per-token probability as a percentage, so HIGHER is better and experiment
  BestVersion sorting (reference finetuneexperiment_controller.go:199-216)
  keeps working.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional

from datatunerx_tpu_torch.scoring.builtin import query_chat
from datatunerx_tpu_torch.scoring.metrics import generation_scores

DEFAULT_MAX_EXAMPLES = 100


def split_file_from_dataset_spec(dataset_spec: dict) -> Optional[str]:
    """Test split if present, else validate (never train — scoring on the
    training data would reward memorization)."""
    info = ((dataset_spec.get("datasetMetadata") or {})
            .get("datasetInfo") or {})
    for subset in info.get("subsets") or []:
        splits = subset.get("splits") or {}
        for split in ("test", "validate"):
            f = (splits.get(split) or {}).get("file")
            if f:
                return f
    return None


def columns_from_dataset_spec(dataset_spec: dict) -> Optional[Dict[str, str]]:
    info = ((dataset_spec.get("datasetMetadata") or {})
            .get("datasetInfo") or {})
    features = info.get("features") or []
    cols = {f.get("mapTo"): f.get("name") for f in features
            if f.get("mapTo") and f.get("name")}
    return cols or None


def load_eval_records(dataset_spec: dict,
                      max_examples: int = DEFAULT_MAX_EXAMPLES) -> List[dict]:
    """→ [{"prompt": …, "reference": …}] from the dataset's eval split."""
    from datatunerx_tpu_torch.data.loader import CsvDataset
    from datatunerx_tpu_torch.data.preprocess import map_columns

    path = split_file_from_dataset_spec(dataset_spec)
    if not path:
        raise ValueError("dataset has no test/validate split to score against")
    cols = columns_from_dataset_spec(dataset_spec)
    ds = CsvDataset(path, columns=cols)
    out = []
    for rec in ds.records[: max(1, max_examples)]:
        rec = map_columns(rec, cols)
        prompt = rec.get("instruction") or ""
        query = rec.get("query") or ""
        if query:
            prompt = f"{prompt}\n{query}" if prompt else query
        ref = rec.get("response") or ""
        if prompt and ref:
            out.append({"prompt": prompt, "reference": ref})
    if not out:
        raise ValueError("eval split yielded no usable (prompt, reference) rows")
    return out


def query_perplexity(endpoint: str, prompt: str, completion: str,
                     timeout: float = 60.0, model=None) -> dict:
    """POST the serving /perplexity endpoint (serving/server.py)."""
    url = endpoint.rsplit("/chat/completions", 1)[0].rstrip("/") + "/perplexity"
    body = {"prompt": prompt, "completion": completion}
    if model:
        body["model"] = model  # adapter routing, serving/server.py
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def score_dataset(
    inference_url: str,
    dataset_spec: dict,
    metric: str = "generation",
    max_examples: int = DEFAULT_MAX_EXAMPLES,
    timeout: float = 60.0,
    model=None,
) -> Dict:
    """Returns {"score": "NN.N", "details": {…}} over the dataset's eval split."""
    records = load_eval_records(dataset_spec, max_examples=max_examples)
    if metric == "perplexity":
        import math

        total_nll, total_tokens = 0.0, 0
        for r in records:
            resp = query_perplexity(inference_url, r["prompt"], r["reference"],
                                    timeout=timeout, model=model)
            total_nll += float(resp["nll_sum"])
            total_tokens += int(resp["num_tokens"])
        mean_nll = total_nll / max(total_tokens, 1)
        score = 100.0 * math.exp(-mean_nll)
        details = {
            "metric": "perplexity",
            "examples": len(records),
            "perplexity": math.exp(mean_nll),
            "mean_nll": mean_nll,
        }
        return {"score": f"{score:.2f}", "details": details}

    if metric != "generation":
        raise ValueError(f"unknown scoring metric {metric!r}")
    total = 0.0
    agg = {"rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0, "bleu-4": 0.0}
    for r in records:
        answer = query_chat(inference_url, r["prompt"], timeout=timeout,
                            model=model)
        s = generation_scores(answer, r["reference"], strict_bleu=True)
        total += max(s["rouge-l"], s["bleu-4"])
        for k in agg:
            agg[k] += s[k]
    n = len(records)
    details = {"metric": "generation", "examples": n,
               **{k: round(v / n, 4) for k, v in agg.items()}}
    return {"score": f"{100.0 * total / n:.1f}", "details": details}
