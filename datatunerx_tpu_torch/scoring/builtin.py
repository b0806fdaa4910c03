"""Built-in scorer: drives the inference service and produces a 0-100 score.

The reference delegates scoring to a sibling-repo operator that POSTs to the
job's ``/chat/completions`` endpoint and writes ``Scoring.Status.Score``
(SURVEY.md §2.3 Scoring, §3.4). This is our in-tree equivalent: a fixed (or
CR-parameterized) probe set is sent to the endpoint; answers are scored with
ROUGE-L/BLEU against references, averaged, and scaled to 0-100. Scores stay
strings end-to-end for API parity (reference quirk, util.go:24-30)."""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional

from datatunerx_tpu_torch.scoring.metrics import generation_scores

DEFAULT_PROBES: List[Dict[str, str]] = [
    {"prompt": "What is the capital of France?", "reference": "Paris"},
    {"prompt": "What is 2 + 2?", "reference": "4"},
    {"prompt": "Name the largest planet in our solar system.", "reference": "Jupiter"},
    {"prompt": "What color is a clear daytime sky?", "reference": "blue"},
    {"prompt": "Who wrote the play Hamlet?", "reference": "William Shakespeare"},
]


def validate_probes(probes) -> Optional[List[Dict[str, str]]]:
    """Shape-check CR-supplied probes before any endpoint traffic, so the
    controller can scope its permanent invalid-spec branch to THIS check
    (endpoint responses that fail to parse must stay retryable — a warming
    server can return a 200 with a non-OpenAI body). None → built-in defaults.
    """
    if probes is None:
        return None
    if not isinstance(probes, list) or not probes:
        raise ValueError("spec.probes must be a non-empty list")
    for i, p in enumerate(probes):
        if (not isinstance(p, dict)
                or not isinstance(p.get("prompt"), str)
                or not isinstance(p.get("reference"), str)):
            raise ValueError(
                f"spec.probes[{i}] must be {{prompt: str, reference: str}}"
            )
    return probes


def query_chat(endpoint: str, prompt: str, timeout: float = 60.0,
               max_tokens: int = 64, model: Optional[str] = None) -> str:
    body = {
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": max_tokens,
        "temperature": 0.0,
    }
    if model:
        # routes to a named LoRA adapter on multi-adapter engines
        # (serving/server.py "model" handling) — side-by-side scoring of N
        # tuned checkpoints through ONE engine (BASELINE row 6)
        body["model"] = model
    req = urllib.request.Request(
        endpoint,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = json.load(resp)
    return payload["choices"][0]["message"]["content"]


def score_endpoint(
    inference_url: str,
    probes: Optional[List[Dict[str, str]]] = None,
    timeout: float = 60.0,
    model: Optional[str] = None,
) -> Dict:
    """Returns {"score": "NN.N", "details": [...]}; raises on transport errors
    so the controller can retry."""
    probes = probes or DEFAULT_PROBES
    details = []
    total = 0.0
    for probe in probes:
        answer = query_chat(inference_url, probe["prompt"], timeout=timeout,
                            model=model)
        s = generation_scores(answer, probe["reference"], strict_bleu=True)
        per = max(s["rouge-l"], s["bleu-4"])
        total += per
        details.append({"prompt": probe["prompt"], "answer": answer, **s})
    final = 100.0 * total / max(len(probes), 1)
    return {"score": f"{final:.1f}", "details": details}
