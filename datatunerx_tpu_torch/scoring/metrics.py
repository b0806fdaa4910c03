"""Text-similarity metrics: ROUGE-1/2/L and BLEU-4, dependency-free (the
port's own copy of ``datatunerx_tpu/scoring/metrics.py``).

The names are the ones generative eval logs (rouge-1, rouge-2, rouge-l,
bleu-4), computed over whitespace tokens (characters for text without
spaces): no nltk or jieba.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence


def _tokens(text: str) -> List[str]:
    toks = text.split()
    if not toks and text:  # CJK-ish: fall back to characters
        toks = list(text)
    return toks


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(candidate: str, reference: str, n: int) -> float:
    """F1, matching the reference's rouge_chinese F-score semantics
    (recall-only inflates scores for long generations)."""
    c, r = _ngram_counts(_tokens(candidate), n), _ngram_counts(_tokens(reference), n)
    if not r:
        return 0.0
    overlap = sum((c & r).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(c.values()), 1)
    rec = overlap / max(sum(r.values()), 1)
    return 2 * p * rec / (p + rec)


def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(candidate: str, reference: str) -> float:
    a, b = _tokens(candidate), _tokens(reference)
    lcs = _lcs(a, b)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(a), lcs / len(b)
    return 2 * p * r / (p + r)


def bleu4(candidate: str, reference: str, zero_unigram_zero: bool = False) -> float:
    """Smoothed BLEU-4. With zero_unigram_zero (the SCORER's mode), zero
    unigram overlap returns 0 — uniform +1 smoothing otherwise scores 1-token
    garbage ~0.5, which corrupts probe-based model scoring. The default keeps
    uniform smoothing for eval-curve continuity (training generative eval)."""
    cand, ref = _tokens(candidate), _tokens(reference)
    if not cand:
        return 0.0
    logs = 0.0
    for n in range(1, 5):
        c, r = _ngram_counts(cand, n), _ngram_counts(ref, n)
        total = max(sum(c.values()), 1)
        overlap = sum((c & r).values())
        if n == 1 and zero_unigram_zero:
            if overlap == 0:
                return 0.0
            logs += math.log(overlap / total)
        else:
            # +1 smoothing (method-1) so short strings don't zero out
            logs += math.log((overlap + 1) / (total + 1))
    bp = 1.0 if len(cand) >= len(ref) else math.exp(1 - len(ref) / max(len(cand), 1))
    return bp * math.exp(logs / 4)


def generation_scores(candidate: str, reference: str,
                      strict_bleu: bool = False) -> Dict[str, float]:
    return {
        "rouge-1": rouge_n(candidate, reference, 1),
        "rouge-2": rouge_n(candidate, reference, 2),
        "rouge-l": rouge_l(candidate, reference),
        "bleu-4": bleu4(candidate, reference, zero_unigram_zero=strict_bleu),
    }
