"""Causal-LM loss with prompt masking (the port of
``datatunerx_tpu/training/loss.py``).

HF Trainer semantics: the loss at position t predicts token t+1, ignoring
IGNORE_INDEX labels. Perplexity = exp(eval_loss).
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def causal_lm_loss(
    logits: torch.Tensor,  # [B, T, V] float32
    labels: torch.Tensor,  # [B, T] int with IGNORE_INDEX at masked positions
):
    """Returns (sum_loss, n_valid_tokens) as tensors. Mean = sum/n; callers
    combine across microbatches by summing both, so gradient accumulation
    is exact."""
    return shifted_lm_loss(logits[:, :-1], labels[:, 1:])


def shifted_lm_loss(logits: torch.Tensor, labels_next: torch.Tensor):
    """``causal_lm_loss`` over labels already shifted by one (position t
    holds the label of t+1; a sequence chunk gets them shifted on the whole
    sequence)."""
    logits = logits.float()
    labels = labels_next.long()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    tok = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - tok, torch.zeros_like(logz))
    return nll.sum(), valid.sum()
