"""Chat encoding and the legacy sampler: the part of
``datatunerx_tpu/serving/engine.py`` the batched engine uses. The single-slot
``InferenceEngine`` comes with a later slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from datatunerx_tpu_torch.data.templates import Template


def encode_chat_messages(template: Template, tokenizer, messages: List[dict]):
    """OpenAI-ish messages → (prompt_ids, stop_ids) via the chat template."""
    system = None
    history: List[tuple] = []
    pending: Optional[str] = None
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "system":
            system = content
        elif role == "user":
            if pending is not None:
                history.append((pending, ""))
            pending = content
        elif role == "assistant" and pending is not None:
            history.append((pending, content))
            pending = None
    prompt_ids, _ = template.encode_oneturn(
        tokenizer, pending or "", "", history or None, system
    )
    stop_ids = {tokenizer.eos_token_id}
    for w in template.stop_words:
        tid = tokenizer.convert_tokens_to_ids(w)
        if isinstance(tid, int):  # no-unk fast tokenizers return None
            stop_ids.add(tid)
    return prompt_ids, stop_ids


def _sample_jit(logits: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """The legacy sampler (``--sampling_epilogue off``), batched over rows:
    greedy argmax where temperature <= 0, else top-p sampling over the sorted
    distribution. The reference draws with ``jax.random.categorical``; the
    port inverts the filtered CDF at the row's uniform ``us`` instead (same
    distribution, different bits). Returns ``[S]`` int32."""
    greedy = torch.argmax(logits, dim=-1)
    t = temperature.to(torch.float32).clamp(min=1e-6)
    scaled = logits.to(torch.float32) / t[:, None]
    sorted_logits, sorted_idx = torch.sort(scaled, dim=-1, descending=True,
                                           stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.to(torch.float32)[:, None]
    cut = (cum - probs > tp) & (tp < 1.0)
    probs = torch.where(cut, torch.zeros_like(probs), probs)
    cdf = torch.cumsum(probs, dim=-1)
    hit = cdf > (us.to(torch.float32) * probs.sum(dim=-1))[:, None]
    choice = torch.argmax(hit.to(torch.int8), dim=-1)
    sampled = torch.gather(sorted_idx, -1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
