"""Shared prompt-preparation for KV-cache generation (serving engine +
in-training generative eval).

Left-pad to a compile bucket with the pads attention-masked; real tokens keep
rope positions 0..n-1 regardless of cache slot (models/llama.py records
per-slot positions). Budgets are clamped so cache width never exceeds
max_seq_len — oversized caches would wrongly trigger dynamic-NTK rope
inflation (ops/rope.py reads the cache width as seq_len).
"""

from __future__ import annotations

from typing import List, Tuple

DECODE_BUCKET = 64


def prepare_prompt(
    prompt_ids: List[int],
    eos_id: int,
    max_seq_len: int,
    max_new_tokens: int,
    bucket: int = DECODE_BUCKET,
) -> Tuple[List[int], List[int], List[int], int, int, int]:
    """Returns (ids, mask, positions, plen, n_prompt, max_new_clamped, buf).

    buf is the static decode-buffer length (cache width = plen + buf)."""
    max_new = max(1, min(max_new_tokens, max_seq_len - bucket))
    # floor the kept-prompt cap to a bucket multiple so plen is ALWAYS one:
    # chunked prefill splits plen into bucket-multiple chunks, so an off-bucket
    # plen (any off-bucket max_new) would compile a fresh tail-chunk program
    # per distinct remainder (`or keep`: sub-bucket max_seq_len keeps the
    # un-floored cap rather than rounding to zero)
    keep = max_seq_len - max_new
    keep = keep // bucket * bucket or keep
    prompt_ids = list(prompt_ids)[-keep:]
    if not prompt_ids:
        # empty prompt: seed with a single (unmasked) eos — an all-masked
        # prefill row would softmax to NaN
        prompt_ids = [eos_id]
    plen = min(-(-len(prompt_ids) // bucket) * bucket, keep)
    prompt_ids = prompt_ids[-plen:]
    n = len(prompt_ids)
    pad = plen - n
    ids = [eos_id] * pad + prompt_ids
    mask = [0] * pad + [1] * n
    positions = [0] * pad + list(range(n))
    # clamp the decode budget so plen + buffer <= max_seq_len
    buf = min(-(-max_new // bucket) * bucket, max_seq_len - plen)
    max_new = min(max_new, buf)
    return ids, mask, positions, plen, n, max_new, buf
