"""The single-request engine, perplexity and the chat helpers: the port of
``datatunerx_tpu/serving/engine.py``.

``InferenceEngine`` serves one request at a time (``--slots 1``, and every
serve-time ``--quantization``). ``checkpoint_path`` (a trained run's
``checkpoints`` directory or one of its steps, or a ``model.npz`` export)
MERGES the adapter into the base at the manifest's scaling, or swaps in a
full-parameter checkpoint, before any quantization. The prompt prefills
into a one-row dense cache of width ``plen + buf``
(``utils/decoding.prepare_prompt``), then a decode loop samples with the
plain sampler ``_sample_jit`` (the reference's single-request engine has no
fused epilogue) from the reference's own key stream (``ops/prng.py``): a
seed gives the JAX engine's sampled tokens. The loop keeps every operand
on the device and reads a stopped flag back every ``STOP_CHECK`` tokens;
the tokens cross to the host in one fetch at the end.

``nll_impl`` / ``prepare_nll_inputs`` back ``/perplexity`` for both engines.
"""

from __future__ import annotations

import math
import numbers
from typing import List, Optional

import numpy as np
import torch

from datatunerx_tpu_torch.data.templates import Template, get_template
from datatunerx_tpu_torch.models.llama import forward, init_cache
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.utils.decoding import prepare_prompt
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer

STOP_CHECK = 16  # decode steps between reads of the device-side stop flag


def tree_to(tree, device, dtype=None):
    """A tensor tree on ``device``, its floating leaves in ``dtype`` (when
    given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=(dtype if tree.is_floating_point()
                                         else None))


class InferenceEngine:
    """One request at a time over a per-call dense cache. Concurrent callers
    are safe: each call owns its cache and generator, and the weights are
    only read.

    The reference keeps a process-wide memo of its compiled programs
    (``_ENGINE_MEMO``); eager PyTorch compiles nothing, so there is nothing
    to share between engines and the port has no such memo."""

    def __init__(self, model_path: str, checkpoint_path: Optional[str] = None,
                 template: str = "llama2", max_seq_len: int = 1024,
                 dtype=torch.bfloat16, quantization: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InferenceEngine runs on CUDA by default and no CUDA "
                    "device is visible; pass device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        if quantization:
            # serve-time weight quantization: quantize on the HOST and move
            # only the quantized tree to the card, so the full-precision and
            # the quantized weights never sit on the device together
            import dataclasses

            from datatunerx_tpu_torch.ops.quant import quantize_model_params

            self.cfg, host, self.tokenizer = load_model_and_tokenizer(
                model_path, dtype=dtype, seed=seed, device="cpu")
            if checkpoint_path:
                host = self._apply_checkpoint(host, checkpoint_path)
            with torch.inference_mode():
                qparams = quantize_model_params(host, quantization)
            del host
            self.params = tree_to(qparams, self.device)
            self.cfg = dataclasses.replace(self.cfg, quantization=quantization)
        else:
            self.cfg, self.params, self.tokenizer = load_model_and_tokenizer(
                model_path, dtype=dtype, seed=seed, device=self.device)
            if checkpoint_path:
                self.params = self._apply_checkpoint(self.params,
                                                     checkpoint_path)
        self.template: Template = get_template(template, self.tokenizer)
        self.max_seq_len = min(max_seq_len, self.cfg.max_seq_len)

    def _apply_checkpoint(self, params, checkpoint_path: str):
        """``params`` with a trained adapter merged in (at the manifest's
        scaling, else alpha 32 / rank, as the reference falls back), or
        replaced by a full-parameter checkpoint or a ``model.npz`` export,
        on ``params``' device and in its dtype."""
        from datatunerx_tpu_torch.models.lora import lora_scaling, merge_lora
        from datatunerx_tpu_torch.serving.batched_engine import (
            load_checkpoint_state,
        )

        state = load_checkpoint_state(checkpoint_path, self.cfg)
        leaf = params["embed_tokens"]["embedding"]
        lora = state.get("lora")
        if lora:
            rank = next(iter(lora["layers"].values()))["a"].shape[-1]
            scaling = state.get("_scaling")
            if scaling is None:
                scaling = lora_scaling(32.0, rank)
            with torch.inference_mode():
                return merge_lora(params, tree_to(lora, leaf.device,
                                                  torch.float32), scaling)
        if state.get("params"):
            return tree_to(state["params"], leaf.device, leaf.dtype)
        raise ValueError(f"{checkpoint_path}: no lora or params tree")

    @torch.inference_mode()
    def generate(self, prompt_ids: List[int], max_new_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 stop_ids: Optional[set] = None) -> List[int]:
        stops = {int(s) for s in (stop_ids or set())
                 if isinstance(s, numbers.Integral)}
        stops.add(self.tokenizer.eos_token_id)
        ids, mask, positions, plen, n_prompt, max_new, buf = prepare_prompt(
            prompt_ids, self.tokenizer.eos_token_id, self.max_seq_len,
            max_new_tokens)
        dev = self.device
        cache = init_cache(self.cfg, 1, plen + buf, dtype=torch.bfloat16,
                           device=dev)
        logits, cache = forward(
            self.params, torch.tensor([ids], dtype=torch.int32, device=dev),
            self.cfg,
            positions=torch.tensor([positions], dtype=torch.int32, device=dev),
            attention_mask=torch.tensor([mask], dtype=torch.int32, device=dev),
            cache=cache, compute_dtype=torch.bfloat16)
        logits = logits[:, plen - 1]
        stop_arr = torch.tensor(sorted(stops), dtype=torch.int32, device=dev)
        temps = torch.full((1,), float(temperature), dtype=torch.float32,
                           device=dev)
        top_ps = torch.full((1,), float(top_p), dtype=torch.float32,
                            device=dev)
        # the reference's key stream: split the seed's key once a token and
        # draw from the second half; keys never depend on a sampled value,
        # so they are made on the host and cross to the device once
        subs = None
        if temperature > 0.0:
            key, host = prng.PRNGKey(seed), []
            for _ in range(max_new):
                key, sub = prng.split(key)
                host.append(sub)
            subs = prng.to_device(np.stack(host), dev)
        out = torch.full((max_new,), -1, dtype=torch.int32, device=dev)
        stopped = torch.zeros((1,), dtype=torch.bool, device=dev)
        for i in range(max_new):
            nxt = _sample_jit(logits, temps, top_ps,
                              None if subs is None else subs[i:i + 1])
            stopped = stopped | (nxt[:, None] == stop_arr).any(dim=1)
            out[i:i + 1] = torch.where(stopped, torch.full_like(nxt, -1), nxt)
            if i + 1 == max_new:
                break
            if (i + 1) % STOP_CHECK == 0 and bool(stopped):
                break  # the loop's designed sync, every STOP_CHECK tokens
            logits, cache = forward(
                self.params, nxt[:, None], self.cfg,
                positions=torch.full((1, 1), n_prompt + i, dtype=torch.int32,
                                     device=dev),
                cache=cache, compute_dtype=torch.bfloat16)
            logits = logits[:, -1]
        toks = out.tolist()  # the one fetch of the tokens
        return toks[:toks.index(-1)] if -1 in toks else toks

    # The server's engine surface, shared with ``BatchedEngine``: this
    # engine serves one model, so a request's "model" routes nowhere (the
    # reference's single-request engine ignores it) and the trace id, which
    # only keys per-request stats, has nothing to key here.
    def adapter_for(self, model: str) -> str:
        return ""

    @torch.inference_mode()
    def perplexity(self, prompt_ids: List[int], completion_ids: List[int],
                   adapter: str = "") -> dict:
        """Mean NLL of the completion given the prompt."""
        tokens, mask, _ = prepare_nll_inputs(
            prompt_ids, completion_ids, self.tokenizer.eos_token_id,
            self.max_seq_len, device=self.device)
        nll_sum, n_tok = nll_impl(self.params, self.cfg, tokens, mask)
        return nll_result(float(nll_sum), int(n_tok))

    def _encode_chat(self, messages: List[dict]):
        return encode_chat_messages(self.template, self.tokenizer, messages)

    def chat(self, messages: List[dict], max_new_tokens: int = 128,
             temperature: float = 0.0, top_p: float = 1.0,
             seed: int = 0, adapter: str = "", trace_id: str = "") -> str:
        """OpenAI-ish messages → templated prompt → completion text."""
        prompt_ids, stop_ids = self._encode_chat(messages)
        out_ids = self.generate(
            prompt_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p, seed=seed,
            stop_ids=stop_ids)
        return self.tokenizer.decode(out_ids, skip_special_tokens=True)

    def chat_stream(self, messages: List[dict], **kw):
        """The whole completion as one delta: nothing streams off a
        single request's decode loop before its one fetch."""
        yield self.chat(messages, **kw)

    def close(self):
        """Nothing runs in the background; the server calls this on exit."""


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
                top_p: torch.Tensor, keys: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The legacy sampler (``--sampling_epilogue off``), batched over rows:
    greedy argmax where temperature <= 0, else ``jax.random.categorical``
    (the port's twin, ``ops/prng.py``) over the top-p filtered, sorted
    logits, as the reference draws. ``keys [S, 2]`` are the rows' draw keys
    (int64 words on the logits' device); None when the caller knows every
    row is greedy, which skips the draw. Returns ``[S]`` int32."""
    greedy = torch.argmax(logits, dim=-1)
    if keys is None:
        return greedy.to(torch.int32)
    t = temperature.to(torch.float32).clamp(min=1e-6)
    scaled = logits.to(torch.float32) / t[:, None]
    sorted_logits, sorted_idx = torch.sort(scaled, dim=-1, descending=True,
                                           stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.to(torch.float32)[:, None]
    cut = (cum - probs > tp) & (tp < 1.0)
    filtered = torch.where(cut, torch.full_like(sorted_logits, -math.inf),
                           sorted_logits)
    choice = prng.categorical(keys, filtered)
    sampled = torch.gather(sorted_idx, -1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def nll_result(nll_sum: float, n_tok: int) -> dict:
    mean = nll_sum / max(n_tok, 1)
    return {"nll_sum": nll_sum, "num_tokens": n_tok,
            "mean_nll": mean, "perplexity": math.exp(mean)}


def nll_impl(params, cfg, tokens: torch.Tensor, target_mask: torch.Tensor,
             **fw_kwargs):
    """Sum of -log p(token) over the masked target positions, and their
    count. ``target_mask`` marks completion tokens in the ORIGINAL index
    space; column j of the shifted targets is token j + 1, so the mask is
    shifted by one. Log-softmax runs in f32 over the bf16 forward's
    logits."""
    logits, _ = forward(params, tokens, cfg, compute_dtype=torch.bfloat16,
                        **fw_kwargs)
    logprobs = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:].long()
    ll = torch.gather(logprobs, -1, tgt[..., None])[..., 0]
    w = target_mask[:, 1:].to(torch.float32)
    return torch.sum(-ll * w), torch.sum(w)


def prepare_nll_inputs(prompt_ids, completion_ids, eos_id, max_seq_len,
                       bucket: int = 64, device="cpu"):
    """Right-pad prompt + completion to a bucket multiple; completion tokens
    get mask 1. Long inputs are truncated from the LEFT, keeping the
    completion. Returns ``(tokens [1, P], mask [1, P], n_completion)``."""
    ids = list(prompt_ids) + list(completion_ids)
    if len(ids) > max_seq_len:
        ids = ids[-max_seq_len:]
    n_completion = min(len(completion_ids), len(ids) - 1)
    total = len(ids)
    padded = min(-(-total // bucket) * bucket, max_seq_len)
    mask = [0] * (total - n_completion) + [1] * n_completion
    ids = ids + [eos_id] * (padded - total)
    mask = mask + [0] * (padded - total)
    return (torch.tensor([ids], dtype=torch.int32, device=device),
            torch.tensor([mask], dtype=torch.int32, device=device),
            n_completion)
