"""Prompt-template registry: encodes (query, response, history, system) into
per-turn (prompt_ids, response_ids) pairs. A copy of
``datatunerx_tpu/data/templates.py`` (the part the chat encoder uses).

Behavior-parity port of the reference registry semantics (reference
cmd/tuning/template.py:24-120 for the encode algorithm, :228-620 for the 18
registered templates; golden-token tests in tests/test_templates.py pin us to
the reference algorithm's output). Key semantics:

- A template is prefix/prompt/system/sep token-or-text sequences. ``{{system}}``,
  ``{{query}}``, ``{{idx}}`` substitute once per element. Dict elements are
  literal special tokens resolved via ``convert_tokens_to_ids``.
- Standard encoding: turn 0 = [bos + prefix + sep + query | resp + eos],
  turn t = [sep + bos + query | resp + eos]. If prefix renders empty, turn 0 is
  just [bos + query].
- llama2-family templates fold "<<SYS>>…" into the first query and emit
  [bos + "[INST] … [/INST] " | resp + eos] per turn with no sep.
- ``efficient_eos`` (baichuan/qwen/chatglm/…): no eos after each response; a
  single eos is appended at sequence end by the supervised preprocessor, and
  later turns carry eos as the first *label* token (see preprocess.py).
- Tokenizer fixing: missing eos → "<|endoftext|>"; missing pad → eos; template
  stop words are registered as additional special tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

Piece = Union[str, Dict[str, str]]  # text or {"token": "<special>"}


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    prefix: Tuple[Piece, ...]
    prompt: Tuple[Piece, ...]
    system: str
    sep: Tuple[Piece, ...]
    stop_words: Tuple[str, ...] = ()
    use_history: bool = True
    efficient_eos: bool = False

    # llama2-style templates get special turn encoding (detected on name, like
    # the reference's register_template does).
    @property
    def is_llama2_style(self) -> bool:
        return "llama2" in self.name

    # ------------------------------------------------------------- rendering
    def _render(
        self,
        tokenizer,
        pieces: Sequence[Piece],
        *,
        system: Optional[str] = None,
        query: Optional[str] = None,
        idx: Optional[str] = None,
    ) -> List[int]:
        ids: List[int] = []
        for piece in pieces:
            if isinstance(piece, dict):
                ids.append(tokenizer.convert_tokens_to_ids(piece["token"]))
                continue
            text = piece
            if system is not None:
                text = text.replace("{{system}}", system, 1)
            if query is not None:
                text = text.replace("{{query}}", query, 1)
            if idx is not None:
                text = text.replace("{{idx}}", idx, 1)
            if text:
                ids.extend(tokenizer.encode(text, add_special_tokens=False))
        return ids

    def _special_ids(self, tokenizer) -> Tuple[List[int], List[int]]:
        bos = (
            [tokenizer.bos_token_id]
            if tokenizer.bos_token_id is not None
            and getattr(tokenizer, "add_bos_token", True)
            else []
        )
        if tokenizer.eos_token_id is None:
            raise ValueError("EOS token is required.")
        eos = [] if self.efficient_eos else [tokenizer.eos_token_id]
        return bos, eos

    # -------------------------------------------------------------- encoding
    def encode_turns(
        self,
        tokenizer,
        query: str,
        response: str,
        history: Optional[List[Tuple[str, str]]] = None,
        system: Optional[str] = None,
    ) -> List[Tuple[List[int], List[int]]]:
        """All (prompt_ids, response_ids) pairs, oldest turn first."""
        system = system or self.system
        turns = (list(history) if (history and self.use_history) else []) + [
            (query, response)
        ]
        bos, eos = self._special_ids(tokenizer)

        pairs: List[Tuple[List[int], List[int]]] = []
        if self.is_llama2_style:
            for i, (q, r) in enumerate(turns):
                if i == 0:
                    q = str(self.prefix[0]).replace("{{system}}", system) + q
                q_ids = self._render(tokenizer, self.prompt, query=q)
                r_ids = tokenizer.encode(r, add_special_tokens=False) if r else []
                pairs.append((bos + q_ids, r_ids + eos))
            return pairs

        sep_ids = self._render(tokenizer, self.sep)
        for i, (q, r) in enumerate(turns):
            if i == 0:
                prefix_ids = self._render(tokenizer, self.prefix, system=system)
                lead = bos + prefix_ids + sep_ids if prefix_ids else bos
            else:
                lead = sep_ids + bos
            q_ids = self._render(tokenizer, self.prompt, query=q, idx=str(i))
            r_ids = tokenizer.encode(r, add_special_tokens=False) if r else []
            pairs.append((lead + q_ids, r_ids + eos))
        return pairs

    def encode_oneturn(
        self, tokenizer, query, response, history=None, system=None
    ) -> Tuple[List[int], List[int]]:
        """(full prompt ids incl. history, final response ids)."""
        pairs = self.encode_turns(tokenizer, query, response, history, system)
        prompt: List[int] = []
        for q_ids, r_ids in pairs[:-1]:
            prompt += q_ids + r_ids
        return prompt + pairs[-1][0], pairs[-1][1]


def fix_tokenizer(tokenizer, template: Optional["Template"]) -> None:
    """Reference get_template_and_fix_tokenizer side effects
    (cmd/tuning/template.py:201-222)."""
    if tokenizer.eos_token_id is None:
        tokenizer.eos_token = "<|endoftext|>"
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    if template is not None and template.stop_words:
        tokenizer.add_special_tokens(
            dict(additional_special_tokens=list(template.stop_words)),
            replace_additional_special_tokens=False,
        )


# ======================================================================
# Registry. Spec strings/tokens mirror the reference registrations
# (cmd/tuning/template.py:228-620) — behavior parity requires identical
# format strings; see tests/goldens/templates.json.
# ======================================================================

_T = lambda token: {"token": token}  # noqa: E731

_DEFAULT_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)

_SPECS: Dict[str, Dict[str, Any]] = {
    # language-model inference, no history
    "vanilla": dict(prefix=[], prompt=["{{query}}"], system="", sep=[], use_history=False),
    "default": dict(
        prefix=["{{system}}"],
        prompt=["Human: {{query}}\nAssistant: "],
        system=_DEFAULT_SYSTEM,
        sep=["\n"],
    ),
    "llama2": dict(
        prefix=["<<SYS>>\n{{system}}\n<</SYS>>\n\n"],
        prompt=["[INST] {{query}} [/INST] "],
        system=(
            "You are a helpful, respectful and honest assistant. "
            "Always answer as helpfully as possible, while being safe.  "
            "Your answers should not include any harmful, unethical, "
            "racist, sexist, toxic, dangerous, or illegal content. "
            "Please ensure that your responses are socially unbiased and positive in nature.\n\n"
            "If a question does not make any sense, or is not factually coherent, "
            "explain why instead of answering something not correct. "
            "If you don't know the answer to a question, please don't share false information."
        ),
        sep=[],
    ),
    "llama2_zh": dict(
        prefix=["<<SYS>>\n{{system}}\n<</SYS>>\n\n"],
        prompt=["[INST] {{query}} [/INST] "],
        system="You are a helpful assistant. 你是一个乐于助人的助手。",
        sep=[],
    ),
    "alpaca": dict(
        prefix=["{{system}}"],
        prompt=["### Instruction:\n{{query}}\n\n### Response:\n"],
        system=(
            "Below is an instruction that describes a task. "
            "Write a response that appropriately completes the request."
        ),
        sep=["\n\n"],
    ),
    "vicuna": dict(
        prefix=["{{system}}"],
        prompt=["USER: {{query}} ASSISTANT:"],
        system=_DEFAULT_SYSTEM,
        sep=[],
    ),
    "belle": dict(
        prefix=["{{system}}"], prompt=["Human: {{query}}\n\nBelle: "], system="",
        sep=["\n\n"],
    ),
    "ziya": dict(
        prefix=["{{system}}"],
        prompt=[_T("<human>"), ":{{query}}\n", _T("<bot>"), ":"],
        system="",
        sep=["\n"],
    ),
    "aquila": dict(
        prefix=["{{system}}"],
        prompt=["Human: {{query}}###Assistant:"],
        system=(
            "A chat between a curious human and an artificial intelligence assistant. "
            "The assistant gives helpful, detailed, and polite answers to the human's questions."
        ),
        sep=["###"],
        stop_words=["</s>"],
        efficient_eos=True,
    ),
    "intern": dict(
        prefix=["{{system}}"],
        prompt=["<|User|>:{{query}}", _T("<eoh>"), "\n<|Bot|>:"],
        system="",
        sep=[_T("<eoa>"), "\n"],
        stop_words=["<eoa>"],
        efficient_eos=True,
    ),
    "baichuan": dict(
        prefix=["{{system}}"],
        prompt=[_T("<reserved_102>"), "{{query}}", _T("<reserved_103>")],
        system="",
        sep=[],
        efficient_eos=True,
    ),
    "baichuan2": dict(
        prefix=["{{system}}"],
        prompt=[_T("<reserved_106>"), "{{query}}", _T("<reserved_107>")],
        system="",
        sep=[],
        efficient_eos=True,
    ),
    "starchat": dict(
        prefix=[_T("<|system|>"), "\n{{system}}"],
        prompt=[_T("<|user|>"), "\n{{query}}", _T("<|end|>"), "\n", _T("<|assistant|>")],
        system="",
        sep=[_T("<|end|>"), "\n"],
        stop_words=["<|end|>"],
        efficient_eos=True,
    ),
    "chatml": dict(
        prefix=[_T("<|im_start|>"), "system\n{{system}}"],
        prompt=[
            _T("<|im_start|>"), "user\n{{query}}", _T("<|im_end|>"), "\n",
            _T("<|im_start|>"), "assistant\n",
        ],
        system="You are a helpful assistant.",
        sep=[_T("<|im_end|>"), "\n"],
        stop_words=["<|im_end|>"],
        efficient_eos=True,
    ),
    "chatglm2": dict(
        prefix=[_T("[gMASK]"), _T("sop"), "{{system}}"],
        prompt=["[Round {{idx}}]\n\n问：{{query}}\n\n答："],
        system="",
        sep=["\n\n"],
        efficient_eos=True,
    ),
    "chatglm3": dict(
        prefix=[_T("[gMASK]"), _T("sop"), "{{system}}"],
        prompt=[_T("<|user|>"), "\n", "{{query}}", _T("<|assistant|>")],
        system="",
        sep=[],
        stop_words=["<|user|>", "<|observation|>"],
        efficient_eos=True,
    ),
    "openchat": dict(
        prefix=["{{system}}"],
        prompt=["GPT4 User: {{query}}", _T("<|end_of_turn|>"), "GPT4 Assistant:"],
        system="",
        sep=[_T("<|end_of_turn|>")],
        efficient_eos=True,
    ),
    "xverse": dict(
        prefix=["{{system}}"],
        prompt=["Human: {{query}}\n\nAssistant: "],
        system="",
        sep=[],
    ),
}

TEMPLATES: Dict[str, Template] = {
    name: Template(
        name=name,
        prefix=tuple(spec["prefix"]),
        prompt=tuple(spec["prompt"]),
        system=spec["system"],
        sep=tuple(spec["sep"]),
        stop_words=tuple(spec.get("stop_words", ())),
        use_history=spec.get("use_history", True),
        efficient_eos=spec.get("efficient_eos", False),
    )
    for name, spec in _SPECS.items()
}


def get_template(name: str, tokenizer=None) -> Template:
    if name not in TEMPLATES:
        raise KeyError(f"template {name!r} does not exist; have {sorted(TEMPLATES)}")
    template = TEMPLATES[name]
    if tokenizer is not None:
        fix_tokenizer(tokenizer, template)
    return template
