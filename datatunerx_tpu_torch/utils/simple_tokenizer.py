"""Dependency-free byte-level tokenizer with the HF duck-type surface the
template/data layer needs. Used for preset (random-init) models, CPU smoke
runs, and tests — real checkpoints use HF AutoTokenizer."""

from __future__ import annotations

from typing import List


class SimpleTokenizer:
    """Byte-level: token id = 10 + byte for vocab compactness; ids < 10 and a
    special-token region (3000+) are reserved."""

    def __init__(self, add_bos_token: bool = True):
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self.pad_token = None
        self.pad_token_id = None
        self.unk_token_id = 0
        self.add_bos_token = add_bos_token
        self._special = {"<s>": 1, "</s>": 2}
        self._special_rev = {1: "<s>", 2: "</s>"}

    @property
    def vocab_size(self) -> int:
        return 3000 + len(self._special)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [10 + b for b in text.encode("utf-8")]
        if add_special_tokens and self.add_bos_token:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if 10 <= i < 266:
                out.append(i - 10)
            elif not skip_special_tokens and i in self._special_rev:
                out.extend(self._special_rev[i].encode())
        return out.decode("utf-8", errors="replace")

    def convert_tokens_to_ids(self, token: str) -> int:
        if token not in self._special:
            idx = 3000 + len(self._special)
            self._special[token] = idx
            self._special_rev[idx] = token
        return self._special[token]

    def add_special_tokens(self, mapping, replace_additional_special_tokens=False):
        for tok in mapping.get("additional_special_tokens", []):
            self.convert_tokens_to_ids(tok)

    def __setattr__(self, k, v):
        super().__setattr__(k, v)
        if k == "pad_token" and v is not None:
            super().__setattr__("pad_token_id", self._special.get(v, self.eos_token_id))
