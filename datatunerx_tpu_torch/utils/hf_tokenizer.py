"""A reader of HF ``tokenizer.json`` directories: the port's stand-in for
``transformers.AutoTokenizer`` (the machine the port runs on has neither
``transformers`` nor ``tokenizers``).

It reads ``tokenizer.json`` (a ``BPE`` model), ``tokenizer_config.json``
and ``special_tokens_map.json``, and covers the two tokenizer families the
model presets name:

- SentencePiece-style BPE with byte fallback (Llama-2, Mistral), in both
  layouts ``tokenizers`` writes: the older ``Prepend("▁")`` +
  ``Replace(" ", "▁")`` normalizer, and the newer ``Metaspace``
  pre-tokenizer with its ``prepend_scheme``; ``<0xNN>`` byte tokens,
  ``fuse_unk``, and the ``Replace`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip`` decoder chain;
- byte-level BPE (Qwen1.5 / Qwen2): ``NFC``, a ``Split`` on Qwen2's
  pattern, then ``ByteLevel``. The pattern uses ``\\p{L}`` and ``\\p{N}``,
  which Python's ``re`` lacks, so ``qwen2_split`` is a hand-written scanner
  over ``unicodedata.category``.

The surface is the part of an AutoTokenizer the port's callers use:
``encode``, ``decode`` (with ``clean_up_tokenization_spaces`` as the config
says), ``convert_tokens_to_ids``, the bos/eos/pad/unk tokens and ids with
setters, ``add_special_tokens``, ``len()``. Added tokens are matched in the
text before BPE (leftmost, then longest), as ``tokenizers`` matches them.
Anything else a directory asks for raises ``NotImplementedError`` naming
it; nothing falls back.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

META = "▁"
QWEN2_PATTERN = (
    "(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|"
    " ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+")
# Oniguruma's \s under UTF-8: the Unicode White_Space property (Python's
# str.isspace also takes U+001C..U+001F)
_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f"
                   "\u3000" + "".join(chr(c) for c in range(0x2000, 0x200B)))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# Oniguruma's case folding: besides ASCII case, U+017F (long s) folds to s
_FOLD = {"S": "s", "ſ": "s"}


# Letters (L) and numbers (N) of Unicode 16.0 that Python 3.12's
# unicodedata (15.0) leaves unassigned, and Oniguruma's \p{L}/\p{N} know:
# (first, last, class), read off tokenizers' Split one code point at a time
_UNICODE16 = (
    (0x01C89, 0x01C8A, "L"), (0x0A7CB, 0x0A7CD, "L"), (0x0A7DA, 0x0A7DC, "L"),
    (0x105C0, 0x105F3, "L"), (0x10D40, 0x10D49, "N"), (0x10D4A, 0x10D65, "L"),
    (0x10D6F, 0x10D85, "L"), (0x10EC2, 0x10EC4, "L"), (0x11380, 0x11389, "L"),
    (0x1138B, 0x1138B, "L"), (0x1138E, 0x1138E, "L"), (0x11390, 0x113B5, "L"),
    (0x113B7, 0x113B7, "L"), (0x113D1, 0x113D1, "L"), (0x113D3, 0x113D3, "L"),
    (0x116D0, 0x116E3, "N"), (0x11BC0, 0x11BE0, "L"), (0x11BF0, 0x11BF9, "N"),
    (0x13460, 0x143FA, "L"), (0x16100, 0x1611D, "L"), (0x16130, 0x16139, "N"),
    (0x16D40, 0x16D6C, "L"), (0x16D70, 0x16D79, "N"), (0x18CFF, 0x18CFF, "L"),
    (0x1CCF0, 0x1CCF9, "N"), (0x1E5D0, 0x1E5ED, "L"), (0x1E5F0, 0x1E5F0, "L"),
    (0x1E5F1, 0x1E5FA, "N"), (0x2EBF0, 0x2EE5D, "L"))
_UNICODE16_FIRST = [r[0] for r in _UNICODE16]


@functools.lru_cache(maxsize=65536)
def _class(c: str) -> str:
    """"L", "N" or another general-category initial, as Oniguruma reads
    it."""
    cat = unicodedata.category(c)[0]
    if cat == "C":
        k = bisect.bisect_right(_UNICODE16_FIRST, ord(c)) - 1
        if k >= 0 and ord(c) <= _UNICODE16[k][1]:
            return _UNICODE16[k][2]
    return cat


def _letter(c: str) -> bool:
    return _class(c) == "L"


def _number(c: str) -> bool:
    return _class(c) == "N"


def _other(c: str) -> bool:
    r"""``[^\s\p{L}\p{N}]``."""
    return c not in _SPACE and not _letter(c) and not _number(c)


def _contraction(text: str, i: int) -> int:
    """Length of ``(?i:'s|'t|'re|'ve|'m|'ll|'d)`` at ``i`` (0: none)."""
    if text[i] != "'":
        return 0
    for word in _CONTRACTIONS:
        piece = text[i + 1:i + 1 + len(word)]
        if len(piece) == len(word) and all(
                _FOLD.get(c, c.lower() if c.isascii() else c) == w
                for c, w in zip(piece, word)):
            return 1 + len(word)
    return 0


def qwen2_split(text: str) -> List[str]:
    """Qwen2's pre-tokenizer split (``QWEN2_PATTERN``, behaviour
    ``Isolated``): the regex's leftmost-first alternatives, each with its
    greedy quantifiers and backtracking, written out by hand."""
    out: List[str] = []
    n, i, gap = len(text), 0, None
    while i < n:
        c = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        end = i + _contraction(text, i)
        if end == i:
            # [^\r\n\p{L}\p{N}]?\p{L}+
            j = i
            if (c not in "\r\n" and not _letter(c) and not _number(c)
                    and nxt and _letter(nxt)):
                j = i + 1
            if _letter(text[j]):
                while j < n and _letter(text[j]):
                    j += 1
                end = j
        if end == i and _number(c):  # \p{N}
            end = i + 1
        if end == i:
            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            j = i + 1 if (c == " " and nxt) else i
            if not _other(text[j]):
                j = i
            if _other(text[j]):
                while j < n and _other(text[j]):
                    j += 1
                while j < n and text[j] in "\r\n":
                    j += 1
                end = j
        if end == i and c in _SPACE:
            run = i
            while run < n and text[run] in _SPACE:
                run += 1
            breaks = [k for k in range(i, run) if text[k] in "\r\n"]
            if breaks:  # \s*[\r\n]+
                end = breaks[-1] + 1
            elif run == n:  # \s+(?!\S) at the end of the text
                end = run
            elif run - i >= 2:  # \s+(?!\S), backing off one space
                end = run - 1
            else:  # \s+
                end = run
        if end == i:  # no alternative matches here: a gap char
            gap = i if gap is None else gap
            i += 1
            continue
        if gap is not None:
            out.append(text[gap:i])
            gap = None
        out.append(text[i:end])
        i = end
    if gap is not None:
        out.append(text[gap:])
    return out


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character table (``ByteLevel``)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _refuse(what: str, node) -> None:
    raise NotImplementedError(
        f"tokenizer.json: {what} {json.dumps(node)[:200]} is not supported "
        "(SentencePiece-style BPE with byte fallback, or Qwen2's byte-level "
        "BPE)")


def _string_pattern(node) -> str:
    pattern = node.get("pattern", {})
    if set(pattern) != {"String"}:
        _refuse("a pattern other than a plain string in", node)
    return pattern["String"]


def _flatten(node, key: str) -> List[dict]:
    if node is None:
        return []
    if node["type"] == "Sequence":
        return [x for sub in node[key] for x in _flatten(sub, key)]
    return [node]


class _BPE:
    """The ``BPE`` model of ``tokenizers``: characters (or their ``<0xNN>``
    bytes, or ``unk``) merged lowest rank first, leftmost among equals, on a
    heap over a linked list of symbols."""

    def __init__(self, model: dict):
        if model.get("type") != "BPE":
            _refuse("the model", {"type": model.get("type")})
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if model.get(key):
                _refuse(f"BPE {key}", {key: model[key]})
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(model["merges"]):  # a repeat: last wins
            a, b = merge if isinstance(merge, list) else merge.split(" ", 1)
            self.ranks[(a, b)] = rank
        self.unk = model.get("unk_token")
        self.fuse_unk = bool(model.get("fuse_unk"))
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.cache: Dict[str, List[str]] = {}

    def _symbols(self, word: str) -> List[str]:
        syms: List[str] = []
        unk_pending = False
        for ch in word:
            if ch in self.vocab:
                if unk_pending:
                    syms.append(self.unk)
                    unk_pending = False
                syms.append(ch)
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(code in self.vocab for code in codes):
                    syms.extend(codes)
                    continue
            if self.unk is None:
                raise ValueError(
                    f"tokenizer.json: {ch!r} is not in the vocabulary and "
                    "the model has no unk_token")
            if unk_pending and not self.fuse_unk:
                syms.append(self.unk)
            unk_pending = True
        if unk_pending:
            syms.append(self.unk)
        return syms

    def tokenize(self, word: str) -> List[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        syms = self._symbols(word)
        n = len(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        ranks = self.ranks
        heap = [(ranks[(syms[i], syms[i + 1])], i, syms[i] + syms[i + 1])
                for i in range(n - 1) if (syms[i], syms[i + 1]) in ranks]
        heapq.heapify(heap)
        while heap:
            _, i, merged = heapq.heappop(heap)
            j = nxt[i]
            # an entry a merge has made stale: tokenizers keeps it only if
            # the pair now there is a merge with the same result
            if (not alive[i] or j >= n or syms[i] + syms[j] != merged
                    or (syms[i], syms[j]) not in ranks):
                continue
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            p = prv[i]
            if p >= 0 and (syms[p], merged) in ranks:
                heapq.heappush(heap, (ranks[(syms[p], merged)], p,
                                      syms[p] + merged))
            k = nxt[i]
            if k < n and (merged, syms[k]) in ranks:
                heapq.heappush(heap, (ranks[(merged, syms[k])], i,
                                      merged + syms[k]))
        out = [s for s, a in zip(syms, alive) if a]
        if len(self.cache) < 65536:
            self.cache[word] = out
        return out


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value["content"]
    return value



# Pairs that Python's Unicode tables compose and ``tokenizers``' NFC leaves
# apart (its tables predate the composition): Dives Akuru U+11935 U+11930,
# which Python 3.12 (Unicode 15) composes to U+11938.
_NFC_APART = ("\U00011935\U00011930",)


def nfc(text: str) -> str:
    """NFC as ``tokenizers`` computes it: ``unicodedata``'s, except that a
    pair of ``_NFC_APART`` stays apart. Both of its code points are
    starters that compose with nothing else, so normalizing the text
    between the pairs and joining it back around them is the whole rule."""
    for pair in _NFC_APART:
        if pair in text:
            return pair.join(nfc(part) for part in text.split(pair))
    return unicodedata.normalize("NFC", text)


class HFTokenizer:
    """An HF tokenizer directory, read without ``transformers``."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = self._read_json("tokenizer_config.json")
        config.update({k: v for k, v in
                       self._read_json("special_tokens_map.json").items()})
        self.model = _BPE(spec["model"])
        self.normalizers = self._parse_normalizers(spec.get("normalizer"))
        self.pre_tokenizers = self._parse_pre_tokenizers(
            spec.get("pre_tokenizer"))
        self.decoders = self._parse_decoders(spec.get("decoder"))

        self.added: Dict[str, int] = {}
        self.special: set = set()
        for tok in spec.get("added_tokens", []):
            self._register(tok)
        for idx, tok in config.get("added_tokens_decoder", {}).items():
            if tok["content"] not in self.added:
                self._register(dict(tok, id=int(idx)))
        self.id_to_token: Dict[int, str] = {
            i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

        self._bos = _token_content(config.get("bos_token"))
        self._eos = _token_content(config.get("eos_token"))
        self._unk = _token_content(config.get("unk_token"))
        self._pad = _token_content(config.get("pad_token"))
        self.additional_special_tokens: List[str] = [
            _token_content(t) for t in
            config.get("additional_special_tokens", [])]
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        prefix, suffix = self._parse_post_processor(spec.get("post_processor"))
        if "add_bos_token" in config or "add_eos_token" in config:
            # transformers rebuilds the post-processor from these flags
            self.add_bos_token = bool(config.get(
                "add_bos_token", bool(prefix)))
            self.add_eos_token = bool(config.get(
                "add_eos_token", bool(suffix)))
            self._prefix = [self.bos_token_id] if self.add_bos_token else []
            self._suffix = [self.eos_token_id] if self.add_eos_token else []
            if None in self._prefix + self._suffix:
                raise ValueError(
                    f"{path}: add_bos_token/add_eos_token need a bos/eos "
                    "token")
        else:
            self._prefix, self._suffix = prefix, suffix
            self.add_bos_token = bool(prefix)
            self.add_eos_token = bool(suffix)

    # ----------------------------------------------------------- reading
    def _read_json(self, name: str) -> dict:
        full = os.path.join(self.path, name)
        if not os.path.exists(full):
            return {}
        with open(full, encoding="utf-8") as f:
            return json.load(f)

    def _register(self, tok: dict) -> None:
        for flag in ("single_word", "lstrip", "rstrip", "normalized"):
            if tok.get(flag):
                _refuse(f"an added token with {flag}", tok)
        self.added[tok["content"]] = int(tok["id"])
        if tok.get("special"):
            self.special.add(tok["content"])

    @staticmethod
    def _parse_normalizers(node) -> List[dict]:
        steps = _flatten(node, "normalizers")
        for step in steps:
            if step["type"] == "Replace":
                _string_pattern(step)
            elif step["type"] not in ("Prepend", "NFC"):
                _refuse("the normalizer", step)
        return steps

    @staticmethod
    def _parse_pre_tokenizers(node) -> List[dict]:
        steps = _flatten(node, "pretokenizers")
        for step in steps:
            kind = step["type"]
            if kind == "Metaspace":
                if step.get("prepend_scheme", "always") not in (
                        "first", "always", "never"):
                    _refuse("the Metaspace prepend_scheme", step)
            elif kind == "Split":
                if (step.get("pattern") != {"Regex": QWEN2_PATTERN}
                        or step.get("behavior") != "Isolated"
                        or step.get("invert")):
                    _refuse("the Split pre-tokenizer (only Qwen2's pattern, "
                            "Isolated)", step)
            elif kind == "ByteLevel":
                if step.get("add_prefix_space") or step.get("use_regex"):
                    _refuse("ByteLevel with add_prefix_space or use_regex",
                            step)
            else:
                _refuse("the pre-tokenizer", step)
        return steps

    @staticmethod
    def _parse_decoders(node) -> List[dict]:
        steps = _flatten(node, "decoders")
        for step in steps:
            if step["type"] == "Replace":
                _string_pattern(step)
            elif step["type"] not in ("ByteFallback", "Fuse", "Strip",
                                      "ByteLevel"):
                _refuse("the decoder", step)
        return steps

    def _parse_post_processor(self, node) -> Tuple[List[int], List[int]]:
        prefix: List[int] = []
        suffix: List[int] = []
        for step in _flatten(node, "processors"):
            if step["type"] == "ByteLevel":
                continue
            if step["type"] != "TemplateProcessing":
                _refuse("the post-processor", step)
            specials = step.get("special_tokens", {})
            seen_a = False
            for item in step["single"]:
                if "Sequence" in item:
                    seen_a = True
                    continue
                ids = specials[item["SpecialToken"]["id"]]["ids"]
                (suffix if seen_a else prefix).extend(int(i) for i in ids)
        return prefix, suffix

    # --------------------------------------------------- special tokens
    def _id(self, token: Optional[str]) -> Optional[int]:
        return None if token is None else self.convert_tokens_to_ids(token)

    bos_token = property(lambda self: self._bos,
                         lambda self, v: setattr(self, "_bos", v))
    eos_token = property(lambda self: self._eos,
                         lambda self, v: setattr(self, "_eos", v))
    unk_token = property(lambda self: self._unk,
                         lambda self, v: setattr(self, "_unk", v))
    pad_token = property(lambda self: self._pad,
                         lambda self, v: setattr(self, "_pad", v))
    bos_token_id = property(
        lambda self: self._id(self._bos),
        lambda self, i: setattr(self, "_bos", self.id_to_token.get(i)))
    eos_token_id = property(
        lambda self: self._id(self._eos),
        lambda self, i: setattr(self, "_eos", self.id_to_token.get(i)))
    unk_token_id = property(
        lambda self: self._id(self._unk),
        lambda self, i: setattr(self, "_unk", self.id_to_token.get(i)))
    pad_token_id = property(
        lambda self: self._id(self._pad),
        lambda self, i: setattr(self, "_pad", self.id_to_token.get(i)))

    def __len__(self) -> int:
        return len(set(self.model.vocab) | set(self.added))

    @property
    def vocab_size(self) -> int:
        return len(self.model.vocab)

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        """A token's id; an unknown token gives ``unk_token_id`` (None when
        there is no unk token), as transformers does."""
        idx = self.added.get(token, self.model.vocab.get(token))
        if idx is None and self._unk is not None and token != self._unk:
            return self.convert_tokens_to_ids(self._unk)
        return idx

    def add_special_tokens(self, mapping: dict,
                           replace_additional_special_tokens: bool = True
                           ) -> int:
        """Add ``mapping["additional_special_tokens"]`` as special tokens
        matched whole before BPE. A token already known keeps its id; a new
        one gets the next id past the vocabulary and every added token.
        Returns how many are new."""
        if set(mapping) - {"additional_special_tokens"}:
            raise NotImplementedError(
                f"add_special_tokens takes additional_special_tokens only, "
                f"got {sorted(mapping)}")
        added = 0
        extra = [_token_content(t) for t in
                 mapping["additional_special_tokens"]]
        for token in extra:
            idx = self.added.get(token, self.model.vocab.get(token))
            if idx is None:
                idx = max([len(self.model.vocab) - 1, *self.added.values()]) + 1
                added += 1
                self.id_to_token[idx] = token
            self.added[token] = idx
            self.special.add(token)
        if replace_additional_special_tokens:
            self.additional_special_tokens = extra
        else:
            self.additional_special_tokens += [
                t for t in extra if t not in self.additional_special_tokens]
        return added

    # ---------------------------------------------------------- encoding
    @staticmethod
    def _split_on(text: str, tokens: Dict[str, int], start: int
                  ) -> Iterable[Tuple[str, int, Optional[int]]]:
        """(piece, its offset, the added token's id or None): the leftmost
        match first, the longest at a position."""
        if not tokens:
            if text:
                yield text, start, None
            return
        by_first: Dict[str, List[str]] = {}
        for tok in sorted(tokens, key=len, reverse=True):
            if tok:
                by_first.setdefault(tok[0], []).append(tok)
        i = last = 0
        while i < len(text):
            hit = next((t for t in by_first.get(text[i], ())
                        if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > last:
                yield text[last:i], start + last, None
            yield hit, start + i, tokens[hit]
            i = last = i + len(hit)
        if last < len(text):
            yield text[last:], start + last, None

    def _normalize(self, text: str) -> str:
        for step in self.normalizers:
            kind = step["type"]
            if kind == "Prepend":
                text = step["prepend"] + text if text else text
            elif kind == "Replace":
                text = text.replace(_string_pattern(step), step["content"])
            else:  # NFC
                text = nfc(text)
        return text

    def _pre_tokenize(self, text: str, first: bool) -> List[str]:
        """Words of one normalized piece; ``first``: the piece starts the
        text (Metaspace's ``prepend_scheme="first"``)."""
        words = [(text, first)]
        for step in self.pre_tokenizers:
            kind = step["type"]
            out: List[Tuple[str, bool]] = []
            for w, lead in words:
                if kind == "Metaspace":
                    rep = step.get("replacement", META)
                    w = w.replace(" ", rep)
                    scheme = step.get("prepend_scheme", "always")
                    if not w.startswith(rep) and (
                            scheme == "always" or (scheme == "first"
                                                   and lead)):
                        w = rep + w
                    if step.get("split", True):
                        cuts = [k for k, c in enumerate(w) if c == rep and k]
                        pieces = [w[a:b] for a, b in
                                  zip([0] + cuts, cuts + [len(w)])]
                    else:
                        pieces = [w]
                elif kind == "Split":
                    pieces = qwen2_split(w)
                else:  # ByteLevel
                    pieces = ["".join(BYTE_CHAR[b] for b in w.encode("utf-8"))]
                out.extend((p, lead and k == 0) for k, p in enumerate(pieces)
                           if p)
            words = out
        return [w for w, _ in words]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for piece, offset, tid in self._split_on(text, self.added, 0):
            if tid is not None:
                ids.append(tid)
                continue
            for word in self._pre_tokenize(self._normalize(piece),
                                           offset == 0):
                ids.extend(self.model.vocab[t]
                           for t in self.model.tokenize(word))
        if add_special_tokens:
            ids = self._prefix + ids + self._suffix
        return ids

    # ---------------------------------------------------------- decoding
    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """Ids past the vocabulary are skipped, as ``tokenizers`` skips
        them."""
        if isinstance(ids, int):
            ids = [ids]
        tokens = []
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        text = self._decode_tokens(tokens)
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return clean_up_tokenization(text) if clean else text

    def _decode_tokens(self, tokens: List[str]) -> str:
        if not self.decoders:
            return " ".join(tokens)
        for step in self.decoders:
            kind = step["type"]
            if kind == "Replace":
                pat = _string_pattern(step)
                tokens = [t.replace(pat, step["content"]) for t in tokens]
            elif kind == "ByteFallback":
                tokens = self._byte_fallback(tokens)
            elif kind == "Fuse":
                tokens = ["".join(tokens)]
            elif kind == "Strip":
                tokens = [self._strip(t, step) for t in tokens]
            else:  # ByteLevel
                data = bytearray()
                for t in tokens:
                    if all(c in CHAR_BYTE for c in t):
                        data.extend(CHAR_BYTE[c] for c in t)
                    else:
                        data.extend(t.encode("utf-8"))
                tokens = [data.decode("utf-8", errors="replace")]
        return "".join(tokens)

    @staticmethod
    def _byte_fallback(tokens: List[str]) -> List[str]:
        out: List[str] = []
        pending = bytearray()

        def flush():
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

        for t in tokens:
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    pending.append(int(t[3:5], 16))
                    continue
                except ValueError:
                    pass
            if pending:
                flush()
            out.append(t)
        if pending:
            flush()
        return out

    @staticmethod
    def _strip(token: str, step: dict) -> str:
        content = step["content"]
        start = 0
        while start < min(step.get("start", 0), len(token)) and \
                token[start] == content:
            start += 1
        stop = len(token)
        for _ in range(step.get("stop", 0)):
            if stop > start and token[stop - 1] == content:
                stop -= 1
            else:
                break
        return token[start:stop]


def load_hf_tokenizer(path: str) -> Optional[HFTokenizer]:
    """The tokenizer of an HF directory; None when the directory holds no
    tokenizer files. A directory that holds only a SentencePiece
    ``tokenizer.model`` raises: the port reads ``tokenizer.json`` only."""
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        return HFTokenizer(path)
    if os.path.exists(os.path.join(path, "tokenizer.model")):
        raise NotImplementedError(
            f"{path} holds a SentencePiece tokenizer.model and no "
            "tokenizer.json; the port reads tokenizer.json only (write one "
            "with transformers' save_pretrained of the fast tokenizer)")
    return None
