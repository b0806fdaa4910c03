"""Write the tokenizer fixtures of the HF-directory tests.

    python tests/fixtures/torch_hf/make_tokenizers.py

Three directories, each with ``tokenizer.json``, ``tokenizer_config.json``
and ``special_tokens_map.json`` as ``save_pretrained`` writes them, from
BPE models trained with ``tokenizers``' ``BpeTrainer`` on the repository's
own ``SURVEY.md`` and ``README.md`` (about 2000 tokens each):

- ``llama``: the SentencePiece-style layout ``LlamaTokenizerFast`` writes
  today: a ``Metaspace`` pre-tokenizer (``prepend_scheme="first"``), byte
  fallback through ``<0x00>``..``<0xFF>`` vocabulary entries (ids 3..258,
  as in Llama-2's vocabulary), ``fuse_unk``, and the ``Replace`` /
  ``ByteFallback`` / ``Fuse`` / ``Strip`` decoder chain;
- ``llama_legacy``: the same model under the older normalizer,
  ``Prepend("▁")`` + ``Replace(" ", "▁")``, with no pre-tokenizer, and
  ``clean_up_tokenization_spaces`` on;
- ``qwen2``: Qwen2's byte-level BPE: an ``NFC`` normalizer, a ``Split`` on
  Qwen2's pattern, ``ByteLevel``, and the three ``<|...|>`` special tokens
  after the vocabulary.

Needs ``tokenizers`` and ``transformers``; the fixtures are committed, so
only a change to them needs this script.
"""

from __future__ import annotations

import json
import os

from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
VOCAB = 2000
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA_SPECIALS = ("<unk>", "<s>", "</s>")
QWEN2_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")


def corpus():
    lines = []
    for name in ("SURVEY.md", "README.md"):
        with open(os.path.join(ROOT, name), encoding="utf-8") as f:
            lines.extend(f.read().splitlines())
    return lines


def special(content):
    return AddedToken(content, special=True, normalized=False)


def llama_tokenizer(legacy: bool) -> Tokenizer:
    """Train on Metaspace pieces, then lay the vocabulary out as Llama-2's:
    the three specials, the 256 byte tokens, then the trained pieces."""
    pre = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                   split=False)
    probe = Tokenizer(models.BPE(unk_token="<unk>"))
    probe.pre_tokenizer = pre
    probe.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=VOCAB - 256, special_tokens=list(LLAMA_SPECIALS),
        limit_alphabet=120, show_progress=False))
    model = json.loads(probe.to_str())["model"]
    vocab = {t: i for i, t in enumerate(LLAMA_SPECIALS)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for tok, _ in sorted(model["vocab"].items(), key=lambda kv: kv[1]):
        if tok not in vocab:
            vocab[tok] = len(vocab)
    merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
              for m in model["merges"]]
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               byte_fallback=True, fuse_unk=True))
    if legacy:
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(content=" ", left=1, right=0)])
    tok.add_special_tokens([special(t) for t in LLAMA_SPECIALS])
    return tok


def qwen2_tokenizer() -> Tokenizer:
    tok = Tokenizer(models.BPE(unk_token=None, byte_fallback=False))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=VOCAB, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([special(t) for t in QWEN2_SPECIALS])
    return tok


def main():
    from transformers import LlamaTokenizerFast, Qwen2TokenizerFast

    for name, legacy in (("llama", False), ("llama_legacy", True)):
        fast = LlamaTokenizerFast(
            tokenizer_object=llama_tokenizer(legacy), bos_token="<s>",
            eos_token="</s>", unk_token="<unk>", add_bos_token=True,
            add_eos_token=False, legacy=legacy,
            clean_up_tokenization_spaces=legacy)
        fast.save_pretrained(os.path.join(HERE, name), legacy_format=False)
    fast = Qwen2TokenizerFast(
        tokenizer_object=qwen2_tokenizer(), bos_token=None,
        eos_token="<|endoftext|>", pad_token="<|endoftext|>", unk_token=None,
        additional_special_tokens=["<|im_start|>", "<|im_end|>"],
        clean_up_tokenization_spaces=False)
    fast.save_pretrained(os.path.join(HERE, "qwen2"), legacy_format=False)


if __name__ == "__main__":
    main()
