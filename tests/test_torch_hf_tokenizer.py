"""The port's ``tokenizer.json`` reader (``utils/hf_tokenizer.py``) against
``transformers.AutoTokenizer`` on the committed fixtures
(``fixtures/torch_hf/{llama,llama_legacy,qwen2}``): exact ids for
``encode`` with and without specials, ``decode`` with and without
``skip_special_tokens`` (ids past the vocabulary included), special tokens
and ids, ``convert_tokens_to_ids``, added special tokens, ``fix_tokenizer``
and templates in both packages; Qwen2's split against ``tokenizers``' own
``Split``; a bounded hypothesis property over arbitrary Unicode text; and
the refusals."""

import json
import os
import random
import shutil

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_hf_dirs import FIXTURES

from datatunerx_tpu.data.templates import get_template as jget_template
from datatunerx_tpu_torch.data.templates import get_template
from datatunerx_tpu_torch.utils.hf_tokenizer import (
    QWEN2_PATTERN,
    HFTokenizer,
    load_hf_tokenizer,
    nfc,
    qwen2_split,
)

NAMES = ["llama", "llama_legacy", "qwen2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = ["", " ", "  hi", "<s>hello</s> x", "a<s>", "</s></s>",
         "naïve café → 日本語 ſ 's 'S 'Re", "a\n\n b\r\n", "\n\n\n  \n",
         "don't . , ! I'm we've they're", "x <|im_end|>y<|endoftext|>",
         "tab\there", "ÿ\x00\x7f", "🙂🙃 emoji", "double  space ", "x  y",
         "Ⅻ² ¾ 12345", "_under_score_", "Ᲊ\U00013460 Unicode 16"]


def _corpus():
    lines = []
    for name in ("SURVEY.md", "ROADMAP.md"):
        path = os.path.join(REPO, name)
        with open(path, encoding="utf-8") as f:
            lines.extend(f.read().splitlines()[:150])
    return lines + EDGES


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    from transformers import AutoTokenizer

    path = os.path.join(FIXTURES, request.param)
    return AutoTokenizer.from_pretrained(path), HFTokenizer(path)


def test_encode_matches_autotokenizer(pair):
    ref, tok = pair
    for text in _corpus():
        for special in (True, False):
            assert tok.encode(text, add_special_tokens=special) == \
                ref.encode(text, add_special_tokens=special), repr(text)


def test_decode_matches_autotokenizer(pair):
    ref, tok = pair
    rng = random.Random(0)
    runs = [ref.encode(t) for t in _corpus()]
    runs += [[rng.randrange(len(ref) + 64) for _ in range(24)]
             for _ in range(60)]  # ids past the vocabulary are skipped
    for ids in runs:
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), ids


def test_special_tokens_and_ids_match(pair):
    ref, tok = pair
    for attr in ("bos_token", "eos_token", "pad_token", "unk_token",
                 "bos_token_id", "eos_token_id", "pad_token_id",
                 "unk_token_id", "vocab_size", "clean_up_tokenization_spaces"):
        assert getattr(tok, attr) == getattr(ref, attr), attr
    assert len(tok) == len(ref)
    for token in ("<s>", "</s>", "<unk>", "never-a-token", "▁the", "e",
                  "<|im_end|>", "<|endoftext|>", "<0x0A>", "Ġ"):
        assert tok.convert_tokens_to_ids(token) == \
            ref.convert_tokens_to_ids(token), token


def test_setters_and_added_special_tokens_match(pair):
    import copy

    ref, tok = copy.deepcopy(pair[0]), HFTokenizer(pair[1].path)
    extra = ["<|im_end|>", "<eoa>", "</s>", "<|user|>"]
    assert tok.add_special_tokens(
        {"additional_special_tokens": extra},
        replace_additional_special_tokens=False) == ref.add_special_tokens(
        {"additional_special_tokens": extra},
        replace_additional_special_tokens=False)
    assert len(tok) == len(ref)
    assert tok.additional_special_tokens == ref.additional_special_tokens
    for text in ("hi<eoa>there<|im_end|></s>", "<|user|><eoa>x", "plain"):
        ids = ref.encode(text)
        assert tok.encode(text) == ids
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip)
    for t in (tok, ref):
        t.pad_token = "<eoa>"
        t.eos_token_id = t.convert_tokens_to_ids("<|user|>")
    assert (tok.pad_token_id, tok.eos_token, tok.eos_token_id) == \
        (ref.pad_token_id, ref.eos_token, ref.eos_token_id)


@pytest.mark.parametrize("template", ["llama2", "chatml", "alpaca",
                                      "vanilla", "intern", "chatglm3"])
@pytest.mark.parametrize("name", NAMES)
def test_fix_tokenizer_and_templates_in_both_packages(name, template):
    """Each package's ``get_template`` (``fix_tokenizer``: eos, pad and the
    stop words as special tokens) on its own tokenizer, then
    ``encode_oneturn``: the same ids."""
    from transformers import AutoTokenizer

    path = os.path.join(FIXTURES, name)
    ref, tok = AutoTokenizer.from_pretrained(path), HFTokenizer(path)
    jt, tt = jget_template(template, ref), get_template(template, tok)
    assert tt.stop_words == jt.stop_words
    assert (tok.eos_token_id, tok.pad_token_id, len(tok)) == \
        (ref.eos_token_id, ref.pad_token_id, len(ref))
    history = [("what is 2+2?", "4."), ("and 3+3?", "6, I think.")]
    for args in (("Hello there", "General Kenobi", None, None),
                 ("q 日本", "a", history, "be brief")):
        assert tt.encode_oneturn(tok, *args) == jt.encode_oneturn(ref, *args)
    for word in tt.stop_words:
        assert tok.convert_tokens_to_ids(word) == \
            ref.convert_tokens_to_ids(word)


def _split_ref():
    from tokenizers import Regex, pre_tokenizers

    return pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                                invert=False)


def test_qwen2_split_matches_tokenizers():
    split = _split_ref()
    texts = _corpus()
    rng = random.Random(1)
    alphabet = list("ab Z1²Ⅻ_'sStTlLdD\r\n\t  .,!-é日ſ\x1c") + [
        "'re", "'LL", "  ", "\n\n", "\r\n", " '"]
    texts += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 14)))
              for _ in range(3000)]
    for text in texts:
        assert qwen2_split(text) == [p for p, _ in
                                     split.pre_tokenize_str(text)], repr(text)


@pytest.fixture(scope="module")
def all_pairs():
    from transformers import AutoTokenizer

    return [(AutoTokenizer.from_pretrained(os.path.join(FIXTURES, n)),
             HFTokenizer(os.path.join(FIXTURES, n))) for n in NAMES]


@settings(max_examples=200, deadline=None)
@given(text=st.text(max_size=40))
def test_property_any_unicode_text(all_pairs, text):
    split = _split_ref()
    assert qwen2_split(text) == [p for p, _ in split.pre_tokenize_str(text)]
    for ref, tok in all_pairs:
        ids = ref.encode(text)
        assert tok.encode(text) == ids
        assert tok.decode(ids, skip_special_tokens=True) == \
            ref.decode(ids, skip_special_tokens=True)


def _edited(tmp_path, name, edit):
    d = tmp_path / name
    shutil.copytree(os.path.join(FIXTURES, name), d)
    with open(d / "tokenizer.json", encoding="utf-8") as f:
        spec = json.load(f)
    edit(spec)
    with open(d / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(spec, f)
    return str(d)


@pytest.mark.parametrize("name", NAMES)
def test_merges_written_as_strings_read_the_same(tmp_path, name):
    """Older ``tokenizer.json`` files (Llama-2's, Mistral's) write each
    merge as one ``"a b"`` string; ``tokenizers`` reads both forms."""
    from transformers import AutoTokenizer

    def as_strings(spec):
        spec["model"]["merges"] = [" ".join(m) for m in
                                   spec["model"]["merges"]]

    d = _edited(tmp_path, name, as_strings)
    ref, tok = AutoTokenizer.from_pretrained(d), HFTokenizer(d)
    for text in _corpus()[:80]:
        assert tok.encode(text) == ref.encode(text), repr(text)


@pytest.mark.parametrize("edit, what", [
    (lambda s: s["model"].update(type="WordPiece"), "WordPiece"),
    (lambda s: s["model"].update(type="Unigram"), "Unigram"),
    (lambda s: s.update(pre_tokenizer={"type": "Whitespace"}), "Whitespace"),
    (lambda s: s.update(pre_tokenizer={
        "type": "Split", "pattern": {"Regex": "\\s+"},
        "behavior": "Isolated", "invert": False}), "Split"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    (lambda s: s.update(decoder={"type": "WordPiece"}), "WordPiece"),
    (lambda s: s["added_tokens"][0].update(lstrip=True), "lstrip"),
])
def test_unsupported_tokenizers_are_refused(tmp_path, edit, what):
    d = _edited(tmp_path, "qwen2", edit)
    with pytest.raises(NotImplementedError, match=what):
        load_hf_tokenizer(d)


def test_sentencepiece_model_only_is_refused(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(NotImplementedError, match="tokenizer.model"):
        load_hf_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.model").unlink()
    assert load_hf_tokenizer(str(tmp_path)) is None


def _chunks(items, n=4096):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def test_nfc_matches_tokenizers_on_every_code_point_and_pair():
    """The port's NFC against ``tokenizers``' on every code point alone and
    on every canonical pair (each code point's two-character NFD, the
    inputs that composition acts on), the Dives Akuru pair U+11935 U+11930
    among them: ``tokenizers`` leaves it apart where Python's tables
    compose it to U+11938. Texts are checked in newline-joined chunks (a
    newline is a starter that composes with nothing)."""
    import unicodedata

    from tokenizers import normalizers

    ref = normalizers.NFC()
    points = [chr(c) for c in range(0x110000)
              if not 0xD800 <= c <= 0xDFFF]
    pairs = [unicodedata.normalize("NFD", c) for c in points]
    pairs = [p for p in pairs if len(p) == 2]
    assert "\U00011935\U00011930" in pairs
    for texts in (points, pairs):
        for chunk in _chunks(texts):
            text = "\n".join(chunk)
            assert nfc(text) == ref.normalize_str(text), chunk[:3]
    assert nfc("a\U00011935\U00011930b") == "a\U00011935\U00011930b"
    assert nfc("\U00011938") == "\U00011938"
