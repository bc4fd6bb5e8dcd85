"""The port's megatron tokenizers and `tools/preprocess_data.py`, on the
CPU.

- `GPT2BPETokenizer` (the port's byte-level BPE on the standard library's
  `re`) against `tokenizers`' ByteLevelBPETokenizer, the backend of the JAX
  package's class, on a vocab.json / merges.txt this file trains with
  `tokenizers` from text it writes (accents, CJK, digits beyond ASCII,
  marks, whitespace runs and kinds, contractions, emoji): the same ids, and
  the same decoded text.
- `NullTokenizer`, vocabulary padding and the tokenizers the port refuses.
- The port's `preprocess_data` output byte-equal to the JAX tool's on one
  jsonl, for clip-bpe, NullTokenizer and GPT2BPETokenizer, with --workers 1
  and 2 (the JAX tool with one worker: its order does not depend on them).
"""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

from megatron_clip_tpu.tokenizer import megatron_tokenizers as jax_mt
from megatron_clip_tpu_torch.tokenizer import megatron_tokenizers as mt
from megatron_clip_tpu_torch.tools import preprocess_data

TEXTS = [
    "Hello world! It's a café — naïve résumé, don't we'll they've I'm.",
    "数字 123 4567 ８９ ½ ² Ωμέγα Привет мир 日本語のテキスト",
    "   leading spaces\t\ttabs\n\nnewlines   trailing   ",
    "a\x1cb　c d e​f",
    "CamelCase snake_case kebab-case $100.00 #hash @user http://x.y/z?q=1",
    "combining x́ è́ and ZWJ \U0001F468‍\U0001F469",
    "'S 'T 'Re shouldn't you'd o'clock ''quoted''",
    "ٱلْعَرَبِ हिन्दी ไทย 한국어",
    "emoji 😀😃 🇫🇷, tab\tthen line sep",
]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """vocab.json and merges.txt trained by `tokenizers` on TEXTS."""
    from tokenizers import ByteLevelBPETokenizer
    root = tmp_path_factory.mktemp("bpe")
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(TEXTS * 20, vocab_size=420, min_frequency=1,
                            special_tokens=["<|endoftext|>"])
    tok.save_model(str(root))
    return str(root / "vocab.json"), str(root / "merges.txt")


@pytest.fixture(scope="module")
def tokenizers_pair(bpe_files):
    from tokenizers import ByteLevelBPETokenizer
    return (mt.GPT2BPETokenizer(*bpe_files),
            ByteLevelBPETokenizer(*bpe_files))


@pytest.mark.parametrize("text", TEXTS + [
    "", " ", "x", "unseen wörds ünd çhars 龍", "a  b   c    d\n \n"])
def test_gpt2_bpe_equals_tokenizers(tokenizers_pair, text):
    mine, ref = tokenizers_pair
    ids = mine.tokenize(text)
    assert ids == ref.encode(text).ids
    assert mine.detokenize(ids) == ref.decode(ids) == text


def test_gpt2_bpe_properties_equal_the_jax_class(bpe_files):
    mine = mt.GPT2BPETokenizer(*bpe_files)
    theirs = jax_mt.GPT2BPETokenizer(*bpe_files)
    assert mine.vocab_size == theirs.vocab_size
    assert mine.eod == theirs.eod == 0
    text = " ".join(TEXTS)
    assert mine.tokenize(text) == theirs.tokenize(text)
    ids = mine.tokenize(text)
    assert mine.detokenize(ids) == theirs.detokenize(ids)


def test_gpt2_bpe_without_an_endoftext_token_takes_the_last_id(tmp_path):
    vocab = {c: i for i, c in enumerate("abcdefg")}
    (tmp_path / "v.json").write_text(json.dumps(vocab))
    (tmp_path / "m.txt").write_text("#version: 0.2\n")
    tok = mt.GPT2BPETokenizer(str(tmp_path / "v.json"),
                              str(tmp_path / "m.txt"))
    assert tok.eod == 6 and tok.tokenize("gab") == [6, 0, 1]


def test_null_tokenizer_equals_the_jax_one():
    for n in (0, 7, 50303):
        a, b = mt.NullTokenizer(n), jax_mt.NullTokenizer(n)
        assert (a.vocab_size, a.eod) == (b.vocab_size, b.eod)
        assert a.tokenize(" 3 14  15\n") == b.tokenize(" 3 14  15\n") \
            == [3, 14, 15]
        assert a.detokenize([3, 14]) == b.detokenize([3, 14]) == "3 14"


@pytest.mark.parametrize("size,d,tp", [(50257, 128, 1), (50257, 128, 2),
                                       (256, 128, 1), (1, 64, 4)])
def test_vocab_padding_equals_the_jax_one(size, d, tp):
    assert mt.vocab_size_with_padding(size, d, tp) == \
        jax_mt.vocab_size_with_padding(size, d, tp)


@pytest.mark.parametrize("kind,item", [
    ("BertWordPieceLowerCase", 7), ("bert-wordpiece-upper-case", 7),
    ("SentencePieceTokenizer", 4), ("Llama2Tokenizer", 4)])
def test_unported_tokenizers_name_their_queue_item(kind, item):
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        mt.build_tokenizer(kind, vocab_file="v.txt",
                           tokenizer_model="m.model")


def test_build_tokenizer_dispatch(bpe_files):
    assert isinstance(mt.build_tokenizer("GPT2BPETokenizer",
                                         vocab_file=bpe_files[0],
                                         merge_file=bpe_files[1]),
                      mt.GPT2BPETokenizer)
    assert mt.build_tokenizer("NullTokenizer").vocab_size == 1
    assert mt.build_tokenizer("clip").vocab_size == 49408
    with pytest.raises(ValueError, match="unknown tokenizer"):
        mt.build_tokenizer("Whitespace")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_preprocess_data",
        Path(__file__).resolve().parents[1] / "tools" / "preprocess_data.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    """A jsonl of 80 documents (words of TEXTS' ASCII and accented lines,
    or ids for the null tokenizer), with an empty text, a line that is not
    JSON and a document under another key among them."""
    root = tmp_path_factory.mktemp("jsonl")
    rng = np.random.default_rng(0)
    words = (TEXTS[0] + " " + TEXTS[4]).split()
    lines = []
    for i in range(80):
        n = int(rng.integers(1, 40))
        text = " ".join(rng.choice(words, n))
        lines.append(json.dumps({"text": text, "ids": " ".join(
            str(int(t)) for t in rng.integers(0, 999, n))}))
    lines[5] = json.dumps({"text": ""})
    lines[9] = "not json"
    lines[11] = json.dumps({"other": "x"})
    path = root / "corpus.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def jax_outputs(jsonl, bpe_files, tmp_path_factory):
    """The JAX tool's corpus, one worker, for each tokenizer."""
    root = tmp_path_factory.mktemp("jax_pre")
    tool = _jax_tool()
    out = {}
    for name, argv in _CASES.items():
        prefix = str(root / name)
        tool.main(["--input", jsonl, "--output-prefix", prefix]
                  + _argv(argv, bpe_files))
        out[name] = prefix
    return out


_CASES = {
    "clip-bpe": ["--tokenizer", "clip-bpe", "--append-eod"],
    "null": ["--tokenizer", "NullTokenizer", "--json-key", "ids"],
    "null-eod": ["--tokenizer", "NullTokenizer", "--json-key", "ids",
                 "--append-eod"],
    "gpt2": ["--tokenizer", "GPT2BPETokenizer", "--vocab-file", "{vocab}",
             "--merge-file", "{merges}", "--append-eod"],
}


def _argv(argv, bpe_files):
    return [a.format(vocab=bpe_files[0], merges=bpe_files[1]) for a in argv]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("case", list(_CASES))
def test_preprocess_output_is_the_jax_tools(jsonl, bpe_files, jax_outputs,
                                            tmp_path, case, workers):
    prefix = str(tmp_path / "port")
    out = preprocess_data.main(
        ["--input", jsonl, "--output-prefix", prefix, "--workers",
         str(workers)] + _argv(_CASES[case], bpe_files))
    assert out["docs"] == 77 and out["tokens"] > 0
    for ext in (".bin", ".idx"):
        assert open(prefix + ext, "rb").read() == \
            open(jax_outputs[case] + ext, "rb").read(), ext


def test_an_hf_tokenizer_is_refused(jsonl, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item 7\\)"):
        preprocess_data.main(["--input", jsonl, "--output-prefix",
                              str(tmp_path / "x"), "--tokenizer", "hf:gpt2"])
    assert not os.path.exists(str(tmp_path / "x") + ".idx")
