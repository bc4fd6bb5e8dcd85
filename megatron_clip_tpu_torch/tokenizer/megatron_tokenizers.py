"""Megatron's tokenizers: `build_tokenizer`, vocabulary padding, the null
tokenizer and GPT-2's byte-level BPE.

Counterpart of `megatron_clip_tpu/tokenizer/megatron_tokenizers.py`
(megatron/tokenizer/tokenizer.py), with megatron's contract: `tokenize`,
`detokenize`, `vocab_size` and `eod`. `GPT2BPETokenizer` is the port's own
byte-level BPE over a `vocab.json` / `merges.txt` pair, where the JAX class
wraps the `tokenizers` package's ByteLevelBPETokenizer: the machine with
the card has neither `tokenizers` nor `regex`, so GPT-2's pre-tokenizer
pattern runs on the standard library's `re`, its \\p{L} (letters) and
\\p{N} (numbers) written out as classes of code-point ranges from
`unicodedata`'s general categories, and \\s as Unicode's White_Space set
(Oniguruma's \\s, which `tokenizers` uses; Python's \\s also takes
U+001C-U+001F). Marks (Mn, Mc, Me) fall in neither class, as there. The
ids and the decoded text equal ByteLevelBPETokenizer's with its defaults (no
prefix space, no lowercasing, no added tokens).

BERT WordPiece and SentencePiece (with Llama 2's) raise NotImplementedError,
naming their ROADMAP Queue A items (7 and 4).
"""
import functools
import json
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Tuple

from megatron_clip_tpu_torch.tokenizer.clip_bpe import bytes_to_unicode


def vocab_size_with_padding(orig_size: int, divisible_by: int = 128,
                            tp_size: int = 1) -> int:
    """Pad to a GEMM-friendly multiple (tokenizer.py
    _vocab_size_with_padding)."""
    mult = divisible_by * tp_size
    return ((orig_size + mult - 1) // mult) * mult


class NullTokenizer:
    """Ids are the text (space-separated ints), megatron's NullTokenizer;
    `vocab_size` is the given size plus the EOD id after it."""

    def __init__(self, vocab_size: int):
        self._vocab_size = vocab_size + 1

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def tokenize(self, text: str) -> List[int]:
        return [int(t) for t in text.split()]

    def detokenize(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)

    @property
    def eod(self) -> int:
        return self._vocab_size - 1


# Unicode's White_Space property, which Oniguruma's \s matches
_WHITE_SPACE = ([0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
                + list(range(0x2000, 0x200B))
                + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000])


def _ranges(chars: List[int]) -> str:
    """Code points (sorted) as the body of a character class."""
    out, i = [], 0
    while i < len(chars):
        j = i
        while j + 1 < len(chars) and chars[j + 1] == chars[j] + 1:
            j += 1
        lo, hi = re.escape(chr(chars[i])), re.escape(chr(chars[j]))
        out.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(out)


@functools.lru_cache()
def gpt2_pattern() -> "re.Pattern":
    """GPT-2's pre-tokenizer, `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`, on the standard library's `re`."""
    letters, numbers = [], []
    for c in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat[0] == "L":
            letters.append(c)
        elif cat[0] == "N":
            numbers.append(c)
    L, N = _ranges(letters), _ranges(numbers)
    S = _ranges(_WHITE_SPACE)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
        rf"|[{S}]+(?![^{S}])|[{S}]+")


class GPT2BPETokenizer:
    """GPT-2 byte-level BPE from a local vocab.json (token -> id) and
    merges.txt (one merge "a b" a line, after a "#version" line), megatron
    --vocab-file / --merge-file. `eod` is <|endoftext|>'s id, or the last id
    when the vocabulary has no such token (as the JAX class decides)."""

    def __init__(self, vocab_file: str, merge_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {i: t for t, i in self.encoder.items()}
        with open(merge_file, encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n")
                     if ln and not ln.startswith("#version")]
        self.bpe_ranks = {tuple(ln.split(" ")): i
                          for i, ln in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = gpt2_pattern()
        self.cache: Dict[str, Tuple[str, ...]] = {}
        self._eod = self.encoder.get("<|endoftext|>", len(self.encoder) - 1)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def eod(self) -> int:
        return self._eod

    def bpe(self, token: str) -> Tuple[str, ...]:
        """The pieces of one pre-token (byte-level characters), its
        adjacent pairs merged lowest rank first."""
        word = self.cache.get(token)
        if word is not None:
            return word
        word = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 62))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = word
        return word

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self.bpe(tok))
        return ids

    def detokenize(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytes(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace")


def _refuse(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                              f"item {item})")


def build_tokenizer(tokenizer_type: str, *, vocab_file: Optional[str] = None,
                    merge_file: Optional[str] = None,
                    tokenizer_model: Optional[str] = None,
                    vocab_extra_ids: int = 0,
                    null_vocab_size: int = 0):
    """megatron tokenizer.py build_tokenizer: dispatch by type name, as the
    JAX package spells them."""
    t = tokenizer_type.lower().replace("_", "-")
    if t in ("bertwordpiecelowercase", "bert-wordpiece-lower-case",
             "bert-wordpiece", "bertwordpieceuppercase",
             "bert-wordpiece-upper-case"):
        _refuse("the BERT WordPiece tokenizer", 7)
    if t in ("gpt2bpetokenizer", "gpt2-bpe"):
        return GPT2BPETokenizer(vocab_file, merge_file)
    if t in ("sentencepiecetokenizer", "sentencepiece", "llama2tokenizer"):
        _refuse("the SentencePiece tokenizer", 4)
    if t in ("cliptokenizer", "clip"):
        from megatron_clip_tpu_torch.tokenizer.clip_bpe import SimpleTokenizer
        return SimpleTokenizer()
    if t in ("nulltokenizer", "null"):
        return NullTokenizer(null_vocab_size)
    raise ValueError(f"unknown tokenizer type {tokenizer_type!r}")
