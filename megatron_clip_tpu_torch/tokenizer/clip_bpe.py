"""CLIP byte-pair-encoding tokenizer.

A copy of `megatron_clip_tpu/tokenizer/clip_bpe.py` (open_CLIP's
SimpleTokenizer / tokenize): byte-level BPE over the 49,152-merge OpenAI CLIP
vocabulary, <|startoftext|>=49406, <|endoftext|>=49407, context length 77,
lowercasing and whitespace cleanup. The merges file is vendored under
`tokenizer/assets/`; $MCT_BPE_PATH overrides it.

It needs only the standard library's `re`, not the `regex` package: the
pre-tokenizer's \\p{L}+ becomes [^\\W\\d_]+ (word characters that are neither
digits nor underscore), \\p{N} becomes \\d, and [^\\s\\p{L}\\p{N}]+ becomes
(?:[^\\s\\w]|_)+. The two agree on letters, decimal digits, punctuation and
whitespace; they can split differently only on numeric characters that are
not decimal digits (e.g. superscripts, vulgar fractions). `ftfy` is used
when installed, as in the reference.
"""
import functools
import gzip
import html
import os
import re
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

VOCAB_SIZE = 49408          # 256 bytes*2 + 48894 merges + 2 specials
SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77

_VOCAB_CANDIDATES = [
    os.environ.get("MCT_BPE_PATH", ""),
    str(Path(__file__).parent / "assets" / "bpe_simple_vocab_16e6.txt.gz"),
]

_PRETOKENIZE = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                r"[^\W\d_]+|\d|(?:[^\s\w]|_)+")


def find_bpe_vocab() -> Optional[str]:
    for p in _VOCAB_CANDIDATES:
        if p and os.path.isfile(p):
            return p
    return None


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2-style reversible byte<->unicode map: printable bytes map to
    themselves, the rest to codepoints 256+."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    mapped = list(printable)
    extra = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            mapped.append(256 + extra)
            extra += 1
    return dict(zip(printable, (chr(c) for c in mapped)))


def _adjacent_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean_text(text: str) -> str:
    # open_CLIP runs ftfy.fix_text + html.unescape twice + whitespace collapse
    # + lower. ftfy (mojibake repair) is optional here.
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 context_length: int = CONTEXT_LENGTH):
        bpe_path = bpe_path or find_bpe_vocab()
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE merges file not found. Set $MCT_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz (from OpenAI CLIP / open_clip).")
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:48894 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        if len(vocab) != VOCAB_SIZE:
            raise ValueError(f"{bpe_path}: vocabulary of {len(vocab)} tokens, "
                             f"expected {VOCAB_SIZE}")
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(_PRETOKENIZE, re.IGNORECASE)
        self.sot_token_id = SOT_TOKEN
        self.eot_token_id = EOT_TOKEN
        self.vocab_size = VOCAB_SIZE

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _adjacent_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean_text(text)
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize into a padded [N, context_length] int32 array, SOT ... EOT,
        zero padded; over-long inputs are truncated with EOT forced last."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_token_id] + self.encode(t) + [self.eot_token_id]
            if len(ids) > ctx:
                ids = ids[:ctx]
                ids[-1] = self.eot_token_id
            out[i, :len(ids)] = ids
        return out


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    return _default_tokenizer()(texts, context_length)


def get_tokenizer(model_name: str = "") -> SimpleTokenizer:
    """open_CLIP get_tokenizer analogue. Every model of this slice uses the
    CLIP BPE tokenizer; HF text towers come with a later slice."""
    return _default_tokenizer()
