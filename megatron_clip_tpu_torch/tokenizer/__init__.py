"""Tokenizers."""
from megatron_clip_tpu_torch.tokenizer.clip_bpe import (  # noqa: F401
    SimpleTokenizer, get_tokenizer, tokenize)
