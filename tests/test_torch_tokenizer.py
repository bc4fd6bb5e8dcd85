"""The port's tokenizer (standard-library `re`) vs the JAX package's (the
`regex` package): identical ids on the zero-shot prompts."""
import numpy as np

from megatron_clip_tpu.tokenizer.clip_bpe import SimpleTokenizer as JaxTokenizer
from megatron_clip_tpu_torch import tokenize
from megatron_clip_tpu_torch.evaluation.zero_shot import (
    SIMPLE_IMAGENET_TEMPLATES, load_imagenet_metadata)
from megatron_clip_tpu_torch.tokenizer.clip_bpe import SimpleTokenizer


def test_known_oracle_ids():
    assert tokenize(["a photo of a cat"])[0, :7].tolist() == [
        49406, 320, 1125, 539, 320, 2368, 49407]


def test_ids_match_jax_tokenizer_on_zero_shot_prompts():
    """All 1000 class names x the 7 simple templates, plus a fixed sample of
    3000 from the 1000 x 80 vendored template grid."""
    classnames, templates = load_imagenet_metadata()
    prompts = [t(c) for c in classnames for t in SIMPLE_IMAGENET_TEMPLATES]
    rng = np.random.default_rng(0)
    for ci, ti in zip(rng.integers(0, len(classnames), 3000),
                      rng.integers(0, len(templates), 3000)):
        prompts.append(templates[ti](classnames[ci]))
    got = SimpleTokenizer()(prompts)
    want = JaxTokenizer()(prompts)
    assert got.dtype == want.dtype and got.shape == (len(prompts), 77)
    np.testing.assert_array_equal(got, want)


def test_ids_match_on_mixed_text():
    texts = ["Hello,  World!! it's 2024 -- e=mc^2 & <b>bold</b>",
             "snake_case_names and CamelCase; naïve café über",
             "emoji 🙂 and ümlauts, 3.14159 x10", "  ", "a" * 200]
    np.testing.assert_array_equal(SimpleTokenizer()(texts),
                                  JaxTokenizer()(texts))
