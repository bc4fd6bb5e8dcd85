"""Shared helpers of the generation tests (`test_torch_generation.py`,
`test_torch_beam_search.py`, `test_torch_inference_server.py`,
`test_torch_tp_serving.py`): the small GPT variants, and one model's
weights on both sides, JAX `init_gpt` moved by seeded numpy noise (so that
every bias and norm parameter is away from its init) and bridged into the
port's `GPTModel`."""
import functools

import jax
import numpy as np
import torch

from megatron_clip_tpu.models import gpt as jax_gpt
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.models.gpt import GPTCfg, GPTModel

SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
             seq_length=64)
# learned and rotary positions, partial rotary with grouped-query
# attention (the example GPT's swiglu and rmsnorm), an untied head
VARIANTS = {
    "learned": {},
    "rope": {"position_embedding": "rope"},
    "rope_gqa_partial": {"position_embedding": "rope", "kv_heads": 2,
                         "rotary_percent": 0.5, "swiglu": True,
                         "normalization": "rmsnorm"},
    "untied": {"tie_embeddings": False},
}


def cfgs(variant: str, **over):
    """(the JAX GPTCfg, the port's) of SMALL with the variant's options."""
    kw = dict(SMALL, **VARIANTS[variant], **over)
    return jax_gpt.GPTCfg(**kw), GPTCfg(**kw)


def jax_params(jcfg, seed: int = 0, noise: float = 0.05) -> dict:
    """`init_gpt` from `seed`, every leaf moved by `noise` standard
    normals (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(lambda p: np.asarray(p) + noise * rng.standard_normal(
        p.shape).astype(np.float32), params)


def port_model(params: dict, cfg: GPTCfg) -> GPTModel:
    model = GPTModel(cfg)
    model.load_state_dict(gpt_params_from_jax(params, cfg))
    return model.eval()


@functools.lru_cache(maxsize=None)
def pair(variant: str, **over):
    """(JAX cfg, JAX params, port cfg, port model) of one variant."""
    jcfg, pcfg = cfgs(variant, **over)
    params = jax_params(jcfg)
    return jcfg, params, pcfg, port_model(params, pcfg)


def ragged(batch: int, p: int, vocab: int, seed: int = 1):
    """Right-padded prompts [batch, p] (ids 1..vocab-1, pads 0) of lengths
    p, then shorter ones, and their lengths."""
    rng = np.random.default_rng(seed)
    lens = np.array([max(1, p - 3 * r) for r in range(batch)], np.int64)
    prompt = np.zeros((batch, p), np.int64)
    for r, n in enumerate(lens):
        prompt[r, :n] = rng.integers(1, vocab, n)
    return prompt, lens


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def valid_logprobs(lp, lens, n: int):
    """Each row's log-probabilities outside the pad gap: [0, len-1) of the
    prompt and [len-1, len-1+n) of the generation."""
    lp = np.asarray(lp)
    return [lp[r, :lens[r] - 1 + n] for r in range(len(lens))]
