"""Beam search decoding.

Counterpart of `megatron_clip_tpu/inference/beam_search.py` (megatron's
beam_search, text_generation/api.py and generation.py's beam loop): a
static beam width, a Python loop over the decode steps on the cached
forward of `inference/generation.py`, and the KV cache reindexed with the
beams' parents each step (`index_select` on the batch axis). Finished
beams are frozen: they extend only with the EOS, at no cost (`NEG`
elsewhere). The scores are divided by the length to the power of the
length penalty, as megatron's beam scorer divides them.

`pp_beam_search`, the beam loop over the pipeline's staged forward, waits
for the pipeline (ROADMAP Queue A item 5) and raises.
"""
from typing import Optional

import torch

from megatron_clip_tpu_torch.inference.generation import (
    KVCache, _forward_cached, _tensor_group, decode_params,
    default_compute_dtype)

NEG = -1e9


def _beam_program(fwd, params, prompt: torch.Tensor, cache: KVCache, *,
                  beam_size: int, max_new_tokens: int, eos_id: int,
                  length_penalty: float):
    """The beam loop over a cached forward `fwd(params, tokens, pos, cache)
    -> (logits, cache)`, whose cache rows are beam-flattened [.., B*K, ..];
    returns (tokens [B, K, P+N], scores [B, K]) sorted best-first."""
    b, p = prompt.shape
    k = beam_size
    max_len = p + max_new_tokens
    dev = prompt.device

    # the prompt expanded to beams: [B*K, P]
    logits, cache = fwd(params, prompt.repeat_interleave(k, dim=0), 0, cache)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, k, -1)
    v = logp.shape[-1]
    # the first step: only beam 0 is live (the others repeat the prompt)
    scores, tok = torch.topk(logp[:, 0], k, dim=-1)          # [B, K]
    out = torch.zeros(b, k, max_len, dtype=torch.long, device=dev)
    out[:, :, :p] = prompt[:, None]
    out[:, :, p] = tok
    finished = tok == eos_id
    # finished beams only extend with the EOS, at no extra cost
    frozen = torch.full((v,), NEG, device=dev)
    frozen[eos_id] = 0.0
    base = (torch.arange(b, device=dev) * k)[:, None]
    gen_len = torch.ones(b, k, device=dev)  # the first token is out already
    for i in range(max_new_tokens - 1):
        logits, cache = fwd(params, tok.reshape(b * k, 1), p + i, cache)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
        logp = torch.where(finished[..., None], frozen, logp.reshape(b, k, v))
        total = scores[..., None] + logp                     # [B, K, V]
        scores, idx = torch.topk(total.reshape(b, k * v), k, dim=-1)
        parents = idx // v
        tok = idx % v
        out = out.gather(1, parents[..., None].expand(-1, -1, max_len))
        out[:, :, p + 1 + i] = tok
        was_done = finished.gather(1, parents)
        # a beam's length counts its tokens through its first EOS; a frozen
        # beam's EOS padding does not count
        gen_len = gen_len.gather(1, parents) + (1.0 - was_done.float())
        finished = was_done | (tok == eos_id)
        flat = (base + parents).reshape(-1)
        cache = KVCache(cache.k.index_select(1, flat),
                        cache.v.index_select(1, flat))

    # megatron's beam scorer divides by length ** penalty unconditionally,
    # the default penalty 1 included
    scores = scores / gen_len ** length_penalty
    order = torch.argsort(-scores, dim=1, stable=True)
    scores = scores.gather(1, order)
    out = out.gather(1, order[..., None].expand(-1, -1, max_len))
    return out, scores


@torch.no_grad()
def beam_search(model, prompt: torch.Tensor, *, beam_size: int = 4,
                max_new_tokens: int = 32, eos_id: int = 0,
                length_penalty: float = 1.0,
                compute_dtype: Optional[torch.dtype] = None):
    """prompt: [B, P] int64 (one length) on `model`'s device. Returns
    (tokens [B, K, P+N], scores [B, K]) sorted best-first per row."""
    b, p = prompt.shape
    dev = prompt.device
    dtype = compute_dtype or default_compute_dtype(dev)
    params = decode_params(model, dtype)
    cache = KVCache.create(model.cfg, b * beam_size, p + max_new_tokens,
                           device=dev, tp=model.tp)
    group = _tensor_group(model)

    def fwd(prm, toks, pos, c):
        return _forward_cached(prm, toks, pos, c, model.cfg, dtype, group)
    return _beam_program(fwd, params, prompt, cache, beam_size=beam_size,
                         max_new_tokens=max_new_tokens, eos_id=eos_id,
                         length_penalty=length_penalty)


def pp_beam_search(*args, **kwargs):
    """The beam loop over the pipeline's staged forward: not ported yet."""
    raise NotImplementedError(
        "pp_beam_search: pipeline-parallel decoding is not ported yet "
        "(ROADMAP Queue A item 5)")
