"""Autoregressive generation with a static KV cache.

Counterpart of `megatron_clip_tpu/inference/generation.py` (megatron's
text_generation/generation.py, forward_step.py's InferenceParams and
sampling.py), as plain functions on tensors:
  - the KV cache is a preallocated [L, B, Hkv, S_max, D] pair (`KVCache`),
    bf16 on every device, as the JAX package makes it, so that an fp32 run
    rounds K and V to bf16 as the JAX one does, and read back in the
    compute dtype;
  - prefill runs the padded prompt once at positions 0..P-1 and fills the
    cache; each row then writes its tokens at its own position
    (prompt_len + i, a per-row scatter), and the per-row mask
    `col <= pos + row` hides the stale pad entries behind each row's
    frontier;
  - the decode is a Python loop of exactly `max_new_tokens` steps, the JAX
    scan's: no early exit, and no host sync a token (finished rows go on
    with token 0; `n_gen` counts the EOS);
  - sampling (`_sample`): greedy, temperature, top-k (`logits < kth`, so
    ties are kept) and top-p with --top-p-decay / --top-p-bound per step.

The functions read a `GPTModel`'s parameters as they are (the [in, out]
layout, the unstacked blocks), through `decode_params`: the matrices and
biases cast once to the compute dtype, where the JAX decode casts them at
each use (the same values); the norms' parameters as they are. The decode
rounds as the JAX decode does: each projection is a product in x's dtype,
its bias added afterwards (not the training `ops/dense.py`'s one-rounding
addmm), and the tied head is a product in the compute dtype, then cast to
fp32. Attention is the plain `ops/attention.sdpa` with an additive mask, as
the JAX decode calls its jnp `sdpa`; the norms run the LayerNorm / RMSNorm
kernels on the card.

Positions past a learned position table reuse its last row: JAX clamps an
out-of-range gather index (`params["pos_embed"][positions]`), and the port
clamps the same way (a reference defect kept for parity, ROADMAP).

The sampling draw: `jax.random.categorical` is argmax(logits + Gumbel
noise) from JAX's key stream, which torch cannot reproduce; the port draws
the Gumbel noise from a `torch.Generator` on the logits' device seeded with
the request's seed (a deviation kept on purpose, ROADMAP). `noise=` takes
the draws instead, so that a test can feed JAX's own.

The compute dtype is bf16 on the card and fp32 on the CPU, as the JAX
decode picks it by backend, whatever the checkpoint's dtype; a caller may
pass another (`compute_dtype`). Under tensor parallelism (a model sharded
by `parallel/sharding.shard_model` over its layout's tensor group) each
rank holds its heads of the packed wqkv and its halves of the swiglu w1,
and rows of wo and w2, decodes its own kv heads into its own cache, and
all-reduces the outputs of wo and w2 over the tensor group before their
biases; the embedding and the lm head are gathered whole once per call, so
every rank computes the same logits and samples the same token.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from megatron_clip_tpu_torch.nn.transformer import apply_norm
from megatron_clip_tpu_torch.ops.activations import bias_act, swiglu
from megatron_clip_tpu_torch.ops.attention import sdpa
from megatron_clip_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from megatron_clip_tpu_torch.parallel import collectives
from megatron_clip_tpu_torch.parallel.sharding import full

class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, Hkv, S_max, D]
    v: torch.Tensor

    @classmethod
    def create(cls, cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, tp: int = 1) -> "KVCache":
        """Zeros for `cfg`'s (a GPTCfg) layers; `tp` tensor ranks each hold
        kv_heads / tp heads."""
        t = cfg.transformer()
        hkv = (t.kv_heads or t.heads) // tp
        k = torch.zeros((t.layers, batch, hkv, max_len, t.head_dim),
                        dtype=dtype, device=device)
        return cls(k, torch.zeros_like(k))


def default_compute_dtype(device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU (the JAX decode's rule)."""
    return (torch.float32 if torch.device(device).type == "cpu"
            else torch.bfloat16)


def decode_params(model, dtype: torch.dtype) -> dict:
    """`model`'s parameters as the decode reads them, by the JAX pytree's
    names: `tok_embed` (whole, a sharded model's gathered), `pos_embed`,
    `blocks` (one dict a block: `attn`, `mlp`, `ln_1`, `ln_2`; a tensor
    rank's shards), `ln_f` and an untied `lm_head` (whole). Matrices and
    biases in `dtype`, the norms' parameters as they are."""
    def cast(t):
        return t.detach().to(dtype)
    out = {"tok_embed": cast(model.embedding())}
    if hasattr(model, "pos_embed"):
        out["pos_embed"] = cast(model.pos_embed)
    out["blocks"] = []
    for block in model.blocks:
        w = block.weights(dtype)
        out["blocks"].append({
            "attn": {k: cast(t) for k, t in w["attn"].items()},
            "mlp": {k: cast(t) for k, t in w["mlp"].items()},
            "ln_1": {k: t.detach() for k, t in w["ln_1"].items()},
            "ln_2": {k: t.detach() for k, t in w["ln_2"].items()}})
    out["ln_f"] = {k: t.detach() for k, t in model.ln_f.items()}
    if not model.cfg.tie_embeddings:
        out["lm_head"] = cast(full(model, "lm_head"))
    return out


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Decode projection: the product in x's dtype (its bias, where there is
    one, is added by the caller)."""
    return torch.matmul(x, w.to(x.dtype))


def _add_bias(h: torch.Tensor, group: dict, name: str) -> torch.Tensor:
    b = group.get(name)
    return h if b is None else h + b.to(h.dtype)


def _decode_mask(pos, b: int, t: int, s_max: int, device):
    """The cache slots the T new tokens write and may attend to, shared by
    every block of one forward: (rows [B, 1], at [B, T], the per-row write
    positions, or None for an int `pos`; bias, 0 where the key's column is
    at most the token's position, -1e30 elsewhere: [B, 1, T, S_max] per
    row, [1, 1, T, S_max] shared). With per-row positions this also hides
    the stale pad-prompt entries behind each row's frontier."""
    col = torch.arange(s_max, device=device)
    row = torch.arange(t, device=device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        at = pos[:, None] + row[None]                           # [B, T]
        bias = torch.where(col[None, None] <= at[..., None], 0.0, -1e30)
        return torch.arange(b, device=device)[:, None], at, bias[:, None]
    bias = torch.where(col[None] <= pos + row[:, None], 0.0, -1e30)
    return None, None, bias[None, None]


def _block_decode(block: dict, x: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos, cfg, rope, mask,
                  group=None) -> torch.Tensor:
    """One block, one token a row (or the P prompt tokens), reading and
    writing this layer's cache in place. x: [B, T, W]; cache_[kv]: [B, Hkv,
    S_max, D]; `pos`: an int write offset shared by the rows, or a [B]
    tensor of per-row offsets (ragged prompts: each row in-fills at its own
    length). `cfg`: the TransformerCfg; `rope`: the (cos, sin) tables for
    these positions, [T, R] or [B, T, R]; `mask`: `_decode_mask`'s;
    `group`: the tensor group whose ranks hold the other heads and MLP
    columns (None: all here)."""
    b, t, _ = x.shape
    tp = collectives.size(group)
    heads = cfg.heads // tp
    hkv = (cfg.kv_heads or cfg.heads) // tp
    hd = cfg.head_dim
    attn, mlp = block["attn"], block["mlp"]
    h = apply_norm(block["ln_1"], x, cfg.norm)
    qkv = _add_bias(_dense(h, attn["wqkv"]), attn, "bqkv")
    q, k, v = (part.reshape(b, t, n, hd).transpose(1, 2)
               for part, n in zip(qkv.split([heads * hd, hkv * hd, hkv * hd],
                                            dim=-1), (heads, hkv, hkv)))
    if rope is not None:
        cos, sin = rope
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    rows, at, bias = mask
    if at is not None:
        # advanced indices around a slice: the value is [B, T, Hkv, D]
        cache_k[rows, :, at] = k.transpose(1, 2).to(cache_k.dtype)
        cache_v[rows, :, at] = v.transpose(1, 2).to(cache_v.dtype)
    else:
        cache_k[:, :, pos:pos + t] = k.to(cache_k.dtype)
        cache_v[:, :, pos:pos + t] = v.to(cache_v.dtype)
    kh, vh = cache_k.to(x.dtype), cache_v.to(x.dtype)
    if hkv != heads:
        kh = kh.repeat_interleave(heads // hkv, dim=1)
        vh = vh.repeat_interleave(heads // hkv, dim=1)
    att = sdpa(q, kh, vh, bias=bias)
    att = att.transpose(1, 2).reshape(b, t, heads * hd)
    att = _dense(att, attn["wo"])
    if group is not None:
        collectives.all_reduce(att, group)
    x = x + _add_bias(att, attn, "bo")

    h = apply_norm(block["ln_2"], x, cfg.norm)
    h = _dense(h, mlp["w1"])
    b1 = mlp.get("b1")
    b1 = None if b1 is None else b1.to(h.dtype)
    h = swiglu(h, b1) if cfg.act == "swiglu" else bias_act(h, b1, cfg.act)
    h = _dense(h, mlp["w2"])
    if group is not None:
        collectives.all_reduce(h, group)
    return x + _add_bias(h, mlp, "b2")


def _clamped_start(pos: int, t: int, n: int) -> int:
    """A dynamic slice's start, clamped so that t rows fit in n, as
    `jax.lax.dynamic_slice` clamps it."""
    return max(0, min(pos, n - t))


def _forward_cached(params: dict, tokens: torch.Tensor, pos,
                    cache: KVCache, cfg, compute_dtype: torch.dtype,
                    group=None):
    """tokens [B, T] at position `pos` (int, or a [B] tensor of per-row
    positions) through every block, writing the cache. `params`:
    `decode_params`'s; `cfg`: the GPTCfg. Returns (logits [B, T, V] fp32,
    cache)."""
    tcfg = cfg.transformer()
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    t = tokens.shape[1]
    dev = tokens.device
    x = F.embedding(tokens, params["tok_embed"]).to(compute_dtype)
    positions = (pos[:, None] + torch.arange(t, device=dev)[None]
                 if per_row else None)
    if "pos_embed" in params:
        table = params["pos_embed"]
        n = table.shape[0]
        if per_row:
            # a gather past the table reads its last row, as JAX clamps it
            x = x + table[positions.clamp(max=n - 1)].to(compute_dtype)
        else:
            start = _clamped_start(pos, t, n)
            x = x + table[start:start + t].to(compute_dtype)[None]
    rope = None
    if tcfg.rope:
        s_max = cache.k.shape[3]
        cos, sin = rope_cos_sin(
            s_max, tcfg.head_dim, tcfg.rope_theta,
            rotary_percent=tcfg.rotary_percent,
            seq_len_interpolation_factor=tcfg.rope_interpolation, device=dev)
        if per_row:
            at = positions.clamp(max=s_max - 1)
            rope = (cos[at], sin[at])                           # [B, T, R]
        else:
            start = _clamped_start(pos, t, s_max)
            rope = (cos[start:start + t], sin[start:start + t])
    mask = _decode_mask(pos, tokens.shape[0], t, cache.k.shape[3], dev)
    for i, block in enumerate(params["blocks"]):
        x = _block_decode(block, x, cache.k[i], cache.v[i], pos, tcfg, rope,
                          mask, group)
    x = apply_norm(params["ln_f"], x, cfg.normalization)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["tok_embed"].to(x.dtype).t())
    else:
        logits = _dense(x, params["lm_head"])
    return logits.float(), cache


def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p) -> torch.Tensor:
    """The logits `_sample` draws from (megatron sampling.py semantics):
    divided by the temperature, then those below the k-th largest (ties
    kept) and those outside the smallest set whose probability reaches
    `top_p` (None: off; a float, the step's decayed threshold) set to
    -1e30."""
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        # all below top_p: JAX's take_along_axis fills with NaN past the
        # end, and nothing is masked; the last (smallest) logit masks none
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -1e30)
    return logits


def gumbel(shape, generator: torch.Generator,
           device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) of uniforms from `generator`
    (u kept above the smallest normal float, as JAX's `gumbel` keeps it)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def _sample(logits: torch.Tensor, temperature: float, top_k: int, top_p,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B]: the argmax at temperature 0, else the
    argmax of `_filter_logits` plus Gumbel noise (`jax.random.categorical`
    is that argmax): `noise` where given, else drawn from `generator`."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = _filter_logits(logits, temperature, top_k, top_p)
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    return (logits + noise.to(logits.device)).argmax(dim=-1)


def decayed_top_p(top_p: float, top_p_decay: float, top_p_bound: float,
                  step: int) -> float:
    """--top-p-decay's threshold at decode step `step`, in fp32 as the JAX
    scan computes it: max(bound, top_p * decay ** step), the power taken
    in fp64 and rounded (XLA's fp32 power on the CPU agrees with it within
    an ulp, numpy's fp32 power less often)."""
    f32 = np.float32
    power = f32(np.float64(f32(top_p_decay)) ** step)
    return float(max(f32(top_p_bound), f32(top_p) * power))


def _decode_program(fwd, params, prompt: torch.Tensor,
                    prompt_len: torch.Tensor, cache: KVCache, *,
                    max_new_tokens: int, temperature: float, top_k: int,
                    top_p: float, eos_id: int, seed: int,
                    return_lengths: bool, top_p_decay: float,
                    top_p_bound: float, return_logprobs: bool = False,
                    noise: Optional[torch.Tensor] = None):
    """The prefill and the decode loop. `fwd(params, tokens, pos, cache) ->
    (logits, cache)` is the model forward (`_forward_cached`).

    With return_logprobs, also returns `lp` [B, P+max_new-1], where
    lp[:, j] is the log-probability of out[:, j+1] given its prefix; the
    entries in each row's pad gap (between prompt_len and P) are undefined,
    as in the JAX package and megatron. `noise` [max_new, B, V]: each
    step's Gumbel draws (else from a generator seeded with `seed`)."""
    b, p = prompt.shape
    max_len = p + max_new_tokens
    dev = prompt.device
    rows = torch.arange(b, device=dev)

    # the padded prompt at shared positions 0..P-1: right for every row's
    # real tokens; the pad region's cache entries stay behind each row's
    # frontier and are overwritten as generation in-fills them
    logits, cache = fwd(params, prompt, 0, cache)
    last = logits[rows, prompt_len - 1]

    lp = None
    if return_logprobs:
        lp = torch.zeros(b, max_len - 1, device=dev)
        plp = torch.log_softmax(logits[:, :-1], dim=-1)
        lp[:, :p - 1] = plp.gather(-1, prompt[:, 1:, None])[..., 0]

    out = torch.zeros(b, max_len, dtype=torch.long, device=dev)
    out[:, :p] = prompt
    gen = None
    if temperature != 0.0 and noise is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    tp0 = top_p if (top_p and top_p < 1.0) else None
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    n_gen = torch.zeros(b, dtype=torch.long, device=dev)
    for i in range(max_new_tokens):
        tp_i = tp0
        if tp0 is not None and top_p_decay:
            tp_i = decayed_top_p(tp0, top_p_decay, top_p_bound, i)
        tok = _sample(last, temperature, top_k, tp_i, gen,
                      None if noise is None else noise[i])
        tok = torch.where(done, 0, tok)
        wpos = prompt_len + i                       # per-row write position
        out[rows, wpos] = tok
        if lp is not None:
            lp[rows, wpos - 1] = torch.log_softmax(last, dim=-1).gather(
                -1, tok[:, None])[:, 0]
        n_gen += (~done).long()
        done |= tok == eos_id
        logits, cache = fwd(params, tok[:, None], wpos, cache)
        last = logits[:, 0]
    res = (out,)
    if return_lengths:
        res += (n_gen,)
    if return_logprobs:
        res += (lp,)
    return res if len(res) > 1 else out


def _tensor_group(model):
    """The tensor group of a tensor-parallel model, else None."""
    return model.layout.tensor if model.tp > 1 else None


@torch.no_grad()
def generate(model, prompt: torch.Tensor, prompt_len: torch.Tensor, *,
             max_new_tokens: int = 32, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0, eos_id: int = -1,
             seed: int = 0, return_lengths: bool = False,
             top_p_decay: float = 0.0, top_p_bound: float = 0.0,
             return_logprobs: bool = False,
             noise: Optional[torch.Tensor] = None,
             compute_dtype: Optional[torch.dtype] = None):
    """prompt: [B, P] int64 right-padded, prompt_len: [B] actual lengths,
    both on `model`'s device. Returns tokens [B, P + max_new_tokens] with
    the generations in-filled at each row's own prompt_len (megatron
    text_generation/generation.py semantics), and with return_lengths the
    [B] counts of generated tokens (the EOS included, when one was
    produced), with return_logprobs the log-probabilities (see
    `_decode_program`)."""
    b, p = prompt.shape
    dev = prompt.device
    dtype = compute_dtype or default_compute_dtype(dev)
    params = decode_params(model, dtype)
    cache = KVCache.create(model.cfg, b, p + max_new_tokens, device=dev,
                           tp=model.tp)
    group = _tensor_group(model)

    def fwd(prm, toks, pos, c):
        return _forward_cached(prm, toks, pos, c, model.cfg, dtype, group)
    return _decode_program(
        fwd, params, prompt, prompt_len, cache,
        max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
        top_p=top_p, eos_id=eos_id, seed=seed, return_lengths=return_lengths,
        top_p_decay=top_p_decay, top_p_bound=top_p_bound,
        return_logprobs=return_logprobs, noise=noise)


def greedy_generate(model, prompt: torch.Tensor, max_new_tokens: int = 32,
                    eos_id: int = -1) -> torch.Tensor:
    b, p = prompt.shape
    prompt_len = torch.full((b,), p, dtype=torch.long, device=prompt.device)
    return generate(model, prompt, prompt_len, max_new_tokens=max_new_tokens,
                    temperature=0.0, eos_id=eos_id)
