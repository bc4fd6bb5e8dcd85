"""Attention ops.

Counterpart of `megatron_clip_tpu/ops/attention.py`. `sdpa` is the plain
oracle; `multi_head_attention` runs the packed QKV GEMM, then one of three
routes, under the JAX package's gates and in its order, forward and, under
autograd, backward, then the output GEMM:
- the fused short-sequence attention kernels (S <= 1024, no rotary
  embeddings, as many k/v heads as query heads, no additive bias);
- the flash-attention kernels (from S = 256 on, when the fused kernels are
  not taken, no additive bias);
- `sdpa_bshd`, the unfused attention on [B, S, H, D] operands, for the
  rest: an additive `bias` (megatron --reset-attention-mask's document
  mask), S below 256 with rope or GQA, head_dim above 128,
  `use_flash=False`, and dropout that neither kernel takes. The JAX
  package computes it in jnp, outside any Pallas kernel, so its port is
  plain PyTorch, and it runs so on the card too: fp32 logits from explicit
  products (never `F.scaled_dot_product_attention`, so that the roundings
  are the JAX einsums'), the bias added in fp32, the causal mask, an fp32
  softmax, then the product with v.
Rotary embeddings rotate the q and k heads of the packed projection
(`ops/rope.py`), with shared [S, R] tables or per-row [B, S, R] ones
(megatron --reset-position-ids); grouped-query attention repeats each k and
v head over its group of query heads (`repeat_interleave`, the JAX
package's `jnp.repeat`), whose gradient sums over the group. CoCa's
cross-attention (`kv=`) and context parallelism belong to later slices of
the port and raise NotImplementedError naming their ROADMAP item.

Attention dropout (megatron --attention-dropout, a rate above 0 with a
`seed`) takes the JAX package's TPU route on every device: the fused
dropout kernels (`fused_mha_dropout`) while the fused gate and the JAX
package's `dropout_kernel_eligible` hold, else the flash kernels with
in-kernel dropout from S = 256 on; on the CPU their plain versions, fed the
kernels' own Philox mask (`ops/dropout.py`). What neither kernel takes runs
`sdpa_bshd`, its probabilities dropped by a keep mask of the port's own
generator (`ops/dropout.hidden_keep` of the step's seed and the site's
offset: the JAX package's `_drop_probs` given its mask). The JAX package
on the CPU takes `sdpa_bshd` for flash dropout too, as
`flash_dropout_supported()` is False in interpret mode. A rate of 0, or no
seed, runs the rate-0 routes.

Under tensor parallelism (`region`, a `parallel/collectives.TensorRegion`)
a rank holds heads / tp query heads and kv_heads / tp k and v heads of
the packed projection (`parallel/sharding.py` splits wqkv on its
segments); the route is picked from the global head counts and the whole
sequence, so that every rank takes the route one process takes; the
column-parallel projection's input enters the region and the row-parallel
output's partial sums leave it before bo is added, once. The dropout of a
rank's heads draws their one-process bits (`ops/dropout.RankSeed`).

Under selective and mlp recompute the `sdpa_bshd` route runs under a
checkpoint of its own: only its inputs are kept, and the logits, the
softmax and the dropout are recomputed in the backward, as the JAX
package's dots-saveable policies keep no product with batch dimensions.

The JAX package's flash path projects straight into [B, H, S, D] so that
the head split costs no copy; here the flash kernels read the heads of the
packed [B, S, 3*H*D] projection in place and write the packed gradient, the
same saving. In bf16 the packed projection rounds once where the JAX BHSD
projection rounds the product and then adds the bias (ROADMAP Queue C,
`ops/dense.py`).
"""
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from megatron_clip_tpu_torch.ops.dense import dense
from megatron_clip_tpu_torch.ops.dropout import (
    dropout_keep_with, hidden_keep, hidden_seed)
from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_qkv)
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    MAX_FUSED_SEQ, MAX_HEAD_DIM, dropout_kernel_eligible, fused_mha,
    fused_mha_dropout)
from megatron_clip_tpu_torch.ops.rope import apply_rope_bshd, apply_rope_qkv

# the JAX package's gate: flash attention from this length on
MIN_FLASH_SEQ = 256


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = False, bias: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention, softmax in fp32.
    q: [B, H, Sq, D], k/v: [B, H, Sk, D]; `bias` (broadcastable to
    [B, H, Sq, Sk]) is added to the fp32 logits before the causal mask,
    as the JAX `sdpa` adds it (the KV-cache decode's mask)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = logits.shape[-2:]
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        # offset handles sq != sk (decoding against a cache)
        logits = logits.masked_fill(row + (sk - sq) < col, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def sdpa_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None, dropout_rate: float = 0.0,
              seed: Optional[int] = None, offset: int = 0,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention on [B, S, H, D] operands (q: [B, Sq, H, D], k/v: [B, Sk,
    H, D]) -> [B, Sq, H, D] in q's dtype: the JAX package's `sdpa_bshd`.
    fp32 logits of q and k times `scale` (default D**-0.5), plus `bias`
    (broadcastable to [B, H, Sq, Sk]) in fp32, the causal mask (-1e30 above
    the diagonal, offset by Sk - Sq), an fp32 softmax, then the
    probabilities cast to q's dtype times v with an fp32 result, cast to
    q's dtype.

    Dropout of the probabilities: `keep` (bool [B, H, Sq, Sk]) where given,
    else, at a `dropout_rate` above 0 with a `seed`, the keep mask of
    `ops/dropout.hidden_keep(seed, offset)`; the kept probabilities are
    divided by 1 - rate in fp32, as the JAX package's `_drop_probs`."""
    dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = logits.shape[-2:]
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(row + (sk - sq) < col, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if keep is None and dropout_rate > 0.0 and seed is not None:
        keep = hidden_keep(probs.shape, dropout_rate, hidden_seed(seed),
                           offset, probs.device)
    if keep is not None:
        probs = dropout_keep_with(probs, keep, dropout_rate)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(
        f"multi_head_attention: {what} is not ported yet (ROADMAP {item})")


def attention_route(s: int, heads: int, kv_heads: Optional[int],
                    head_dim: int, *, rope=None, use_flash: bool = True,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    bias: bool = False) -> str:
    """The JAX package's gates, in its order: "fused" for the fused MHA
    kernels (S <= MAX_FUSED_SEQ without rope or GQA, and with dropout only
    where `dropout_kernel_eligible` holds), "flash" from MIN_FLASH_SEQ on;
    both need head_dim <= 128, `use_flash` and no additive `bias`. The
    rest is "sdpa" (`sdpa_bshd`)."""
    hkv = kv_heads or heads
    if heads % hkv:
        raise ValueError(f"heads {heads} not a multiple of kv_heads {hkv}")
    wants_dropout = dropout_rate > 0.0 and seed is not None
    if not use_flash or bias or head_dim > MAX_HEAD_DIM:
        return "sdpa"
    if (rope is None and hkv == heads and s <= MAX_FUSED_SEQ
            and (not wants_dropout
                 or dropout_kernel_eligible(s, heads, head_dim))):
        return "fused"
    return "flash" if s >= MIN_FLASH_SEQ else "sdpa"


def _sdpa_heads(qkv: torch.Tensor, bias: Optional[torch.Tensor], *,
                heads: int, hkv: int, causal: bool, rope,
                dropout_rate: float, seed: Optional[int],
                offset: int) -> torch.Tensor:
    """The "sdpa" route of `attention_heads`: the packed projection split
    into [B, S, H, D] heads, q and k rotated, k and v repeated over their
    query groups, `sdpa_bshd`, the heads merged."""
    b, s, _ = qkv.shape
    head_dim = qkv.shape[-1] // (heads + 2 * hkv)
    q, k, v = (t.unflatten(-1, (-1, head_dim))
               for t in qkv.split([heads * head_dim, hkv * head_dim,
                                   hkv * head_dim], dim=-1))
    if rope is not None:
        q, k = apply_rope_bshd(q, *rope), apply_rope_bshd(k, *rope)
    if hkv != heads:
        rep = heads // hkv
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    out = sdpa_bshd(q, k, v, causal=causal, bias=bias,
                    dropout_rate=dropout_rate, seed=seed, offset=offset)
    return out.reshape(b, s, heads * head_dim)


def attention_heads(qkv: torch.Tensor, heads: int, route: str, *,
                    causal: bool = False, rope=None,
                    kv_heads: Optional[int] = None,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    offset: int = 0, save_probs: bool = True,
                    bias: Optional[torch.Tensor] = None,
                    recompute: bool = False) -> torch.Tensor:
    """The attention of `multi_head_attention` between its two projections:
    the packed projection qkv [B, S, (H + 2 Hkv) D] -> [B, S, H*D], on the
    route `attention_route` picked ("fused", "flash" or "sdpa"; a `bias`
    only on "sdpa"). `recompute`: the "sdpa" route under a checkpoint of
    its own (selective and mlp recompute)."""
    b, s, _ = qkv.shape
    hkv = kv_heads or heads
    head_dim = qkv.shape[-1] // (heads + 2 * hkv)
    drop = dict(dropout_rate=dropout_rate, seed=seed, offset=offset)
    if route == "sdpa":
        fn = functools.partial(_sdpa_heads, heads=heads, hkv=hkv,
                               causal=causal, rope=rope, **drop)
        if recompute:
            return checkpoint(fn, qkv, bias, use_reentrant=False)
        return fn(qkv, bias)
    if bias is not None:
        raise ValueError(f"an additive bias takes the sdpa route, not "
                         f"{route!r}")
    if route == "fused":
        if dropout_rate > 0.0 and seed is not None:
            return fused_mha_dropout(qkv, heads, causal=causal,
                                     rate=dropout_rate, seed=seed,
                                     offset=offset)
        return fused_mha(qkv, heads, causal=causal, save_probs=save_probs)
    if rope is not None:
        qkv = apply_rope_qkv(qkv, *rope, heads, hkv)
    if hkv == heads:
        return flash_attention_qkv(qkv, heads, causal=causal, **drop)
    q, k, v = (t.unflatten(-1, (-1, head_dim)).transpose(1, 2)
               for t in qkv.split([heads * head_dim, hkv * head_dim,
                                   hkv * head_dim], dim=-1))
    rep = heads // hkv
    out = flash_attention(q, k.repeat_interleave(rep, dim=1),
                          v.repeat_interleave(rep, dim=1), causal=causal,
                          **drop)
    return out.transpose(1, 2).reshape(b, s, heads * head_dim)


def multi_head_attention(x: torch.Tensor, params, heads: int, *,
                         causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         use_flash: bool = True,
                         kv: Optional[torch.Tensor] = None, rope=None,
                         kv_heads: Optional[int] = None,
                         dropout_rate: float = 0.0,
                         seed: Optional[int] = None, offset: int = 0,
                         context_parallel: bool = False,
                         save_probs: bool = True, norm=None, after=None,
                         segment=None, region=None) -> torch.Tensor:
    """Fused qkv projection -> attention -> output projection.

    x: [B, S, W]. params: mapping with 'wqkv' [W, (H + 2 Hkv) D] (q, k, v
    heads in that order; Hkv = `kv_heads` or H), 'wo' [H*D, W] (the JAX
    [in, out] layout, applied as x @ w) and optional 'bqkv', 'bo'. `rope`:
    the (cos, sin) tables of `ops/rope.rope_cos_sin`, [S, R] or per-row
    [B, S, R]. `bias`: an additive mask of the logits, broadcastable to
    [B, H, S, S] (the document mask of megatron --reset-attention-mask:
    0 within a document, -1e30 across), which sends the attention to
    `sdpa_bshd`.
    Weights are cast to x's dtype at use (see `ops/dense.py`).
    `save_probs` picks the fused attention's backward under autograd: from
    the saved probabilities (the JAX default, `MCT_MHA_SAVE_PROBS=1`) or
    recomputing them (`MCT_MHA_SAVE_PROBS=0`); see `fused_mha`. The flash
    path (S > 1024, or from S = 256 with rope or GQA) saves (q, k, v, out,
    lse) and recomputes P. `dropout_rate` with `seed` (the step's seed) and
    `offset` (the layer's site) drops attention probabilities in the
    kernels; the fused dropout route always recomputes P.

    For the residual block: `norm` (its ln_1) is applied to x before the
    qkv projection and `after` to the output projection's result, and
    `segment(fn, *args)` runs the two pieces around the attention (norm ->
    qkv projection; output projection -> after; None: calls them), so that
    a checkpoint can wrap each while the attention kernels run between
    them, outside it (selective recompute, `nn/transformer.py`); on the
    "sdpa" route the attention then runs under a checkpoint of its own.

    `region`: the tensor-parallel collectives (see the module's note);
    `heads` and `kv_heads` stay the global counts, `params` hold the
    rank's split of wqkv, bqkv and wo (bo whole)."""
    if kv is not None:
        _not_in_slice("kv= cross-attention (CoCa)", "Queue A item 7")
    if context_parallel:
        _not_in_slice("context parallelism", "Queue A item 5")
    hkv = kv_heads or heads
    tp = 1 if region is None else region.size
    if heads % tp or hkv % tp:
        raise ValueError(f"{heads} heads and {hkv} kv heads must each split "
                         f"over {tp} tensor-parallel ranks")
    head_dim = params["wqkv"].shape[1] // ((heads + 2 * hkv) // tp)
    s = x.shape[1] * (tp if region is not None
                      and region.sequence_parallel else 1)
    route = attention_route(s, heads, kv_heads, head_dim,
                            rope=rope, use_flash=use_flash,
                            dropout_rate=dropout_rate, seed=seed,
                            bias=bias is not None)
    run = segment or (lambda fn, *args: fn(*args))

    def project_qkv(x):
        if norm is not None:
            x = norm(x)
        if region is not None:
            x = region.enter(x)
        return dense(x, params["wqkv"], params.get("bqkv"))

    def project_out(a):
        if region is None:
            h = dense(a, params["wo"], params.get("bo"))
        else:
            h = region.leave(dense(a, params["wo"]))
            if "bo" in params:
                h = h + params["bo"].to(h.dtype)
        return h if after is None else after(h)
    out = attention_heads(run(project_qkv, x), heads // tp, route,
                          causal=causal, rope=rope,
                          kv_heads=None if kv_heads is None
                          else kv_heads // tp,
                          dropout_rate=dropout_rate, seed=seed, offset=offset,
                          save_probs=save_probs, bias=bias,
                          recompute=segment is not None)
    return run(project_out, out)
