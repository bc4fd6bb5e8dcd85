"""Attention ops.

Counterpart of `megatron_clip_tpu/ops/attention.py`. `sdpa` is the plain
oracle; `multi_head_attention` runs the packed QKV GEMM, then the fused
short-sequence attention kernels (S <= 1024, no rotary embeddings, as many
k/v heads as query heads) or the flash-attention kernels (from S = 256 on,
when the fused kernels are not taken), forward and, under autograd,
backward, then the output GEMM, under the same gates and in the same order
as the JAX package. Rotary embeddings rotate the q and k heads of the
packed projection (`ops/rope.py`); grouped-query attention repeats each k
and v head over its group of query heads (`repeat_interleave`, the JAX
package's `jnp.repeat`), whose gradient sums over the group. Everything
outside those gates belongs to later slices of the port and raises
NotImplementedError naming its ROADMAP item.

The JAX package's flash path projects straight into [B, H, S, D] so that
the head split costs no copy; here the flash kernels read the heads of the
packed [B, S, 3*H*D] projection in place and write the packed gradient, the
same saving. In bf16 the packed projection rounds once where the JAX BHSD
projection rounds the product and then adds the bias (ROADMAP Queue C,
`ops/dense.py`).
"""
from typing import Optional

import torch

from megatron_clip_tpu_torch.ops.dense import dense
from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_qkv)
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    MAX_FUSED_SEQ, MAX_HEAD_DIM, fused_mha)
from megatron_clip_tpu_torch.ops.rope import apply_rope_qkv

# the JAX package's gate: flash attention from this length on
MIN_FLASH_SEQ = 256


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention, softmax in fp32.
    q: [B, H, Sq, D], k/v: [B, H, Sk, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        # offset handles sq != sk (decoding against a cache)
        logits = logits.masked_fill(row + (sk - sq) < col, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(
        f"multi_head_attention: {what} is not ported yet (ROADMAP {item})")


def multi_head_attention(x: torch.Tensor, params, heads: int, *,
                         causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         use_flash: bool = True,
                         kv: Optional[torch.Tensor] = None, rope=None,
                         kv_heads: Optional[int] = None,
                         dropout_rate: float = 0.0,
                         context_parallel: bool = False,
                         save_probs: bool = True) -> torch.Tensor:
    """Fused qkv projection -> attention -> output projection.

    x: [B, S, W]. params: mapping with 'wqkv' [W, (H + 2 Hkv) D] (q, k, v
    heads in that order; Hkv = `kv_heads` or H), 'wo' [H*D, W] (the JAX
    [in, out] layout, applied as x @ w) and optional 'bqkv', 'bo'. `rope`:
    the (cos, sin) tables of `ops/rope.rope_cos_sin`.
    Weights are cast to x's dtype at use (see `ops/dense.py`).
    `save_probs` picks the fused attention's backward under autograd: from
    the saved probabilities (the JAX default, `MCT_MHA_SAVE_PROBS=1`) or
    recomputing them (`MCT_MHA_SAVE_PROBS=0`); see `fused_mha`. The flash
    path (S > 1024, or from S = 256 with rope or GQA) saves (q, k, v, out,
    lse) and recomputes P."""
    if kv is not None:
        _not_in_slice("kv= cross-attention", "Queue A: other models (CoCa)")
    if bias is not None:
        _not_in_slice("an additive attention bias", "Queue A: other models")
    if dropout_rate > 0.0:
        _not_in_slice("attention dropout", "Queue B: fused_mha_packed_dropout")
    if context_parallel:
        _not_in_slice("context parallelism", "Queue A: parallelism")
    b, s, _ = x.shape
    hkv = kv_heads or heads
    if heads % hkv:
        raise ValueError(f"heads {heads} not a multiple of kv_heads {hkv}")
    head_dim = params["wqkv"].shape[1] // (heads + 2 * hkv)
    # the JAX package's gates: fused MHA up to MAX_FUSED_SEQ without rope
    # or GQA, else flash from MIN_FLASH_SEQ on; both need head_dim <= 128,
    # and the rest goes to sdpa_bshd
    fused = rope is None and hkv == heads and s <= MAX_FUSED_SEQ
    if not use_flash or head_dim > MAX_HEAD_DIM or not (
            fused or s >= MIN_FLASH_SEQ):
        _not_in_slice(f"the unfused sdpa path (S={s}, head_dim={head_dim}, "
                      f"use_flash={use_flash}, rope={rope is not None}, "
                      f"kv_heads={hkv})", "Queue A: sdpa_bshd")
    qkv = dense(x, params["wqkv"], params.get("bqkv"))
    if fused:
        out = fused_mha(qkv, heads, causal=causal, save_probs=save_probs)
    else:
        if rope is not None:
            qkv = apply_rope_qkv(qkv, *rope, heads, hkv)
        if hkv == heads:
            out = flash_attention_qkv(qkv, heads, causal=causal)
        else:
            q, k, v = (t.unflatten(-1, (-1, head_dim)).transpose(1, 2)
                       for t in qkv.split([heads * head_dim, hkv * head_dim,
                                           hkv * head_dim], dim=-1))
            rep = heads // hkv
            out = flash_attention(q, k.repeat_interleave(rep, dim=1),
                                  v.repeat_interleave(rep, dim=1),
                                  causal=causal)
            out = out.transpose(1, 2).reshape(b, s, heads * head_dim)
    return dense(out, params["wo"], params.get("bo"))
