"""Attention ops.

Counterpart of `megatron_clip_tpu/ops/attention.py`. `sdpa` is the plain
oracle; `multi_head_attention` runs the packed QKV GEMM, then the fused
short-sequence attention kernels (S <= 1024) or the flash-attention kernels
(above that), forward and, under autograd, backward, then
the output GEMM, under the same gates and in the same order as the JAX
package. Everything outside those gates belongs to later slices of the port
and raises NotImplementedError naming its ROADMAP item.

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
    flash_attention_qkv)
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    MAX_FUSED_SEQ, MAX_HEAD_DIM, fused_mha)


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

    x: [B, S, W]. params: mapping with 'wqkv' [W, 3*H*D], 'wo' [H*D, W] (the
    JAX [in, out] layout, applied as x @ w) and optional 'bqkv', 'bo'.
    Weights are cast to x's dtype at use (see `ops/dense.py`).
    `save_probs` picks the fused attention's backward under autograd: from
    the saved probabilities (the JAX default, `MCT_MHA_SAVE_PROBS=1`) or
    recomputing them (`MCT_MHA_SAVE_PROBS=0`); see `fused_mha`. The flash
    path (S > 1024) saves (q, k, v, out, lse) and recomputes P."""
    if kv is not None:
        _not_in_slice("kv= cross-attention", "Queue A: other models (CoCa)")
    if bias is not None:
        _not_in_slice("an additive attention bias", "Queue A: other models")
    if rope is not None:
        _not_in_slice("rotary embeddings", "Queue A: GPT slice")
    if kv_heads not in (None, heads):
        _not_in_slice("grouped-query attention", "Queue A: GPT slice")
    if dropout_rate > 0.0:
        _not_in_slice("attention dropout", "Queue B: fused_mha_packed_dropout")
    if context_parallel:
        _not_in_slice("context parallelism", "Queue A: parallelism")
    s = x.shape[1]
    head_dim = params["wqkv"].shape[1] // (3 * heads)
    # the JAX package's gates: fused MHA up to MAX_FUSED_SEQ, flash from
    # its MIN_FLASH_SEQ = 256 on, which every longer sequence passes; both
    # need head_dim <= 128, and the rest goes to sdpa_bshd
    if not use_flash or head_dim > MAX_HEAD_DIM:
        _not_in_slice(f"the unfused sdpa path (S={s}, head_dim={head_dim}, "
                      f"use_flash={use_flash})", "Queue A: sdpa_bshd")
    qkv = dense(x, params["wqkv"], params.get("bqkv"))
    if s <= MAX_FUSED_SEQ:
        out = fused_mha(qkv, heads, causal=causal, save_probs=save_probs)
    else:
        out = flash_attention_qkv(qkv, heads, causal=causal)
    return dense(out, params["wo"], params.get("bo"))
