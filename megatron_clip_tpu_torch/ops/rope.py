"""Rotary position embeddings.

Counterpart of `megatron_clip_tpu/ops/rope.py` (megatron's RotaryEmbedding /
apply_rotary_pos_emb, rotate-half convention): `rope_cos_sin`, `rotate_half`,
`apply_rope` ([B, H, S, D]) and `apply_rope_bshd` ([B, S, H, D]), plain
PyTorch as they are jnp there. The tables are built in fp32 and cast to the
activations' dtype before the products, as `apply_rope` casts them.

`apply_rope_qkv` is what the attention calls: it rotates the q and k heads
of a packed [B, S, (H + 2 Hkv) D] projection and passes v through. The
tables are [S, R], shared by the rows, or [B, S, R], gathered at per-row
positions (`rope_cos_sin(...)[0][position_ids]`).
"""
from typing import Optional, Tuple

import torch


def rope_cos_sin(seq_len: int, head_dim: int, theta: float = 10000.0,
                 offset: int = 0, rotary_percent: float = 1.0,
                 seq_len_interpolation_factor: Optional[float] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [seq_len, rot_dim] fp32. rotary_percent < 1 rotates
    only the first head_dim * percent channels (even), megatron
    --rotary-percent; seq_len_interpolation_factor divides the positions
    (--rotary-seq-len-interpolation-factor)."""
    rot_dim = int(head_dim * rotary_percent)
    rot_dim -= rot_dim % 2
    inv_freq = 1.0 / (theta ** (2.0 * torch.arange(
        rot_dim // 2, dtype=torch.float32, device=device) / rot_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + \
        float(offset)
    if seq_len_interpolation_factor is not None:
        pos = pos / float(seq_len_interpolation_factor)
    freqs = pos[:, None] * inv_freq[None, :]               # [S, R/2]
    emb = torch.cat([freqs, freqs], dim=-1)                # [S, R]
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, (heads,) D] with cos/sin already broadcast against x's
    first R channels; channels R: pass through."""
    rot_dim = cos.shape[-1]
    x, rest = x[..., :rot_dim], x[..., rot_dim:]
    out = x * cos + rotate_half(x) * sin
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [S, R] shared or [B, S, R] per row, R <= D
    (channels R: untouched)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return _rotate(x, cos.to(x.dtype)[:, None], sin.to(x.dtype)[:, None])


def apply_rope_bshd(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [S, R] shared or [B, S, R] per row
    (megatron --reset-position-ids' restarts), R <= D."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return _rotate(x, cos.to(x.dtype)[:, :, None],
                   sin.to(x.dtype)[:, :, None])


def apply_rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   heads: int, kv_heads: int) -> torch.Tensor:
    """qkv [B, S, (heads + 2 kv_heads) D] packed (q heads, k heads, v heads)
    -> the same with the q and k heads rotated (`apply_rope_bshd` on each),
    v unchanged; differentiable."""
    head_dim = qkv.shape[-1] // (heads + 2 * kv_heads)
    qk, v = qkv.split([(heads + kv_heads) * head_dim, kv_heads * head_dim],
                      dim=-1)
    qk = apply_rope_bshd(qk.unflatten(-1, (-1, head_dim)), cos, sin)
    return torch.cat([qk.flatten(-2), v], dim=-1)
