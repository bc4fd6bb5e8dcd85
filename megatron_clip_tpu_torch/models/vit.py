"""Vision transformer tower (CLIP-style).

Counterpart of `megatron_clip_tpu/models/vit.py` (`patchify`, `init_vit`,
`apply_vit` with cls-token pooling): patchify -> linear patch embed (no bias)
-> [cls] + learned pos embed -> ln_pre -> pre-LN blocks -> ln_post on the
cls token -> proj. Images are NHWC float, already normalised, as in the JAX
package. The patch embed is a matmul, not a convolution, so an fp32 run never
goes through cuDNN's TF32 default.

ln_post runs on the pooled cls token only. LayerNorm is per token, so this
equals the JAX order (ln_post over the whole sequence, then take token 0)
with S times fewer rows; a forward launches the LayerNorm kernel
1 (ln_pre) + 2*layers + 1 (ln_post) times.
"""
from typing import Optional

import torch
from torch import nn

from megatron_clip_tpu_torch.config import VisionCfg
from megatron_clip_tpu_torch.nn.transformer import (
    Transformer, normal_param, apply_norm, layer_norm_params)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, gh*gw, p*p*C], patch features in (py, px, c)
    order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B gh gw p p C
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionCfg, embed_dim: int, act: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        scale = w ** -0.5
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        self.patch_embed = nn.ParameterDict(
            {"w": normal_param((patch_dim, w), patch_dim ** -0.5, generator)})
        self.cls = normal_param((w,), scale, generator)
        self.pos_embed = normal_param((cfg.seq_len, w), scale, generator)
        self.ln_pre = layer_norm_params(w)
        self.blocks = Transformer(cfg.transformer(act), generator)
        self.ln_post = layer_norm_params(w)
        self.proj = normal_param((w, embed_dim), scale, generator)

    def forward(self, images: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16,
                save_probs: bool = True) -> torch.Tensor:
        """images: [B, H, W, C] float. Returns pooled features
        [B, embed_dim] in the compute dtype. `save_probs`: the attention's
        backward mode."""
        dt = compute_dtype
        x = patchify(images.to(dt), self.cfg.patch_size)
        x = torch.matmul(x, self.patch_embed["w"].to(dt))
        cls = self.cls.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = apply_norm(self.ln_pre, x)
        x = self.blocks(x, causal=False, save_probs=save_probs)
        pooled = apply_norm(self.ln_post, x[:, 0])
        return torch.matmul(pooled, self.proj.to(dt))
