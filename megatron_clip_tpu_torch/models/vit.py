"""Vision transformer tower (CLIP-style).

Counterpart of `megatron_clip_tpu/models/vit.py` (`patchify`, `init_vit`,
`apply_vit` with cls-token pooling): patchify -> linear patch embed (no bias)
-> [cls] + learned pos embed -> patch dropout (train step only) -> ln_pre ->
pre-LN blocks -> ln_post on the cls token -> proj. Images are NHWC float, already normalised, as in the JAX
package. The patch embed is a matmul, not a convolution, so an fp32 run never
goes through cuDNN's TF32 default.

ln_post runs on the pooled cls token only. LayerNorm is per token, so this
equals the JAX order (ln_post over the whole sequence, then take token 0)
with S times fewer rows; a forward launches the LayerNorm kernel
1 (ln_pre) + 2*layers + 1 (ln_post) times.

Patch dropout (open_CLIP's PatchDropout, FLIP; JAX `apply_vit`'s
`patch_dropout_rng`) keeps the class token and `patch_keep_count` patches of
each row, the same count in every row: the first ones of the argsort of
uniform noise. `jax.random` streams cannot be reproduced in torch, so the
forward takes the kept indices themselves; the train step draws them with
`patch_keep_ids`, from a `torch.Generator` seeded as the JAX step folds its
key (seed + 1013, the step, the microbatch).
"""
from typing import Optional

import torch
from torch import nn

from megatron_clip_tpu_torch.config import VisionCfg
from megatron_clip_tpu_torch.ops.dropout import fold_in
from megatron_clip_tpu_torch.nn.transformer import (
    Transformer, normal_param, apply_norm, layer_norm_params)
from megatron_clip_tpu_torch.parallel.sharding import full


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, gh*gw, p*p*C], patch features in (py, px, c)
    order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B gh gw p p C
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def patch_keep_count(patches: int, rate: float) -> int:
    """The patches a row keeps at patch dropout `rate`: max(1,
    int(patches * (1 - rate))), as the JAX `apply_vit` counts them."""
    return max(1, int(patches * (1.0 - rate)))


def patch_keep_ids(seed: int, step: int, microbatch: Optional[int],
                   batch: int, patches: int, rate: float) -> torch.Tensor:
    """The kept patch indices [batch, patch_keep_count] of one train
    forward, on the CPU: the argsort of uniform noise drawn from a CPU
    `torch.Generator` seeded with fold_in(seed + 1013, step), folded again
    with `microbatch` when the step accumulates (the structure of the JAX
    step's `_pd_kw` keys). A CPU generator gives every device the same
    indices."""
    key = fold_in(seed + 1013, step)
    if microbatch is not None:
        key = fold_in(key, microbatch)
    gen = torch.Generator().manual_seed(key)
    noise = torch.rand((batch, patches), generator=gen)
    ids = torch.argsort(noise, dim=1, stable=True)
    return ids[:, :patch_keep_count(patches, rate)]


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
                save_probs: bool = True, remat: str = "none",
                patch_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images: [B, H, W, C] float. Returns pooled features
        [B, embed_dim] in the compute dtype. `save_probs`: the attention's
        backward mode; `remat`: the blocks' activation recompute;
        `patch_keep`: the patch indices [B, k] each row keeps after the
        position embedding (patch dropout; None keeps every patch)."""
        dt = compute_dtype
        x = patchify(images.to(dt), self.cfg.patch_size)
        x = torch.matmul(x, full(self.patch_embed, "w", dt).to(dt))
        cls = self.cls.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if patch_keep is not None:
            ids = patch_keep.to(x.device)[..., None].expand(
                -1, -1, x.shape[-1])
            x = torch.cat([x[:, :1], torch.gather(x[:, 1:], 1, ids)], dim=1)
        x = apply_norm(self.ln_pre, x)
        x = self.blocks(x, causal=False, save_probs=save_probs,
                        remat=remat)
        pooled = apply_norm(self.ln_post, x[:, 0])
        return torch.matmul(pooled, full(self, "proj", dt).to(dt))
