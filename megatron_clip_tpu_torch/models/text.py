"""Text transformer tower (CLIP-style).

Counterpart of `megatron_clip_tpu/models/text.py` without the CoCa
`embed_cls` branch: token embed + learned pos embed -> causal pre-LN blocks
-> ln_final -> argmax-EOT pooling -> proj. Init: token embed std 0.02, pos
embed std 0.01, proj std width**-0.5.

ln_final runs on the pooled token only. LayerNorm is per token, so this
equals the JAX order (ln_final over the sequence, then pool) with S times
fewer rows; a forward launches the LayerNorm kernel 2*layers + 1 times.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from megatron_clip_tpu_torch.config import TextCfg
from megatron_clip_tpu_torch.ops.dense import dense
from megatron_clip_tpu_torch.nn.transformer import (
    Transformer, normal_param, apply_norm, layer_norm_params)


def text_pool(x: torch.Tensor, text_ids: torch.Tensor) -> torch.Tensor:
    """The EOT position's features: EOT (49407) is the largest id, so argmax
    over the ids finds it (open_CLIP's `text.argmax(dim=-1)`)."""
    idx = text_ids.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextCfg, embed_dim: int, act: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.tok_embed = normal_param((cfg.vocab_size, w), 0.02, generator)
        self.pos_embed = normal_param((cfg.context_length, w), 0.01, generator)
        self.blocks = Transformer(cfg.transformer(act), generator)
        self.ln_final = layer_norm_params(w)
        self.proj = nn.ParameterDict(
            {"w": normal_param((w, embed_dim), w ** -0.5, generator)})

    def forward(self, text_ids: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16,
                save_probs: bool = True,
                remat: str = "none") -> torch.Tensor:
        """text_ids: [B, S] integer ids. Returns pooled features
        [B, embed_dim] in the compute dtype. `save_probs`: the attention's
        backward mode; `remat`: the blocks' activation recompute."""
        dt = compute_dtype
        s = text_ids.shape[1]
        x = F.embedding(text_ids, self.tok_embed).to(dt)
        x = x + self.pos_embed[:s].to(dt)
        x = self.blocks(x, causal=True, save_probs=save_probs,
                        remat=remat)
        pooled = apply_norm(self.ln_final, text_pool(x, text_ids))
        return dense(pooled, self.proj["w"])
