"""The two-tower CLIP model.

Counterpart of `megatron_clip_tpu/models/clip.py` (`init_clip`,
`encode_image`, `encode_text`, `apply_clip`, `clamp_logit_scale`) for ViT
towers: the ViT vision tower, the text transformer, a learned temperature
`logit_scale`, initialised to ln(1/0.07), kept in fp32 under every precision
and clamped to ln(100) at use, and, where the config sets
`init_logit_bias` (SigLIP), a learned `logit_bias`, fp32 as well. Features are L2-normalised in fp32. The
ResNet, ConvNeXt, Swin, HF-text and CoCa branches come with later slices.
"""
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from megatron_clip_tpu_torch.config import BF16, CLIPCfg, Precision, check_remat
from megatron_clip_tpu_torch.models.text import TextTransformer
from megatron_clip_tpu_torch.models.vit import VisionTransformer

LOGIT_SCALE_MAX = math.log(100.0)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics, computed in fp32."""
    xf = x.float()
    return xf / torch.linalg.vector_norm(xf, dim=-1, keepdim=True).clamp_min(eps)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, device=device, dtype=dtype)


class CLIPModel(nn.Module):
    """Both towers, the temperature and the precision policy. Parameter
    names mirror the JAX pytree (`visual.*`, `text.*`, `logit_scale`).

    The encode methods and `forward` take numpy arrays or tensors (images
    NHWC float, text ids [B, S] int), move them to the model's device, run
    the towers in the policy's compute dtype and return fp32 features there.
    `encode_image` and `encode_text` serve: they run without autograd, so
    the attention kernel writes no probabilities. `forward` is the training
    forward and records the graph when grad is enabled.

    `attn_save_probs` picks the attention backward of `forward`: True (the
    JAX package's default, `MCT_MHA_SAVE_PROBS=1`) saves each attention's
    probabilities for it, [B, H, S, S] per layer; False
    (`MCT_MHA_SAVE_PROBS=0`, bench.py's ViT-L/14 and ViT-H/14 legs) saves
    8 bytes of softmax statistics per row and recomputes them.

    `remat` is the activation recompute of both towers' blocks in `forward`
    (none, selective, full; see `nn/transformer.py`), the JAX model's
    `remat` field, which the trainer sets from `--recompute-granularity`."""

    def __init__(self, cfg: CLIPCfg, precision: Precision = BF16,
                 generator: Optional[torch.Generator] = None,
                 attn_save_probs: bool = True, remat: str = "none"):
        super().__init__()
        self.cfg = cfg
        self.precision = precision
        self.attn_save_probs = attn_save_probs
        self.remat = check_remat(remat)
        self.visual = VisionTransformer(cfg.vision, cfg.embed_dim, cfg.act,
                                        generator)
        self.text = TextTransformer(cfg.text, cfg.embed_dim, cfg.act,
                                    generator)
        self.logit_scale = nn.Parameter(
            torch.tensor(cfg.init_logit_scale, dtype=torch.float32))
        if cfg.init_logit_bias is not None:
            self.logit_bias = nn.Parameter(
                torch.tensor(cfg.init_logit_bias, dtype=torch.float32))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    @property
    def context_length(self) -> int:
        return self.cfg.text.context_length

    @torch.no_grad()
    def encode_image(self, images, normalize: bool = True) -> torch.Tensor:
        """images [B, H, W, C] -> fp32 features [B, embed_dim]."""
        f = self.visual(_as_tensor(images, self.device),
                        self.precision.compute_torch)
        return _l2_normalize(f) if normalize else f.float()

    @torch.no_grad()
    def encode_text(self, text_ids, normalize: bool = True) -> torch.Tensor:
        """text_ids [B, S] -> fp32 features [B, embed_dim]."""
        f = self.text(_as_tensor(text_ids, self.device, torch.long),
                      self.precision.compute_torch)
        return _l2_normalize(f) if normalize else f.float()

    def forward(self, images, text_ids,
                patch_keep: Optional[torch.Tensor] = None) -> dict:
        """Either tower may be None. What `apply_clip` returns (and open_CLIP's
        CLIP.forward): fp32 normalised features, exp(min(logit_scale,
        ln 100)) and, in a model with one, `logit_bias`, differentiable in
        every parameter. `patch_keep`: the vision tower's kept patch
        indices (patch dropout, see `models/vit.py`); None keeps all."""
        dt, keep = self.precision.compute_torch, self.attn_save_probs
        remat = check_remat(self.remat)
        out = {}
        if images is not None:
            out["image_features"] = _l2_normalize(self.visual(
                _as_tensor(images, self.device), dt, keep, remat,
                patch_keep))
        if text_ids is not None:
            out["text_features"] = _l2_normalize(self.text(
                _as_tensor(text_ids, self.device, torch.long), dt, keep,
                remat))
        out["logit_scale"] = torch.exp(
            self.logit_scale.clamp(max=LOGIT_SCALE_MAX))
        if self.cfg.init_logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


@torch.no_grad()
def clamp_logit_scale(model: CLIPModel) -> None:
    """Post-step clamp of logit_scale to [0, ln 100], in place: open_CLIP's
    `logit_scale.clamp_(0, ln(100))` after each optimizer step."""
    model.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)
