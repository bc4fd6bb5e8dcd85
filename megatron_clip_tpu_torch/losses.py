"""Contrastive losses for one process.

Counterpart of `megatron_clip_tpu/losses.py::clip_loss`, `ClipLoss` and
`SigLipLoss` without an `axis_name`: the global-batch InfoNCE of open_CLIP's
ClipLoss on features that one process holds whole, logits formed in fp32
with labels arange(B); and SigLIP's sigmoid pairwise loss over the same
batch. The gathered and sharded forms (`gather_features`, `local_loss`,
SigLIP's ring exchange) come with the parallelism slice; CoCa and
distillation losses with theirs.
"""
from typing import Optional

import torch
import torch.nn.functional as F


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Global InfoNCE. features: [N, D] L2-normalised; logit_scale: the
    temperature already exponentiated. Mean of the image->text and
    text->image cross entropies, logits in fp32, labels arange(N)."""
    logits = logit_scale * image_features.float() @ text_features.float().T
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


class ClipLoss:
    """open_CLIP's ClipLoss contract for one process: called with (image
    features, text features, logit_scale), returns `clip_loss` of them."""

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor,
                 logit_scale: torch.Tensor) -> torch.Tensor:
        return clip_loss(image_features, text_features, logit_scale)


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SigLIP's sigmoid loss over one batch of N pairs: logits = scale *
    img @ txt^T (+ bias), label +1 on the diagonal and -1 elsewhere,
    -sum(log sigmoid(label * logits)) / N, in fp32."""
    logits = logit_scale * image_features.float() @ text_features.float().T
    if logit_bias is not None:
        logits = logits + logit_bias
    n = image_features.shape[0]
    sign = 2.0 * torch.eye(n, device=logits.device) - 1.0
    return -F.logsigmoid(sign * logits).sum() / n


class SigLipLoss:
    """SigLIP's loss contract for one process: called with (image features,
    text features, logit_scale[, logit_bias]), returns `siglip_loss` of
    them. The JAX train step calls it without the bias, and so does the
    port's (see `training/train_step.py`)."""

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return siglip_loss(image_features, text_features, logit_scale,
                           logit_bias)
