"""Contrastive loss for one process.

Counterpart of `megatron_clip_tpu/losses.py::clip_loss` and `ClipLoss`
without an `axis_name`: the global-batch InfoNCE of open_CLIP's ClipLoss on
features that one process holds whole. Logits are formed in fp32 with labels
arange(B). The gathered and sharded forms (`gather_features`, `local_loss`)
come with the parallelism slice; SigLIP, CoCa and distillation losses with
theirs.
"""
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
