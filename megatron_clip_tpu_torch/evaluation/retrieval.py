"""Contrastive validation metrics: val loss + cross-modal retrieval recall@K.

Counterpart of `megatron_clip_tpu/evaluation/retrieval.py` (open_CLIP's
get_clip_metrics / evaluate loss accumulation,
open_CLIP/src/training/train.py:543-648): features accumulated over the
val set in fp32, the mean per-sample `clip_loss` (`clip_val_loss`) and
recall@1/5/10 with mean and median ranks in both directions; past
`_DEVICE_RANK_THRESHOLD` samples the ranks are counted on the model's
device in chunks, never forming the N x N logits.
"""
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from megatron_clip_tpu_torch.losses import clip_loss


def recall_at_k(logits_per_image: np.ndarray,
                ks=(1, 5, 10)) -> Dict[str, float]:
    """logits [N, N] with matching pairs on the diagonal — both directions
    (train.py:631-648: image_to_text_R@K / text_to_image_R@K + mean rank)."""
    out = {}
    n = logits_per_image.shape[0]
    gold = np.arange(n)
    for name, logits in (("image_to_text", logits_per_image),
                         ("text_to_image", logits_per_image.T)):
        ranking = np.argsort(-logits, axis=1)
        where = np.argmax(ranking == gold[:, None], axis=1)
        out[f"{name}_mean_rank"] = float(where.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(where)) + 1)
        for k in ks:
            out[f"{name}_R@{k}"] = float((where < k).mean())
    return out


@torch.no_grad()
def recall_at_k_device(img_features: torch.Tensor,
                       txt_features: torch.Tensor, scale: float,
                       ks=(1, 5, 10), chunk: int = 1024) -> Dict[str, float]:
    """recall_at_k for large val sets, on the features' device: each row's
    gold rank = #entries with a strictly higher score + #ties at an
    earlier index, the position the host path's stable argsort gives the
    gold item (a collapsed model, every logit tied, reads R@1 = 1/N, not
    1). [chunk, N] logits at a time."""
    img = img_features.float()
    txt = txt_features.float()
    n = img.shape[0]
    cols = torch.arange(n, device=img.device)
    out = {}
    for name, q, gallery in (("image_to_text", img, txt),
                             ("text_to_image", txt, img)):
        ranks = []
        for s in range(0, n, chunk):
            idx = cols[s:s + chunk]
            logits = scale * (q[s:s + chunk] @ gallery.T)
            gold = logits.gather(1, idx[:, None])
            earlier = cols[None] < idx[:, None]
            ranks.append(((logits > gold).sum(1)
                          + ((logits == gold) & earlier).sum(1)).cpu())
        where = torch.cat(ranks).numpy()
        out[f"{name}_mean_rank"] = float(where.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(where)) + 1)
        for k in ks:
            out[f"{name}_R@{k}"] = float((where < k).mean())
    return out


# above this gallery size the host argsort path is replaced by the chunked
# device ranking (an N x N fp32 argsort at N=100k would be 40 GB host RAM)
_DEVICE_RANK_THRESHOLD = 8192


@torch.no_grad()
def contrastive_eval_metrics(model, batches: Iterable[Tuple[np.ndarray,
                                                            np.ndarray]]
                             ) -> Dict[str, float]:
    """Accumulate features over the val set; report val loss + recall@K.
    `model` is a `CLIPModel`; batches yield (images, token ids)."""
    img_f, txt_f, scale = [], [], 1.0
    n, loss_sum = 0, 0.0
    for images, texts in batches:
        out = model(images, texts)
        img_f.append(out["image_features"])
        txt_f.append(out["text_features"])
        scale = float(out["logit_scale"])
        b = images.shape[0]
        loss_sum += float(clip_loss(out["image_features"],
                                    out["text_features"],
                                    out["logit_scale"])) * b
        n += b
    img = torch.cat(img_f)
    txt = torch.cat(txt_f)
    if img.shape[0] > _DEVICE_RANK_THRESHOLD:
        metrics = recall_at_k_device(img, txt, scale)
    else:
        img, txt = img.cpu().numpy(), txt.cpu().numpy()
        metrics = recall_at_k(scale * img @ txt.T)
    metrics["clip_val_loss"] = loss_sum / max(n, 1)
    metrics["num_samples"] = n
    return metrics
