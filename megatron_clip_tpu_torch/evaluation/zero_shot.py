"""Zero-shot classification.

Counterpart of `megatron_clip_tpu/evaluation/zero_shot.py`: build a text
classifier from prompt-template ensembles (per class, the mean of the
normalised template embeddings, renormalised), then classify images by
`100 * image_features @ classifier`. The 1000 ImageNet class names and the
80 OpenAI templates are vendored in `evaluation/assets/imagenet_zeroshot.json`
($MCT_IMAGENET_METADATA overrides with another JSON file).
"""
import json
import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# The CLIP paper's compact 7-prompt ensemble.
SIMPLE_IMAGENET_TEMPLATES: List[Callable[[str], str]] = [
    lambda c: f"itap of a {c}.",
    lambda c: f"a bad photo of the {c}.",
    lambda c: f"a origami {c}.",
    lambda c: f"a photo of the large {c}.",
    lambda c: f"a {c} in a video game.",
    lambda c: f"art of the {c}.",
    lambda c: f"a photo of the small {c}.",
]


def load_imagenet_metadata(path: Optional[str] = None):
    """(classnames, templates) from a JSON file
    {"classnames": [...], "templates": ["a photo of a {}.", ...]}; by
    default the vendored ImageNet metadata."""
    explicit = path or os.environ.get("MCT_IMAGENET_METADATA", "")
    path = explicit or os.path.join(os.path.dirname(__file__), "assets",
                                    "imagenet_zeroshot.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"imagenet metadata not found: {path!r}")
    with open(path) as f:
        meta = json.load(f)
    templates = [lambda s, t=t: t.format(s) for t in meta["templates"]]
    return meta["classnames"], templates


@torch.no_grad()
def build_zero_shot_classifier(model, classnames: Sequence[str],
                               templates: Sequence[Callable[[str], str]],
                               tokenizer, *, batch_size: int = 64
                               ) -> torch.Tensor:
    """Returns the [D, C] fp32 classifier on the model's device. Encodes
    `batch_size` classes (times the templates) per text forward."""
    weights = []
    for lo in range(0, len(classnames), batch_size):
        chunk = classnames[lo:lo + batch_size]
        texts = [tpl(c) for c in chunk for tpl in templates]
        emb = model.encode_text(tokenizer(texts, model.context_length))
        emb = emb.reshape(len(chunk), len(templates), -1).mean(dim=1)
        weights.append(emb / torch.linalg.vector_norm(emb, dim=-1,
                                                      keepdim=True))
    return torch.cat(weights, dim=0).T


@torch.no_grad()
def zero_shot_classification(model, classifier: torch.Tensor,
                             images) -> torch.Tensor:
    """logits [B, C] = 100 * image_features @ classifier."""
    return 100.0 * model.encode_image(images) @ classifier


def zero_shot_eval(model, classifier: torch.Tensor,
                   batches: Iterable[Tuple[np.ndarray, np.ndarray]]) -> dict:
    """batches yield (images, integer labels); returns top-1/top-5
    accuracy."""
    n = top1 = top5 = 0
    for images, labels in batches:
        logits = zero_shot_classification(model, classifier, images)
        top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices.cpu().numpy()
        labels = np.asarray(labels)
        top1 += int((top[:, 0] == labels).sum())
        top5 += int((top == labels[:, None]).any(axis=1).sum())
        n += len(labels)
    return {"imagenet-zeroshot-val-top1": top1 / max(n, 1),
            "imagenet-zeroshot-val-top5": top5 / max(n, 1)}
