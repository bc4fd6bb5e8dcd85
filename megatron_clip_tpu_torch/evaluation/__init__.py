"""Evaluation: zero-shot classification and contrastive val metrics."""
from megatron_clip_tpu_torch.evaluation.retrieval import (  # noqa: F401
    contrastive_eval_metrics, recall_at_k, recall_at_k_device)
from megatron_clip_tpu_torch.evaluation.zero_shot import (  # noqa: F401
    SIMPLE_IMAGENET_TEMPLATES, build_zero_shot_classifier, zero_shot_eval)
