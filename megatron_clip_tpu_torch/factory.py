"""Model factory and config registry for the port.

Counterpart of `megatron_clip_tpu/factory.py` for ViT CLIP models: the
built-in open_CLIP ViT ladder (plus its -quickgelu variants, `test-tiny`
and the JAX registry's other plain-ViT configs), `parse_model_cfg` for ViT
configs, `create_model`, which builds a `models.clip.CLIPModel`, and
`create_loss`'s ClipLoss branch. Configs use the open_CLIP JSON schema
({embed_dim, vision_cfg, text_cfg[, quick_gelu]}); overrides replace
top-level keys, as in the JAX factory.
"""
import dataclasses
import json
from typing import Dict, Optional, Union

import torch

from megatron_clip_tpu_torch.config import (BF16, FP32, PURE_BF16, CLIPCfg,
                                            Precision, TextCfg, VisionCfg)
from megatron_clip_tpu_torch.losses import ClipLoss
from megatron_clip_tpu_torch.models.clip import CLIPModel


def _vit(embed_dim, v_layers, v_width, patch, t_width, t_heads, t_layers,
         image_size=224, head_width=64, mlp_ratio=4.0, context=77):
    cfg = {
        "embed_dim": embed_dim,
        "vision_cfg": {"image_size": image_size, "layers": v_layers,
                       "width": v_width, "patch_size": patch},
        "text_cfg": {"context_length": context, "vocab_size": 49408,
                     "width": t_width, "heads": t_heads, "layers": t_layers},
    }
    if head_width != 64:
        cfg["vision_cfg"]["head_width"] = head_width
    if mlp_ratio != 4.0:
        cfg["vision_cfg"]["mlp_ratio"] = mlp_ratio
    return cfg


# The standard open_CLIP ViT ladder (architecture facts).
_BUILTIN: Dict[str, dict] = {
    "ViT-S-32": _vit(384, 12, 384, 32, 384, 6, 12),
    "ViT-S-16": _vit(384, 12, 384, 16, 384, 6, 12),
    "ViT-M-32": _vit(512, 12, 512, 32, 512, 8, 12),
    "ViT-M-16": _vit(512, 12, 512, 16, 512, 8, 12),
    "ViT-B-32": _vit(512, 12, 768, 32, 512, 8, 12),
    "ViT-B-32-plus-256": _vit(640, 12, 896, 32, 640, 10, 12, image_size=256),
    "ViT-B-16": _vit(512, 12, 768, 16, 512, 8, 12),
    "ViT-B-16-plus-240": _vit(640, 12, 896, 16, 640, 10, 12, image_size=240),
    "ViT-L-14": _vit(768, 24, 1024, 14, 768, 12, 12),
    "ViT-L-14-336": _vit(768, 24, 1024, 14, 768, 12, 12, image_size=336),
    "ViT-L-16": _vit(768, 24, 1024, 16, 768, 12, 12),
    "ViT-H-14": _vit(1024, 32, 1280, 14, 1024, 16, 24, head_width=80),
    "ViT-H-16": _vit(1024, 32, 1280, 16, 1024, 16, 24, head_width=80),
    "ViT-g-14": _vit(1024, 40, 1408, 14, 1024, 16, 24, head_width=88,
                     mlp_ratio=4.3637),
    "ViT-G-14": _vit(1280, 48, 1664, 14, 1280, 20, 32, head_width=104,
                     mlp_ratio=4.9231),
    "ViT-e-14": _vit(1280, 56, 1792, 14, 1280, 20, 36, head_width=112,
                     mlp_ratio=8.5715),
}
# quickgelu variants (OpenAI-trained checkpoints use QuickGELU)
for _name in ("ViT-B-32", "ViT-B-16", "ViT-L-14"):
    _BUILTIN[_name + "-quickgelu"] = dict(_BUILTIN[_name], quick_gelu=True)

# tiny config for tests and smoke runs (real vocab for tokenizer ids)
_BUILTIN["test-tiny"] = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64,
                   "head_width": 32, "patch_size": 8},
    "text_cfg": {"context_length": 32, "vocab_size": 49408, "width": 64,
                 "heads": 2, "layers": 2},
}

# the JAX package's other plain-ViT configs (open_CLIP model_configs/*.json
# shapes); ViT-M-16-alt's layer scale is not ported (ROADMAP Queue A item 3)
_BUILTIN["ViT-B-16-plus"] = _vit(640, 12, 896, 16, 640, 10, 12)
_BUILTIN["ViT-L-14-280"] = _vit(768, 24, 1024, 14, 768, 12, 12,
                                image_size=280)
_BUILTIN["ViT-L-16-320"] = _vit(768, 24, 1024, 16, 768, 12, 12,
                                image_size=320)
_BUILTIN["ViT-L-16-bigT"] = _vit(768, 24, 1408, 16, 1024, 16, 24)
_BUILTIN["ViT-L-16-bigT-backup"] = _vit(768, 24, 1024, 16, 768, 12, 24)
_BUILTIN["ViT-L-16-tiny"] = _vit(768, 2, 1024, 16, 1536, 12, 2)
_BUILTIN["ViT-M-32-alt"] = _vit(384, 12, 512, 32, 384, 6, 12)
_BUILTIN["ViT-S-16-alt"] = _vit(256, 12, 384, 16, 256, 4, 10)
_BUILTIN["ViT-S-32-alt"] = _vit(256, 12, 384, 32, 256, 4, 10)


def list_models():
    return sorted(_BUILTIN)


def get_model_config(name: str) -> Optional[dict]:
    if name in _BUILTIN:
        return json.loads(json.dumps(_BUILTIN[name]))  # deep copy
    return None


def _fields(d: dict, cls, where: str) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise NotImplementedError(
            f"{where} keys {unknown} are not ported yet: this slice builds "
            "ViT CLIP towers only (ROADMAP Queue A: other models)")
    return d


def parse_model_cfg(cfg_dict: dict) -> CLIPCfg:
    """open_CLIP-schema dict -> CLIPCfg, ViT towers only. Keys naming a
    tower family outside this slice (timm/HF towers, ResNet layer lists,
    CoCa) raise NotImplementedError."""
    vision = dict(cfg_dict.get("vision_cfg", {}))
    if isinstance(vision.get("layers"), (list, tuple)):
        raise NotImplementedError("ResNet vision towers are not ported yet "
                                  "(ROADMAP Queue A: other models)")
    if cfg_dict.get("multimodal_cfg"):
        raise NotImplementedError("CoCa is not ported yet "
                                  "(ROADMAP Queue A: other models)")
    return CLIPCfg(
        embed_dim=cfg_dict["embed_dim"],
        vision=VisionCfg(**_fields(vision, VisionCfg, "vision_cfg")),
        text=TextCfg(**_fields(dict(cfg_dict.get("text_cfg", {})), TextCfg,
                               "text_cfg")),
        quick_gelu=bool(cfg_dict.get("quick_gelu", False)),
    )


def _precision_from_str(precision: str) -> Precision:
    # open_CLIP --precision values; fp16 is not ported (ROADMAP Queue A)
    if precision == "pure_bf16":
        return PURE_BF16
    if precision in ("amp_bf16", "bf16", "amp_bfloat16", "amp"):
        return BF16
    if precision in ("fp32", "float32"):
        return FP32
    raise ValueError(f"unknown or unsupported precision {precision!r} "
                     "(fp32, bf16, amp, amp_bf16, pure_bf16)")


def create_model(model_name: str, precision: str = "bf16",
                 device: Union[str, torch.device, None] = None, seed: int = 0,
                 attn_save_probs: bool = True, **overrides) -> CLIPModel:
    """Build a CLIP model with random weights drawn in fp32 from `seed` (on
    the CPU generator, so every device gets the same weights) on `device`.
    Under `pure_bf16` every weight but `logit_scale` is then stored in bf16,
    as the JAX factory's Precision("bfloat16", "bfloat16") does.
    `device=None` means the CUDA device; without one this raises, it does
    not fall back to the CPU: pass device="cpu" to run there.
    `attn_save_probs=False` trains with the recompute attention backward
    (see `CLIPModel`)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model: no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    name = model_name.replace("/", "-")  # ViT-B/32 -> ViT-B-32
    cfg_dict = get_model_config(name)
    if cfg_dict is None:
        raise RuntimeError(f"model config for {model_name!r} not found; "
                           f"available: {list_models()}")
    cfg_dict.update(overrides)
    prec = _precision_from_str(precision)
    gen = torch.Generator().manual_seed(seed)
    model = CLIPModel(parse_model_cfg(cfg_dict), prec, gen, attn_save_probs)
    for name, p in model.named_parameters():
        if name != "logit_scale":
            p.data = p.data.to(prec.param_torch)
    return model.to(device).eval()


def create_loss(args) -> ClipLoss:
    """open_CLIP create_loss (factory.py:250-283) as the JAX factory
    dispatches it: `args` is an argparse Namespace or any object with the
    same fields. The port has the ClipLoss branch; on one process
    `--local-loss` and `--gather-with-grad` change nothing, as on one JAX
    device. CoCa, SigLIP and distillation raise."""
    get = lambda k, d=None: getattr(args, k, d)  # noqa: E731
    if get("model", "").startswith("coca"):
        raise NotImplementedError("CoCaLoss is not ported yet (ROADMAP "
                                  "Queue A item 2)")
    if get("siglip"):
        raise NotImplementedError("SigLipLoss is not ported yet (ROADMAP "
                                  "Queue A item 2)")
    if get("distill_model") or get("distill"):
        raise NotImplementedError("DistillClipLoss is not ported yet "
                                  "(ROADMAP Queue A item 2)")
    return ClipLoss()
