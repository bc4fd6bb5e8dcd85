"""Image preprocessing: open_CLIP's transforms in numpy, without PIL.

Counterpart of `megatron_clip_tpu/data/transforms.py`, emitting the same
NHWC float32 numpy arrays:

  train: RandomResizedCrop(size, scale=(0.9, 1.0), bicubic) -> normalize
  val:   Resize(shortest side -> size, bicubic) -> CenterCrop -> normalize

The JAX package resizes with PIL's `Image.resize(..., BICUBIC, box=...)`;
the card's machine has no PIL, so `resize_bicubic` computes what PIL
computes on 8-bit RGB (Pillow's Resample.c): two separable passes,
horizontal then vertical, over the rows the vertical pass reads; each
output sample's taps from `precompute_coeffs` (the bicubic kernel with
a = -0.5, its support scaled by the downscale factor, the weights
normalised to sum 1), the weights in fixed point with 22 fraction bits,
the sum started at the rounding bias and clipped to 0..255 after each
pass. A box of the output's size at integer corners is a plain crop, and
an unchanged size a copy, as in PIL. `gray_scale_prob` converts as PIL's
"L" mode does: (19595 R + 38470 G + 7471 B + 0x8000) >> 16.

The random crop draws from the same `random.Random` calls in the same
order as the JAX transform, so the same seed gives the same box. The
loaders pass each sample a seed of its own (`ImageTransform.__call__`), so
that a resumed run crops a sample as the uninterrupted run did.

Not ported yet (ROADMAP Queue A item 3): color jitter and AutoAugment.
"""
import math
import random
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
# Pillow's fixed point (Resample.c PRECISION_BITS)
_PRECISION_BITS = 22


@dataclass
class AugmentationCfg:
    """open_CLIP's train-time augmentation config (transform.py:15-23,
    CLI `--aug-cfg scale=(0.8,1.0) ...`); a copy of the JAX package's.
    scale, ratio and gray_scale_prob are implemented; color_jitter raises
    (ROADMAP Queue A item 3); the timm-only knobs warn and are skipped, as
    in the JAX package."""
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, ...]]] = None
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None
    interpolation: Optional[str] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False


def parse_aug_cfg(items) -> Optional[AugmentationCfg]:
    """Parse the CLI form: a list of 'key=value' strings (open_CLIP
    params.py --aug-cfg nargs='*'), values python-literal-eval'd."""
    if not items:
        return None
    import ast
    kw: Dict[str, Any] = {}
    for it in items:
        k, _, v = it.partition("=")
        k = k.replace("-", "_")
        try:
            kw[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            kw[k] = v
    return AugmentationCfg(**kw)


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _to_rgb(img) -> np.ndarray:
    """An image as uint8 [H, W, 3], as the JAX transform's `_to_pil` makes
    its PIL image: uint8 arrays as they are (grey replicated, alpha
    dropped), float arrays clipped to [0, 1] and scaled by 255."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] <= 2:
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter, a = -0.5, in float64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, in0: float, in1: float, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: each output
    sample's first input index, its taps' count and their weights in fixed
    point ([out_size, taps] int64, 0 past each sample's count)."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    center = in0 + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    taps = int(xmax.max())
    x = np.arange(taps)
    w = _bicubic((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(taps):  # in Pillow's order, not numpy's pairwise sum
        total = total + w[:, t]
    total = total[:, None]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5))
    return xmin, xmax, fixed.astype(np.int64)


def _pass(img: np.ndarray, axis: int, xmin, fixed) -> np.ndarray:
    """One resampling pass along `axis` (1: columns, 0: rows) of uint8
    [H, W, 3]: each output sample is the bias plus its taps' weighted sum,
    shifted down and clipped to 0..255. The sums fit int32, as in Pillow
    (255 times weights of absolute sum below 1.2, in 22 fraction bits)."""
    src = img.astype(np.int32)
    n = img.shape[axis]
    acc = np.full(img.shape[:axis] + (len(xmin),) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(fixed.shape[1]):
        idx = np.minimum(xmin + t, n - 1)
        k = fixed[:, t].astype(np.int32)
        if axis == 1:
            acc += src[:, idx] * k[None, :, None]
        else:
            acc += src[idx] * k[:, None, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int],
                   box: Optional[Tuple[int, int, int, int]] = None
                   ) -> np.ndarray:
    """PIL's `Image.resize(size, BICUBIC, box)` on uint8 [H, W, 3];
    size = (width, height), box = (x0, y0, x1, y1) in input pixels."""
    h, w = img.shape[:2]
    xsize, ysize = size
    box = (0, 0, w, h) if box is None else tuple(box)
    if (w, h) == (xsize, ysize) and box == (0, 0, w, h):
        return img.copy()
    x0, y0, x1, y1 = box
    if (x1 - x0, y1 - y0) == (xsize, ysize) and all(
            float(v).is_integer() for v in (x0, y0)):
        return img[int(y0):int(y1), int(x0):int(x1)].copy()
    need_h = xsize != w or x0 != 0 or x1 != xsize
    need_v = ysize != h or y0 != 0 or y1 != ysize
    hmin, _, hfix = _coeffs(w, x0, x1, xsize)
    vmin, vcount, vfix = _coeffs(h, y0, y1, ysize)
    if need_h:
        # the horizontal pass runs over the rows the vertical pass reads
        first, last = int(vmin[0]), int(vmin[-1] + vcount[-1])
        img = _pass(img[first:last], 1, hmin, hfix)
        vmin = vmin - first
    if need_v:
        img = _pass(img, 0, vmin, vfix)
    return img


def _random_resized_crop(img: np.ndarray, size: int, scale=(0.9, 1.0),
                         ratio=(3 / 4, 4 / 3),
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (10 tries then center
    fallback), the JAX transform's draws in its order."""
    rng = rng or random
    h, w = img.shape[:2]
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return resize_bicubic(img, (size, size), (x, y, x + cw, y + ch))
    # fallback: center crop of the constrained aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    return resize_bicubic(img, (size, size), (x, y, x + cw, y + ch))


def _resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    short = min(w, h)
    nw, nh = int(round(w * size / short)), int(round(h * size / short))
    img = resize_bicubic(img, (nw, nh))
    x, y = (nw - size) // 2, (nh - size) // 2
    return img[y:y + size, x:x + size]


def _gray(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L").convert("RGB")."""
    rgb = img.astype(np.uint32)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
           + 0x8000) >> 16
    return np.repeat(lum.astype(np.uint8)[..., None], 3, axis=2)


class ImageTransform:
    """f(image[, seed]) -> np.float32 [H, W, 3], normalised NHWC; a class
    rather than a closure so that decode workers can receive it. `seed`
    (train only) draws this call's crop from random.Random(seed); without
    it the crop draws from `rng`, or from the `random` module when that is
    None, as the JAX transform does."""

    def __init__(self, image_size: int, is_train: bool, mean, std, scale,
                 ratio, gray_prob, rng: Optional[random.Random]):
        self.image_size = image_size
        self.is_train = is_train
        self.mean, self.std = mean, std
        self.scale, self.ratio = scale, ratio
        self.gray_prob = gray_prob
        self.rng = rng

    def __call__(self, img, seed: Optional[int] = None) -> np.ndarray:
        img = _to_rgb(img)
        if self.is_train:
            r = random.Random(seed) if seed is not None else self.rng
            img = _random_resized_crop(img, self.image_size,
                                       scale=self.scale, ratio=self.ratio,
                                       rng=r)
            if self.gray_prob and (r or random).random() < self.gray_prob:
                img = _gray(img)
        else:
            img = _resize_center_crop(img, self.image_size)
        return _normalize(img, self.mean, self.std)


def image_transform(image_size: int, is_train: bool,
                    mean: Optional[Sequence[float]] = None,
                    std: Optional[Sequence[float]] = None,
                    rng: Optional[random.Random] = None,
                    autoaugment: bool = False,
                    aug_cfg: Optional[Union[AugmentationCfg, Dict, list]] = None
                    ) -> ImageTransform:
    """The JAX `image_transform`'s preprocessing as an `ImageTransform`.
    aug_cfg is the open_CLIP AugmentationCfg (or its CLI 'k=v' list form).
    color_jitter and autoaugment raise NotImplementedError (ROADMAP Queue A
    item 3)."""
    mean = tuple(mean or OPENAI_DATASET_MEAN)
    std = tuple(std or OPENAI_DATASET_STD)
    if isinstance(image_size, (list, tuple)):
        # open_CLIP accepts (h, w); square towers here (transform.py:73-75)
        image_size = int(image_size[0])
    if isinstance(aug_cfg, (list, tuple)):
        aug_cfg = parse_aug_cfg(aug_cfg)
    elif isinstance(aug_cfg, dict):
        aug_cfg = AugmentationCfg(**aug_cfg)
    aug_cfg = aug_cfg or AugmentationCfg()
    if autoaugment:
        raise NotImplementedError("AutoAugment is not ported yet (ROADMAP "
                                  "Queue A item 3)")
    if aug_cfg.color_jitter is not None:
        raise NotImplementedError("color_jitter is not ported yet (ROADMAP "
                                  "Queue A item 3)")
    unused = [k for k in ("re_prob", "re_count", "interpolation")
              if getattr(aug_cfg, k) is not None]
    if aug_cfg.use_timm:
        unused.append("use_timm")
    if unused and is_train:
        warnings.warn(f"aug_cfg items not implemented natively, skipped: "
                      f"{unused} (open_CLIP transform.py non-timm parity)")
    ratio = tuple(aug_cfg.ratio) if aug_cfg.ratio else (3 / 4, 4 / 3)
    return ImageTransform(image_size, is_train, mean, std,
                          tuple(aug_cfg.scale), ratio,
                          aug_cfg.gray_scale_prob, rng)
