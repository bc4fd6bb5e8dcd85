"""ImageFolder-style classification data (reference:
megatron/data/image_folder.py + vit_dataset.py ClassificationTransform):
`root/<class_name>/*.png` directories -> (image, label) batches.

Counterpart of `megatron_clip_tpu/data/image_folder.py`, for the trainer's
zero-shot eval (`--imagenet-val`, `--imagenet-v2`). Images are decoded by
`data/decode.py` (PNG, PPM, BMP; JPEG and WebP raise, ROADMAP Queue A item
3) and train crops take a seed of the sample's own (`data/loaders.py`)."""
import os
import random
from typing import Iterator, List, Tuple

import numpy as np

from megatron_clip_tpu_torch.data.loaders import read_image, sample_seed
from megatron_clip_tpu_torch.data.transforms import image_transform

_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp", ".ppm", ".pgm")


def scan_image_folder(root: str, classes_fraction: float = 1.0,
                      per_class_fraction: float = 1.0,
                      class_names: List[str] = None,
                      ) -> Tuple[List[Tuple[str, int]], List[str]]:
    """classes_fraction / per_class_fraction subsample the folder like
    megatron's --classes-fraction / --data-per-class-fraction
    (megatron/data/image_folder.py): keep the first fraction of classes,
    and of each kept class's files. `class_names` pins the label space to
    an existing class list (the TRAIN split's) so a val/ directory missing
    some classes still maps names to the same indices."""
    present = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if class_names is not None:
        unknown = [d for d in present if d not in class_names]
        if unknown:
            raise ValueError(f"{root} has class dirs absent from the "
                             f"training label space: {unknown}")
        classes = list(class_names)
        scan = [(classes.index(d), d) for d in present]
    else:
        classes = present
        if classes_fraction < 1.0:
            classes = classes[:max(1, int(len(classes) * classes_fraction))]
        scan = list(enumerate(classes))
    samples = []
    for idx, c in scan:
        cdir = os.path.join(root, c)
        files = sorted(os.listdir(cdir))
        if per_class_fraction < 1.0:
            files = files[:max(1, int(len(files) * per_class_fraction))]
        for fn in files:
            if fn.lower().endswith(_EXTS):
                samples.append((os.path.join(cdir, fn), idx))
    return samples, classes


def image_folder_batches(root: str, batch_size: int, image_size: int, *,
                         is_train: bool = True, seed: int = 0,
                         epochs: int = -1, classes_fraction: float = 1.0,
                         per_class_fraction: float = 1.0,
                         samples: List[Tuple[str, int]] = None,
                         class_names: List[str] = None,
                         skip_batches: int = 0) -> Iterator:
    """`samples` reuses a prior scan_image_folder result (an ImageNet-size
    directory walk is slow — don't repeat it per epoch); `class_names` pins
    the label space when scanning (see scan_image_folder). `skip_batches`
    seeks decode-free: skipped epochs only replay the (cheap) shuffle to
    keep the rng stream aligned, skipped in-epoch batches are never
    opened."""
    if samples is None:
        samples, _ = scan_image_folder(root, classes_fraction,
                                       per_class_fraction,
                                       class_names=class_names)
    if not samples:
        raise ValueError(f"no class-dir images under {root}")
    pp = image_transform(image_size, is_train=is_train)
    rng = random.Random(seed)
    epoch = 0
    pending_skip = max(0, int(skip_batches))
    while epochs < 0 or epoch < epochs:
        order = list(range(len(samples)))
        if is_train:
            rng.shuffle(order)
        bpe = max(0, (len(order) - batch_size) // batch_size + 1)
        if pending_skip >= bpe > 0:
            pending_skip -= bpe
            epoch += 1
            continue
        start, pending_skip = pending_skip, 0
        for lo in range(start * batch_size,
                        len(order) - batch_size + 1, batch_size):
            imgs, labels = [], []
            for i in order[lo:lo + batch_size]:
                path, label = samples[i]
                imgs.append(pp(read_image(path), sample_seed(seed, epoch, i)))
                labels.append(label)
            yield np.stack(imgs), np.asarray(labels, np.int32)
        epoch += 1
