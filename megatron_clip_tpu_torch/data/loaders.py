"""Host-side input pipelines: synthetic, CSV, and iterator plumbing.

Counterpart of `megatron_clip_tpu/data/loaders.py` (open_CLIP's get_data
dispatch, open_CLIP/src/training/data.py:434-545) with numpy-producing
iterators; the webdataset tar pipeline lives in `data/webdataset.py`.
Loaders yield (images [B, H, W, 3] float32, texts [B, ctx] int32) numpy
batches; the trainer moves them to the card.

Images are decoded by `data/decode.py` (no PIL). A loader calls its
preprocess as `preprocess(image, seed)`, with a seed of the sample's own
(`data/transforms.py::ImageTransform`), so that a train crop depends on the
sample and the epoch only, and a resumed run crops as the uninterrupted
one did; the JAX loaders crop from the `random` module's state.
"""
import os
import random
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from megatron_clip_tpu_torch.data.decode import decode_image


@dataclass
class DataInfo:
    """Mirror of open_CLIP's DataInfo (data.py:60-74)."""
    loader: Iterator
    num_batches: int
    num_samples: int

    def __iter__(self):
        return iter(self.loader)

    def __getattr__(self, name):
        # Delegate loader-control methods (set_epoch / skip_batches) to the
        # wrapped pipeline so callers holding the DataInfo wrapper reach
        # them: the resume fast-forward probes hasattr() on this object
        # (open_CLIP's DataInfo.set_epoch equivalent, data.py:66-69).
        if name.startswith("__") or name == "loader":
            raise AttributeError(name)
        return getattr(self.loader, name)


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The transform seed of sample `index` of an epoch."""
    return ((seed * 1_000_003 + epoch) << 32) + index


def read_image(path: str) -> np.ndarray:
    """A file's image as uint8 [H, W, 3]; corrupt bytes raise, as PIL's
    `Image.open` does in the JAX loaders."""
    with open(path, "rb") as f:
        img = decode_image(f.read())
    if img is None:
        raise ValueError(f"cannot decode image file {path!r}")
    return img


class SyntheticData:
    """open_CLIP --dataset-type synthetic (data.py:487-505): fixed random
    images + cycled captions, the JAX loader's RandomState draws, so the
    same seed gives the same batches."""

    CAPTIONS = [
        "a photo of a cat", "a photo of a dog", "a drawing of a car",
        "a blurry picture of a mountain", "an aerial view of a city",
        "a close up of a flower", "a photo of food on a table",
        "a person riding a bicycle",
    ]

    def __init__(self, batch_size: int, num_samples: int, image_size: int,
                 context_length: int = 77, seed: int = 0,
                 tokenizer: Optional[Callable] = None):
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.num_batches = max(1, num_samples // batch_size)
        rng = np.random.RandomState(seed)
        self._img = rng.randn(batch_size, image_size, image_size,
                              3).astype(np.float32)
        if tokenizer is None:
            texts = rng.randint(1, 49000, size=(len(self.CAPTIONS),
                                                context_length))
            texts[:, 0] = 49406
            texts[:, -1] = 49407
            self._txt_bank = texts.astype(np.int32)
        else:
            self._txt_bank = np.asarray(
                tokenizer(self.CAPTIONS, context_length), np.int32)
        self._skip = 0

    def skip_batches(self, n: int) -> None:
        self._skip = max(0, int(n))

    def __iter__(self):
        start, self._skip = self._skip, 0
        for i in range(start, self.num_batches):
            idx = (np.arange(self.batch_size) + i) % len(self._txt_bank)
            yield self._img, self._txt_bank[idx]


class CsvData:
    """open_CLIP CsvDataset (data.py:80-106): a separator-delimited file with
    an image-path column and a caption column; the epoch's order shuffled
    from seed + epoch as in the JAX loader."""

    def __init__(self, path: str, batch_size: int, preprocess: Callable,
                 tokenizer: Callable, *, sep: str = "\t",
                 img_key: str = "filepath", caption_key: str = "title",
                 shuffle: bool = True, seed: int = 0,
                 context_length: int = 77):
        import csv as _csv
        self.rows = []
        base = os.path.dirname(os.path.abspath(path))
        with open(path, newline="") as f:
            for row in _csv.DictReader(f, delimiter=sep):
                img = row[img_key]
                if not os.path.isabs(img):
                    img = os.path.join(base, img)
                self.rows.append((img, row[caption_key]))
        self.batch_size = batch_size
        self.num_samples = len(self.rows)
        self.num_batches = max(1, self.num_samples // batch_size)
        self.preprocess = preprocess
        self.tokenizer = tokenizer
        self.context_length = context_length
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._skip = 0

    def skip_batches(self, n: int) -> None:
        self._skip = max(0, int(n))

    def set_epoch(self, epoch: int) -> None:
        """Resync the shuffle epoch on resume: a mid-run resume into epoch
        N > 0 must replay epoch N's shuffle order, not epoch 0's."""
        self.epoch = int(epoch)

    def __iter__(self):
        order = list(range(self.num_samples))
        epoch = self.epoch
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(order)
        self.epoch += 1
        start, self._skip = self._skip, 0
        for b in range(start, self.num_batches):
            batch = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(batch) < self.batch_size:
                break
            imgs, caps = [], []
            for i in batch:
                path, cap = self.rows[i]
                imgs.append(self.preprocess(read_image(path),
                                            sample_seed(self.seed, epoch, i)))
                caps.append(cap)
            yield (np.stack(imgs),
                   np.asarray(self.tokenizer(caps, self.context_length),
                              np.int32))


def get_data(args, preprocess_train, preprocess_val, tokenizer,
             context_length: int = 77, image_size: int = 224) -> dict:
    """open_CLIP get_data analogue (data.py:527-545): returns
    {'train': DataInfo, 'val': DataInfo?} per args.dataset_type. A None
    `tokenizer` (no BPE vocabulary) gives synthetic data random token
    ids."""
    out = {}
    if args.dataset_type == "synthetic":
        n = args.train_num_samples or args.batch_size * 8
        ds = SyntheticData(args.batch_size, n, image_size,
                           context_length=context_length,
                           seed=args.seed, tokenizer=tokenizer)
        out["train"] = DataInfo(ds, ds.num_batches, n)
    elif args.dataset_type == "csv":
        ds = CsvData(args.train_data, args.batch_size, preprocess_train,
                     tokenizer, sep=args.csv_separator,
                     img_key=args.csv_img_key, caption_key=args.csv_caption_key,
                     seed=args.seed, context_length=context_length)
        out["train"] = DataInfo(ds, ds.num_batches, ds.num_samples)
        if args.val_data:
            vs = CsvData(args.val_data, args.batch_size, preprocess_val,
                         tokenizer, sep=args.csv_separator,
                         img_key=args.csv_img_key,
                         caption_key=args.csv_caption_key, shuffle=False,
                         context_length=context_length)
            out["val"] = DataInfo(vs, vs.num_batches, vs.num_samples)
    elif args.dataset_type == "webdataset":
        from megatron_clip_tpu_torch.data.webdataset import WdsData
        ds = WdsData(args.train_data, args.batch_size, preprocess_train,
                     tokenizer, num_samples=args.train_num_samples,
                     seed=args.seed, context_length=context_length,
                     workers=args.workers,
                     resampled=getattr(args, "dataset_resampled", False),
                     rank=getattr(args, "rank", 0),
                     world_size=getattr(args, "world_size", 1),
                     upsampling_factors=getattr(
                         args, "train_data_upsampling_factors", None))
        out["train"] = DataInfo(ds, ds.num_batches, ds.num_samples)
    else:
        raise ValueError(args.dataset_type)
    return out

