"""GPT pretraining dataset: the epoch, shuffle and sample-packing indices
over an MMapIndexedDataset.

A copy of `megatron_clip_tpu/data/gpt_dataset.py` (plain NumPy), kept so
the port never imports the JAX package; the packing index comes from the
port's host C library (`data/helpers.py`, `csrc/dataset_helpers.c`).
megatron/data/gpt_dataset.py:240-586's three-index design:
  doc_idx    : documents repeated num_epochs times, shuffled;
  sample_idx : [n_samples+1, 2] (doc position, token offset) packing
               boundaries;
  shuffle_idx: permutation over samples.
doc_idx and sample_idx are cached as .npy next to the data, or under
`cache_dir` (megatron --data-cache-path), in the JAX package's file names,
so either package reads the other's cache.
"""
import os
from typing import Iterator

import numpy as np

from megatron_clip_tpu_torch.data.helpers import (build_blending_indices,
                                                  build_sample_idx)
from megatron_clip_tpu_torch.data.indexed_dataset import MMapIndexedDataset
from megatron_clip_tpu_torch.data.samplers import batch_indices_iterator


def train_valid_test_split(splits: str, n_docs: int):
    """megatron --split semantics (megatron/data/dataset_utils.py
    get_train_valid_test_split_): comma-separated weights, e.g. '969,30,1',
    normalized to doc-index ranges [(lo, hi)] * 3."""
    w = [float(x) for x in splits.split(",")]
    w += [0.0] * (3 - len(w))
    total = sum(w[:3]) or 1.0
    bounds = [0]
    for x in w[:3]:
        # clamp every bound: cumulative rounding can overshoot n_docs
        # mid-list ('1,1,0' over 7 docs rounds to [0,4,8]), which would
        # index nonexistent documents
        nxt = bounds[-1] + int(round(x / total * n_docs))
        bounds.append(min(max(nxt, bounds[-1]), n_docs))
    bounds[-1] = n_docs
    return [(bounds[i], bounds[i + 1]) for i in range(3)]


class GPTDataset:
    def __init__(self, prefix: str, seq_length: int, num_samples: int = 0,
                 seed: int = 0, cache: bool = True, documents=None,
                 split_tag: str = "", cache_dir: str = None):
        """`documents`: optional int32 doc-index array restricting the
        dataset to a doc range (megatron's train/valid/test splits —
        gpt_dataset.py:240 takes the same argument). `split_tag` names the
        split in the index cache path. `cache_dir` redirects the index
        cache away from the (possibly read-only) data directory (megatron
        --data-cache-path)."""
        self.data = MMapIndexedDataset(prefix)
        self.seq_length = seq_length
        if documents is None:
            docs = np.arange(len(self.data.doc_idx) - 1, dtype=np.int32)
        else:
            docs = np.asarray(documents, np.int32)
        # sizes stays the FULL array: the packing helper indexes it by the
        # actual doc ids in doc_idx (sizes[doc_idx[pos]], csrc/dataset_helpers.c)
        sizes = self.data.sizes
        tokens_per_epoch = int(self.data.sizes[docs].sum())
        if tokens_per_epoch <= seq_length:
            raise ValueError(
                f"corpus split has {tokens_per_epoch} tokens — smaller than "
                f"one sample (--seq-length {seq_length} + 1); not enough "
                "data to train on")
        samples_per_epoch = max(1, (tokens_per_epoch - 1) // seq_length)
        num_epochs = max(1, -(-num_samples // samples_per_epoch)) if num_samples else 1

        rng = np.random.RandomState(seed)
        doc_idx = np.concatenate([docs] * num_epochs)
        rng.shuffle(doc_idx)

        # the doc RANGE must key the cache, not just the split name:
        # changing --split weights would otherwise silently reuse a stale
        # index built over a different doc range (split leakage)
        tag = (f"_{split_tag}{int(docs[0])}-{int(docs[-1])}"
               if documents is not None and len(docs) else
               (f"_{split_tag}" if split_tag else ""))
        cache_base = prefix
        if cache_dir:
            import hashlib
            os.makedirs(cache_dir, exist_ok=True)
            # key by the full corpus path, not just the basename — two
            # corpora named 'corpus' must not share an index (megatron
            # hashes the path set into its cache key for the same reason)
            h = hashlib.sha1(os.path.abspath(prefix).encode()).hexdigest()[:10]
            cache_base = os.path.join(
                cache_dir, f"{os.path.basename(prefix)}_{h}")
        cache_path = (f"{cache_base}_gpt_s{seq_length}_e{num_epochs}_r{seed}"
                      f"{tag}_idx.npy")
        doc_path = cache_path.replace("_idx.npy", "_doc.npy")
        # a cache hit requires BOTH files: a crash between the two writes
        # (or a failed second save) must not leave a half-usable cache
        if cache and os.path.isfile(cache_path) and os.path.isfile(doc_path):
            self.sample_idx = np.load(cache_path)
            self.doc_idx = np.load(doc_path)
        else:
            self.doc_idx = doc_idx
            self.sample_idx = build_sample_idx(
                sizes, doc_idx, seq_length, num_epochs, tokens_per_epoch)
            if cache:
                try:
                    # temp-write + rename so concurrent loaders never read
                    # a truncated index; doc lands before idx so any idx
                    # presence implies a complete pair
                    pid = os.getpid()
                    for path, arr in ((doc_path, doc_idx),
                                      (cache_path, self.sample_idx)):
                        tmp = f"{path}.tmp{pid}"   # np.save appends .npy
                        np.save(tmp, arr)
                        os.replace(tmp + ".npy", path)
                except OSError:
                    pass
        n = len(self.sample_idx) - 1
        self.shuffle_idx = rng.permutation(n)

    def __len__(self):
        return len(self.shuffle_idx)

    def __getitem__(self, idx: int) -> np.ndarray:
        """Returns seq_length+1 tokens (inputs+shifted targets packed)."""
        idx = self.shuffle_idx[idx % len(self.shuffle_idx)]
        doc_pos_f, off_f = self.sample_idx[idx]
        doc_pos_l, off_l = self.sample_idx[idx + 1]
        if doc_pos_f == doc_pos_l:
            return self.data.get(self.doc_idx[doc_pos_f], offset=off_f,
                                 length=off_l - off_f + 1)
        parts = [self.data.get(self.doc_idx[doc_pos_f], offset=off_f)]
        for p in range(doc_pos_f + 1, doc_pos_l):
            parts.append(self.data.get(self.doc_idx[p]))
        parts.append(self.data.get(self.doc_idx[doc_pos_l], length=off_l + 1))
        return np.concatenate(parts)


def gpt_batch_iterator(prefix: str, batch_size: int, seq_length: int,
                       seed: int = 0, split: str = "",
                       split_index: int = 0,
                       cache_dir: str = None, *,
                       start_sample: int = 0,
                       dataloader_type: str = "single",
                       data_sharding: bool = False) -> Iterator[np.ndarray]:
    """Infinite [B, seq_length+1] int32 batches. `start_sample` seeks O(1)
    (consumed-samples resume: the sampler position is arithmetic, no batch
    is decoded to skip). `split`: megatron --split weights ('969,30,1');
    split_index 0/1/2 = train/valid/test doc range. `dataloader_type`:
    megatron --dataloader-type — 'single' sequential over the dataset's
    shuffle index, 'cyclic' the MegatronPretrainingRandomSampler law
    (data_samplers.py:93, per-epoch reshuffle on top of the packing
    index)."""
    documents, tag = None, ""
    if split:
        n_docs = len(MMapIndexedDataset(prefix).doc_idx) - 1
        lo, hi = train_valid_test_split(split, n_docs)[split_index]
        if hi <= lo:
            raise ValueError(f"--split {split!r} gives an empty range for "
                             f"split {split_index} ({n_docs} docs)")
        documents = np.arange(lo, hi, dtype=np.int32)
        tag = ("train", "valid", "test")[split_index]
    ds = GPTDataset(prefix, seq_length, seed=seed, documents=documents,
                    split_tag=tag, cache_dir=cache_dir)
    for idx in batch_indices_iterator(
            len(ds), batch_size, dataloader_type=dataloader_type,
            consumed_samples=start_sample, data_sharding=data_sharding,
            seed=seed):
        yield np.stack([np.asarray(ds[int(j)], np.int32)[:seq_length + 1]
                        for j in idx])


class BlendableDataset:
    """Weighted mixture of datasets (megatron/data/blendable_dataset.py:127)
    using the host helper build_blending_indices."""

    def __init__(self, datasets, weights, size: int):
        if len(datasets) != len(weights):
            raise ValueError(f"{len(datasets)} datasets, "
                             f"{len(weights)} weights")
        self.datasets = datasets
        self.ds_index, self.ds_sample_index = build_blending_indices(
            np.asarray(weights, np.float64), size)
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        return self.datasets[self.ds_index[i]][int(self.ds_sample_index[i])]
