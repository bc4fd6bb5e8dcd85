"""Megatron pretraining sampler laws, O(1)-seekable by consumed samples.

A copy of `megatron_clip_tpu/data/samplers.py` (plain NumPy; the torch
permutation through the port's own torch), kept so the port never imports
the JAX package. The reference builds its dataloaders from two batch
samplers (megatron/data/data_samplers.py):

- `MegatronPretrainingSampler` (:48, --dataloader-type single): sequential
  sample ids starting at consumed_samples; each rank takes its
  micro-batch-sized slice of every (micro x dp)-sized global batch.
- `MegatronPretrainingRandomSampler` (:93, --dataloader-type cyclic): a
  fresh permutation per epoch; resume offsets into the current epoch's
  permutation by `consumed % active_total`; rank r takes every dp-th index
  (`idx_range_active[r::dp]`, :176), or with --data-sharding a contiguous
  bucket of its own (:162-169).

The generators yield GLOBAL batches of micro*dp ids in rank-major order,
[rank 0's microbatch, rank 1's, ...], as the JAX package draws them. Both
laws seek in O(1): the position is arithmetic on consumed_samples.

The permutation defaults to NumPy's PCG64 seeded by (seed + epoch);
`perm_impl="torch"` (`--sampler-rng torch`, env MCT_SAMPLER_RNG=torch)
draws it with `torch.Generator().manual_seed(seed + epoch)` and
`torch.randperm`, megatron's generator. Megatron seeds it with the bare
epoch, so the torch order is megatron's only at seed 0, although the JAX
package's --sampler-rng help calls it bit-exact (a reference defect,
matched here for parity).
"""
import os
from typing import Iterator, Optional

import numpy as np
import torch

_PERM_IMPLS = ("numpy", "torch")
_default_perm_impl = os.environ.get("MCT_SAMPLER_RNG", "numpy")


def set_default_perm_impl(impl: str) -> None:
    """Set the process-wide default permutation generator ("numpy" or
    "torch"). Entry points call this from --sampler-rng so every stream
    (gpt/bert/t5/ict) inherits it without threading a parameter."""
    if impl not in _PERM_IMPLS:
        raise ValueError(f"perm_impl must be one of {_PERM_IMPLS}: {impl!r}")
    global _default_perm_impl
    _default_perm_impl = impl


def _permutation(n: int, seed_val: int, impl: Optional[str]) -> np.ndarray:
    impl = impl or _default_perm_impl
    if impl == "torch":
        g = torch.Generator()
        g.manual_seed(int(seed_val))
        return torch.randperm(int(n), generator=g).numpy().astype(np.int64)
    if impl != "numpy":
        raise ValueError(f"perm_impl must be one of {_PERM_IMPLS}: {impl!r}")
    return np.random.default_rng(seed_val).permutation(n).astype(np.int64)


def _check(total_samples: int, micro_batch_size: int, dp: int):
    if total_samples <= 0:
        raise ValueError(f"no sample to consume: {total_samples}")
    if micro_batch_size <= 0 or dp <= 0:
        raise ValueError("micro_batch_size and data_parallel_size must be "
                         "positive")


def sequential_batch_indices(total_samples: int, micro_batch_size: int,
                             data_parallel_size: int = 1, *,
                             consumed_samples: int = 0,
                             wrap: bool = True) -> Iterator[np.ndarray]:
    """MegatronPretrainingSampler law (data_samplers.py:48-96): global
    batches of consecutive ids from consumed_samples, last partial batch
    dropped. wrap=True restarts at 0 when the dataset is exhausted (the
    infinite-iterator convention of this runtime; megatron's pre-expanded
    epoch indices make its one pass equivalent)."""
    _check(total_samples, micro_batch_size, data_parallel_size)
    gbs = micro_batch_size * data_parallel_size
    pos = consumed_samples % total_samples if wrap else consumed_samples
    while True:
        if pos + gbs > total_samples:
            if not wrap:
                return
            pos = 0  # drop the partial tail batch, like drop_last=True
        yield np.arange(pos, pos + gbs, dtype=np.int64)
        pos += gbs


def random_batch_indices(total_samples: int, micro_batch_size: int,
                         data_parallel_size: int = 1, *,
                         consumed_samples: int = 0,
                         data_sharding: bool = False,
                         seed: int = 0,
                         perm_impl: Optional[str] = None
                         ) -> Iterator[np.ndarray]:
    """MegatronPretrainingRandomSampler law (data_samplers.py:93-190) as an
    infinite stream of rank-major GLOBAL batches.

    Per epoch e the permutation is seeded by (seed + e) — megatron seeds
    its torch.Generator with the bare epoch (:167,:173); the added base
    seed generalizes that without changing the law. The epoch tail
    (total % (micro*dp) samples) is never drawn, matching drop-last.
    perm_impl="torch" (default: process setting, see set_default_perm_impl)
    reproduces the reference's torch.randperm stream bit-for-bit at
    seed=0."""
    _check(total_samples, micro_batch_size, data_parallel_size)
    dp = data_parallel_size
    micro = micro_batch_size
    mbts = micro * dp
    if total_samples < mbts:
        raise ValueError(f"dataset of {total_samples} samples cannot fill "
                         f"one {mbts}-sample global batch")
    last_batch_size = total_samples % mbts
    active_total = total_samples - last_batch_size
    consumed = consumed_samples
    # resume must land on a global-batch boundary (reference asserts this,
    # :155); round down — a mid-batch count can only come from a corrupted
    # metadata file
    consumed -= consumed % mbts
    while True:
        epoch = consumed // active_total
        current_epoch_samples = consumed % active_total
        if data_sharding:
            # contiguous per-rank buckets (:162-169)
            bucket_size = (total_samples // mbts) * micro
            bucket_offset = current_epoch_samples // dp
            perm = _permutation(bucket_size, seed + epoch,
                                perm_impl)[bucket_offset:]
            # rank r draws micro ids per step from ITS bucket
            n_steps = len(perm) // micro
            for b in range(n_steps):
                rows = [r * bucket_size + perm[b * micro:(b + 1) * micro]
                        for r in range(dp)]
                consumed += mbts
                yield np.concatenate(rows).astype(np.int64)
        else:
            # one shared permutation, rank r strided r::dp (:171-176)
            full_bucket_size = (total_samples // micro) * micro
            perm = _permutation(full_bucket_size, seed + epoch,
                                perm_impl)[current_epoch_samples:]
            per_rank = [perm[r::dp] for r in range(dp)]
            n_steps = min(len(p) for p in per_rank) // micro
            for b in range(n_steps):
                rows = [p[b * micro:(b + 1) * micro] for p in per_rank]
                consumed += mbts
                yield np.concatenate(rows).astype(np.int64)
        # epoch exhausted: advance to the next epoch boundary
        consumed = (consumed // active_total + 1) * active_total \
            if consumed % active_total else consumed


def batch_indices_iterator(total_samples: int, batch_size: int, *,
                           dataloader_type: str = "single",
                           consumed_samples: int = 0,
                           micro_batch_size: Optional[int] = None,
                           data_parallel_size: int = 1,
                           data_sharding: bool = False,
                           seed: int = 0,
                           perm_impl: Optional[str] = None
                           ) -> Iterator[np.ndarray]:
    """Entry-point helper: global batches of `batch_size` ids under either
    --dataloader-type law (build_pretraining_data_loader,
    data_samplers.py:14-46). micro_batch_size defaults to
    batch_size/data_parallel_size."""
    if micro_batch_size is None:
        if batch_size % data_parallel_size:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"dp {data_parallel_size}")
        micro_batch_size = batch_size // data_parallel_size
    if micro_batch_size * data_parallel_size != batch_size:
        raise ValueError("micro_batch_size * data_parallel_size must equal "
                         "batch_size for a global draw")
    if dataloader_type == "single":
        return sequential_batch_indices(
            total_samples, micro_batch_size, data_parallel_size,
            consumed_samples=consumed_samples)
    if dataloader_type == "cyclic":
        return random_batch_indices(
            total_samples, micro_batch_size, data_parallel_size,
            consumed_samples=consumed_samples, data_sharding=data_sharding,
            seed=seed, perm_impl=perm_impl)
    raise ValueError(f"{dataloader_type!r} dataloader type is not supported")


def sampled_batches(dataset, batch_size: int, *,
                    dataloader_type: str = "single",
                    consumed_samples: int = 0,
                    data_parallel_size: int = 1,
                    data_sharding: bool = False,
                    seed: int = 0,
                    collate=None) -> Iterator:
    """Draw batches from a random-access dataset under a sampler law.

    `dataset[idx]` rows are stacked per-key (dict rows) or np.stack'd
    (array rows) unless a custom `collate(rows)` is given. Seeking is O(1)
    in consumed_samples: no row is decoded before the first yielded batch.
    """
    idx_it = batch_indices_iterator(
        len(dataset), batch_size, dataloader_type=dataloader_type,
        consumed_samples=consumed_samples,
        data_parallel_size=data_parallel_size, data_sharding=data_sharding,
        seed=seed)
    for idx in idx_it:
        rows = [dataset[int(i)] for i in idx]
        if collate is not None:
            yield collate(rows)
        elif isinstance(rows[0], dict):
            yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        else:
            yield np.stack(rows)


def build_pretraining_data_loader(dataset, consumed_samples: int, *,
                                  micro_batch_size: int,
                                  data_parallel_rank: int = 0,
                                  data_parallel_size: int = 1,
                                  dataloader_type: str = "single",
                                  data_sharding: bool = True,
                                  seed: int = 0,
                                  collate=None) -> Iterator:
    """Reference-shaped entry point (megatron data_samplers.py:14
    build_pretraining_data_loader): an iterator of THIS RANK's
    micro-batches under either sampler law, resumed at consumed_samples.

    The global-batch generators above yield rank-major concatenations;
    this slices out rank r's micro_batch_size rows — rank r of a megatron
    run and rank r here draw the same sample ids."""
    if not 0 <= data_parallel_rank < data_parallel_size:
        raise ValueError(
            f"data_parallel_rank should be smaller than data size: "
            f"{data_parallel_rank}, {data_parallel_size}")
    idx_it = batch_indices_iterator(
        len(dataset), micro_batch_size * data_parallel_size,
        dataloader_type=dataloader_type, consumed_samples=consumed_samples,
        micro_batch_size=micro_batch_size,
        data_parallel_size=data_parallel_size, data_sharding=data_sharding,
        seed=seed)
    lo = data_parallel_rank * micro_batch_size
    for idx in idx_it:
        rows = [dataset[int(i)] for i in idx[lo:lo + micro_batch_size]]
        if collate is not None:
            yield collate(rows)
        elif isinstance(rows[0], dict):
            yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        else:
            yield np.stack(rows)
