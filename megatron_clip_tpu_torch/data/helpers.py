"""The GPT dataset's index helpers, from the host C library
`csrc/dataset_helpers.c`.

Counterpart of the two functions of `megatron_clip_tpu/data/native/` that
the GPT dataset calls (`build_sample_idx`, `build_blending_indices`; the
reference's megatron/data/helpers.cpp), bit-equal to them. The library is
built on first use by `ops/kernels/_build.py` with the host's C compiler;
without one the call raises, as the JPEG decoder does: there is no NumPy
fallback on the port's path. `build_sample_idx_numpy` is the plain version
the tests hold the library to. BERT's and ICT's mappings (`build_mapping`,
`build_blocks_mapping`) come with those datasets (ROADMAP Queue A item 7).
"""
import ctypes
from typing import Tuple

import numpy as np

from megatron_clip_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "build_sample_idx": ([_P, _P, ctypes.c_longlong, ctypes.c_int32,
                          ctypes.c_int32, ctypes.c_longlong, _P,
                          ctypes.c_longlong], ctypes.c_longlong),
    "build_blending_indices": ([_P, _P, _P, ctypes.c_int32, ctypes.c_int64],
                               ctypes.c_int),
}


def _lib():
    return _build.load("dataset_helpers", _SIGNATURES)


def num_samples(num_epochs: int, tokens_per_epoch: int,
                seq_length: int) -> int:
    return (num_epochs * tokens_per_epoch - 1) // seq_length


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_epochs: int, tokens_per_epoch: int) -> np.ndarray:
    """Sequence-packing index for GPT: [num_samples + 1, 2] int32 of
    (position in doc_idx, token offset), each sample seq_length + 1 tokens
    from its start."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    n = num_samples(num_epochs, tokens_per_epoch, seq_length)
    out = np.zeros((n + 1, 2), dtype=np.int32)
    got = _lib().build_sample_idx(
        sizes.ctypes.data, doc_idx.ctypes.data, len(doc_idx), seq_length,
        num_epochs, tokens_per_epoch, out.ctypes.data, n + 1)
    if got != n:
        raise RuntimeError(f"build_sample_idx wrote {got} samples, "
                           f"expected {n}")
    return out


def build_sample_idx_numpy(sizes: np.ndarray, doc_idx: np.ndarray,
                           seq_length: int, num_epochs: int,
                           tokens_per_epoch: int) -> np.ndarray:
    """The plain version of `build_sample_idx`, one sample at a time."""
    n = num_samples(num_epochs, tokens_per_epoch, seq_length)
    out = np.zeros((n + 1, 2), dtype=np.int32)
    doc_pos, doc_offset = 0, 0
    for s in range(1, n + 1):
        remaining = seq_length + 1
        while remaining > 0:
            doc_len = int(sizes[doc_idx[doc_pos]]) - doc_offset
            remaining -= doc_len
            if remaining <= 0:
                doc_offset += doc_len + remaining - 1
                remaining = 0
            else:
                doc_pos += 1
                doc_offset = 0
                if doc_pos >= len(doc_idx):
                    doc_pos = len(doc_idx) - 1
                    remaining = 0
        out[s] = (doc_pos, doc_offset)
    return out


def build_blending_indices(weights: np.ndarray, size: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted dataset blend: (dataset index int16[size], the sample of
    that dataset int64[size]), the weights normalised to sum to 1."""
    weights = np.ascontiguousarray(weights, np.float64)
    weights = weights / weights.sum()
    ds_index = np.zeros(size, np.int16)
    ds_sample = np.zeros(size, np.int64)
    if _lib().build_blending_indices(ds_index.ctypes.data,
                                     ds_sample.ctypes.data,
                                     weights.ctypes.data, len(weights),
                                     size):
        raise MemoryError("build_blending_indices: out of memory")
    return ds_index, ds_sample
