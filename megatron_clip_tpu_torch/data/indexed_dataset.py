"""Memory-mapped indexed token dataset (.bin + .idx).

A copy of `megatron_clip_tpu/data/indexed_dataset.py` (plain NumPy), kept
so the port never imports the JAX package. The byte format is megatron's
MMapIndexedDataset (megatron/data/indexed_dataset.py:226-408), so a corpus
written by either package, or by the reference's tools, is read by the
other:

  .idx: magic b'MMIDIDX\\x00\\x00' | version u64=1 | dtype-code u8 |
        n_sequences u64 | n_documents u64 | sizes i32[n] | pointers i64[n] |
        doc_idx i64[n_docs]
  .bin: the raw token array

The reader memory-maps both files; `get(i)` returns sequence i.
"""
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
           5: np.int64, 6: np.float64, 7: np.float32, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file(prefix) -> str:
    return str(prefix) + ".bin"


def index_file(prefix) -> str:
    return str(prefix) + ".idx"


class MMapIndexedDataset:
    def __init__(self, prefix: Union[str, Path]):
        with open(index_file(prefix), "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"bad index magic in {prefix}: {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (n_seq,) = struct.unpack("<Q", f.read(8))
            (n_doc,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        buf = np.memmap(index_file(prefix), mode="r")
        self.sizes = np.frombuffer(buf, np.int32, count=n_seq, offset=offset)
        offset += n_seq * 4
        self.pointers = np.frombuffer(buf, np.int64, count=n_seq,
                                      offset=offset)
        offset += n_seq * 8
        self.doc_idx = np.frombuffer(buf, np.int64, count=n_doc,
                                     offset=offset)
        self._bin = np.memmap(data_file(prefix), mode="r", dtype=self.dtype)

    def __len__(self) -> int:
        return len(self.sizes)

    def get(self, i: int, offset: int = 0,
            length: Optional[int] = None) -> np.ndarray:
        start = self.pointers[i] // self.dtype.itemsize + offset
        if length is None:
            length = self.sizes[i] - offset
        return np.asarray(self._bin[start:start + length])

    def __getitem__(self, i: int) -> np.ndarray:
        return self.get(i)


class MMapIndexedDatasetBuilder:
    """The writer (megatron indexed_dataset.py:349-403: add_item,
    end_document, merge_file, finalize)."""

    def __init__(self, prefix: Union[str, Path], dtype=np.int32):
        self.prefix = str(prefix)
        self.dtype = np.dtype(dtype)
        self._bin = open(data_file(prefix), "wb")
        self.sizes = []
        self.doc_idx = [0]
        self._offset = 0
        self.pointers = []

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self.pointers.append(self._offset)
        self._bin.write(arr.tobytes())
        self._offset += arr.nbytes
        self.sizes.append(len(arr))

    def end_document(self) -> None:
        self.doc_idx.append(len(self.sizes))

    def merge_file(self, other_prefix) -> None:
        other = MMapIndexedDataset(other_prefix)
        base = len(self.sizes)
        for i in range(len(other)):
            self.add_item(other.get(i))
        for d in other.doc_idx[1:]:
            self.doc_idx.append(base + int(d))

    def finalize(self) -> None:
        self._bin.close()
        with open(index_file(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self.sizes)))
            f.write(struct.pack("<Q", len(self.doc_idx)))
            f.write(np.asarray(self.sizes, np.int32).tobytes())
            f.write(np.asarray(self.pointers, np.int64).tobytes())
            f.write(np.asarray(self.doc_idx, np.int64).tobytes())
