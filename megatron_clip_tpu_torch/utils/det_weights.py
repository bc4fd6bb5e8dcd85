"""Deterministic tensor generation for cross-implementation golden fixtures.

A copy of `megatron_clip_tpu/utils/det_weights.py` (numpy only), kept so the
port never imports the JAX package.

Full-size reference checkpoints (ViT-B-32 ~600 MB fp32) are too large to
commit, so the golden fixtures store only a (key, shape) manifest plus the
reference model's outputs; both sides — the fixture generator
(tools/make_openclip_goldens.py, run against open_CLIP) and the regression
tests (tests/test_openclip_goldens.py, tests/test_torch_goldens.py) —
regenerate each weight tensor from its state_dict key with this module.
numpy Philox is bit-deterministic across platforms, so the reconstruction is
exact.

Init laws keep 12-layer forward activations well-scaled (GPT-2-ish):
  - 1-D '*.weight' / '*ln*' scale params  -> 1 + 0.02 N
  - '*.bias'                              -> 0.01 N (nonzero: bias paths count)
  - logit_scale                           -> ln(1/0.07)
  - everything else (linears, embeddings) -> 0.02 N
"""
import hashlib

import numpy as np


def _rng_for(tag: str, key: str) -> np.random.Generator:
    h = hashlib.sha256(f"{tag}:{key}".encode()).digest()
    return np.random.Generator(np.random.Philox(
        key=np.frombuffer(h[:32], dtype=np.uint64)[:2]))


def _is_norm_weight(key: str, shape) -> bool:
    if len(shape) != 1:
        return False
    leaf = key.rsplit(".", 1)[-1]
    if leaf != "weight":
        return False
    parent = key.rsplit(".", 2)[-2] if "." in key else ""
    # embeddings are 2-D, so a 1-D '.weight' is a norm scale — except
    # torch LayerNorm and HF *LayerNorm modules are the only 1-D weights
    # in the model families covered here.
    return True if parent else False


def det_tensor(tag: str, key: str, shape) -> np.ndarray:
    """Deterministic float32 tensor for state_dict entry `key`."""
    shape = tuple(int(s) for s in shape)
    if key.endswith("logit_scale"):
        return np.full(shape, np.log(1.0 / 0.07), dtype=np.float32)
    g = _rng_for(tag, key)
    n = g.standard_normal(shape)
    if _is_norm_weight(key, shape):
        return (1.0 + 0.02 * n).astype(np.float32)
    if key.endswith(".bias") or key.rsplit(".", 1)[-1] == "bias":
        return (0.01 * n).astype(np.float32)
    return (0.02 * n).astype(np.float32)


def det_state_dict(tag: str, manifest) -> dict:
    """manifest: iterable of (key, shape) -> {key: np.ndarray}."""
    return {k: det_tensor(tag, k, s) for k, s in manifest}


def det_images(tag: str, batch: int, size: int) -> np.ndarray:
    """Deterministic NHWC float32 image batch (standard normal)."""
    g = _rng_for(tag, "__images__")
    return g.standard_normal((batch, size, size, 3)).astype(np.float32)


def det_texts(tag: str, batch: int, length: int, vocab: int,
              sot: int = None, eot: int = None, pad_tail: int = 0,
              pad_id: int = 0, low: int = 1) -> np.ndarray:
    """Deterministic token batch: ids in [low, vocab-2); optional SOT at 0 and
    EOT placed before a pad tail (row i pads its last `pad_tail`+i%3 slots)."""
    g = _rng_for(tag, "__texts__")
    hi = max(low + 1, vocab - 2)
    t = g.integers(low, hi, size=(batch, length)).astype(np.int64)
    if sot is not None:
        t[:, 0] = sot
    for i in range(batch):
        end = length - (pad_tail + i % 3) if pad_tail else length
        end = max(2, end)
        if eot is not None:
            t[i, end - 1] = eot
        t[i, end:] = pad_id
    return t
