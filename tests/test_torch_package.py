"""Rules of the port package: it imports neither JAX nor the JAX package,
its entry points refuse to run on the CPU unless asked, and a CPU tensor
takes a kernel's plain version without counting a launch."""
import ast
import os

import numpy as np
import pytest
import torch

import megatron_clip_tpu_torch
from megatron_clip_tpu_torch import create_model
from megatron_clip_tpu_torch.ops.kernels import _build
from megatron_clip_tpu_torch.ops.kernels.fused_mha import fused_mha_fwd
from megatron_clip_tpu_torch.ops.kernels.layernorm import layer_norm_fwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(megatron_clip_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "megatron_clip_tpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_no_pil_outside_the_fixture_writer():
    """The card's machine has no PIL: no port module (nor chip_smoke.py)
    imports it at module level, and only the JPEG fixture writer
    (`tools/jpeg_goldens.py`, run where Pillow is installed) imports it,
    inside the functions that encode and decode with Pillow."""
    writer = os.path.join(PKG, "tools", "jpeg_goldens.py")
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.split(".")[0] == "PIL" for n in names) and (
                    path != writer or id(node) in top):
                bad.append((os.path.relpath(path, ROOT), node.lineno))
    assert bad == []


def test_create_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("ViT-B-32")


def test_cpu_tensors_take_the_plain_versions_without_launches():
    before = (fused_mha_fwd.launches, layer_norm_fwd.launches)
    model = create_model(
        "ViT-B-32", precision="fp32", device="cpu", embed_dim=32,
        vision_cfg={"image_size": 32, "layers": 1, "width": 64,
                    "head_width": 32, "patch_size": 16},
        text_cfg={"width": 64, "heads": 2, "layers": 1, "context_length": 8,
                  "vocab_size": 100})
    feats = model(np.zeros((2, 32, 32, 3), np.float32),
                  np.array([[1, 5, 99, 0, 0, 0, 0, 0]] * 2))
    assert feats["image_features"].shape == (2, 32)
    assert feats["text_features"].shape == (2, 32)
    assert (fused_mha_fwd.launches, layer_norm_fwd.launches) == before


def test_kernel_build_targets_track_the_sources():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert name in target.name and target.suffix == ".so"
