"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc: a CUDA kernel has no CPU mode, so
here on a CPU-only host every test skips (the `cuda` fixture decides, never
the module at import). The file imports neither JAX nor the JAX package, so
it also runs on a GPU machine without JAX, skipping the JAX-importing
conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: fp32 kernel vs fp32 plain version 2e-5 (MHA) and 1e-5 (LN), as
the JAX suite holds its kernels; bf16 kernel vs the plain version on the
same bf16 inputs, which rounds where the kernel rounds, one bf16 ulp (4e-3
abs + 8e-3 rel); bf16 kernel vs the plain version run in fp32 on the same
bf16 inputs 2e-2.
"""
import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch.ops.kernels.fused_mha import (fused_mha_fwd,
                                                           fused_mha_plain)
from megatron_clip_tpu_torch.ops.kernels.layernorm import (layer_norm_fwd,
                                                           layer_norm_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", [(3, 50, 12, 64, False),
                                            (3, 77, 8, 64, True),
                                            (1, 300, 2, 128, True),
                                            (2, 33, 3, 40, False)])
def test_fused_mha_kernel_matches_plain(cuda, dtype, b, s, h, d, causal):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    before = fused_mha_fwd.launches
    got = fused_mha_fwd(qkv, h, causal=causal)
    assert fused_mha_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, h * d)
    want = fused_mha_plain(qkv.float(), h, d ** -0.5, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(
            got, fused_mha_plain(qkv, h, d ** -0.5, causal), rtol=8e-3,
            atol=4e-3)


def test_fused_mha_kernel_refuses_what_it_does_not_take(cuda):
    qkv = torch.zeros(2, 8, 3 * 4 * 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mha_fwd(qkv.transpose(0, 1), 4)
    with pytest.raises(TypeError, match="dtype"):
        fused_mha_fwd(qkv.half(), 4)
    with pytest.raises(ValueError, match="range"):
        fused_mha_fwd(torch.zeros(1, 1025, 3 * 64, device=cuda), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w", [(1000, 768), (77, 512), (5, 100),
                                    (3, 4100)])
def test_layer_norm_kernel_matches_plain(cuda, dtype, rows, w):
    rng = np.random.default_rng(2)
    x, scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in
                      (rng.standard_normal((rows, w)) * 3 + 1,
                       rng.standard_normal(w), rng.standard_normal(w)))
    before = layer_norm_fwd.launches
    got = layer_norm_fwd(x.to(dtype), scale, bias)
    assert layer_norm_fwd.launches == before + 1
    assert got.dtype == dtype
    want = layer_norm_plain(x.to(dtype).float(), scale, bias)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(
            got, layer_norm_plain(x.to(dtype), scale, bias), rtol=8e-3,
            atol=4e-3)


def test_layer_norm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm_fwd(x.T, ones, zeros)
    with pytest.raises(TypeError, match="dtype"):
        layer_norm_fwd(x.half(), ones, zeros)
    with pytest.raises(ValueError, match="scale"):
        layer_norm_fwd(x, ones[:32], zeros)
