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

The backward kernels: fp32 against the fp32 plain version 2e-4 (MHA, as
tests/test_fused_mha.py holds the TPU kernel's gradients) and 1e-5 for the
LN dx (1e-4 absolute for dscale and dbias, sums over every row taken in
another order). bf16 MHA gradients against the plain version on the same
bf16 tensors within two bf16 ulps (rtol 1.6e-2) plus 2^-7 of the largest
|value|: the kernel forms dP in another summation order, so a rounding of
dS to bf16 can flip, which moves one term of dQ or dK by 2^-8 |dS K|, far
below that floor; against the plain version in fp32, 2e-2 relative plus
2^-5 of the largest |value| (the roundings of P, dS and the outputs).
"""
import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
    fused_mha_plain)
from megatron_clip_tpu_torch.ops.kernels.layernorm import (
    layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd,
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


MHA_BWD_SHAPES = [(3, 50, 12, 64, False), (3, 77, 8, 64, True),
                  (2, 1024, 2, 128, False), (2, 1024, 2, 128, True),
                  (2, 130, 3, 40, True), (2, 33, 3, 36, False)]


def _close_grads(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        want = want.float()
        floor = float(want.abs().max())
        torch.testing.assert_close(got.float(), want, rtol=1.6e-2,
                                   atol=2 ** -7 * floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", MHA_BWD_SHAPES)
def test_fused_mha_probs_and_backward_match_plain(cuda, dtype, b, s, h, d,
                                                  causal):
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, dtype)
    scale = d ** -0.5
    out, p = fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
    want_out, want_p = fused_mha_plain(qkv, h, scale, causal,
                                       with_probs=True)
    assert p.shape == (b, h, s, s) and p.dtype == dtype
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(out, want_out, rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(p, want_p, rtol=tol[0], atol=tol[1])
    if causal:
        assert not p.float().triu(1).any()
    before = fused_mha_bwd.launches
    got = fused_mha_bwd(qkv, do, want_p, h, causal=causal)
    assert fused_mha_bwd.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == dtype
    _close_grads(got, fused_mha_bwd_plain(qkv, do, want_p, h, scale), dtype)
    if dtype == torch.bfloat16:
        want32 = fused_mha_bwd_plain(qkv.float(), do.float(),
                                     want_p.float(), h, scale)
        torch.testing.assert_close(
            got.float(), want32, rtol=2e-2,
            atol=2 ** -5 * float(want32.abs().max()))


def test_fused_mha_autograd_runs_both_kernels(cuda):
    gen = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 77, 3 * 8 * 64, generator=gen).to(cuda)
    qkv.requires_grad_(True)
    do = torch.randn(2, 77, 8 * 64, generator=gen).to(cuda)
    before = (fused_mha_fwd.launches, fused_mha_bwd.launches)
    (got,) = torch.autograd.grad(fused_mha(qkv, 8, causal=True), qkv, do)
    assert (fused_mha_fwd.launches, fused_mha_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    x = qkv.detach().requires_grad_(True)
    q, k, v = x.reshape(2, 77, 3, 8, 64).permute(2, 0, 3, 1, 4).unbind(0)
    ref = torch.softmax((q @ k.transpose(-1, -2)) / 8 + torch.full(
        (77, 77), float("-inf"), device=cuda).triu(1), -1) @ v
    (want,) = torch.autograd.grad(ref.transpose(1, 2).reshape(2, 77, -1), x,
                                  do)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w", [(19200, 768), (77, 512), (5, 100),
                                    (3, 4100), (4097, 1024)])
def test_layer_norm_backward_matches_plain(cuda, dtype, rows, w):
    rng = np.random.default_rng(5)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in
             (rng.standard_normal((rows, w)) * 3 + 1,
              rng.standard_normal((rows, w))))
    scale = torch.from_numpy(rng.standard_normal(w).astype(np.float32)).to(
        cuda)
    x, dy = x.to(dtype), dy.to(dtype)
    before = layer_norm_bwd.launches
    dx, dscale, dbias = layer_norm_bwd(x, scale, dy)
    assert layer_norm_bwd.launches == before + 1
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    want = layer_norm_bwd_plain(x, scale, dy)
    tol = 1e-5 if dtype == torch.float32 else None
    if tol:
        torch.testing.assert_close(dx, want[0], rtol=tol, atol=tol)
    else:
        torch.testing.assert_close(dx, want[0], rtol=8e-3, atol=4e-3)
        torch.testing.assert_close(
            dx.float(), layer_norm_bwd_plain(x.float(), scale, dy.float())[0],
            rtol=2e-2, atol=2e-2)
    for g, wg in zip((dscale, dbias), want[1:]):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-4)


def test_layer_norm_autograd_runs_both_kernels(cuda):
    x = torch.randn(50, 768, device=cuda, requires_grad=True)
    scale = torch.randn(768, device=cuda, requires_grad=True)
    bias = torch.randn(768, device=cuda, requires_grad=True)
    dy = torch.randn(50, 768, device=cuda)
    before = (layer_norm_fwd.launches, layer_norm_bwd.launches)
    got = torch.autograd.grad(layer_norm(x, scale, bias), (x, scale, bias),
                              dy)
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(torch.nn.functional.layer_norm(
        x, (768,), scale, bias, 1e-5), (x, scale, bias), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
