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

The bf16 forwards at the wgmma kernels' tile edges and the one-pass
forward at S <= 128 (csrc/attn_short_sm90.cuh, both product variants) are
held row by row (fused_mha_row_bound): one bf16 ulp of P on every term of a
row plus one output ulp, as kernel and plain version round P from fp32
values that differ in their last bits. The LayerNorm and RMSNorm forwards
at every path width (512 to 2048) and at row counts no block multiple,
under the LayerNorm bounds above.

The saved-P backward past S = 128 (csrc/attn_bwd_sm90.cuh's saved-P mode,
P in the forward's layout of rows padded to 16 bytes) is held row by row
at its tiles' edges, its bits equal on a second run and on the S-major
view; a P TMA cannot read goes to tc:: (route 2's bits). The
forward's padded P equals the plain P within one bf16 ulp.

The recompute backward is held to the same bounds against its plain
version (which recomputes the row statistics itself), and the one-pass
backward at S <= 128 (csrc/attn_short_bwd_sm90.cuh), both modes, also row
by row as the flash gradients below; the forward's row
statistics to 1e-4 relative (fp32 sums of up to 1,024 exponentials in
another order, rescaled per key tile). An S-major view gives every kernel
the same arithmetic as the contiguous tensor: equal results.

The flash-attention kernels: fp32 against the fp32 plain version 2e-5
(forward) and 5e-5 (gradients), as tests/test_flash_attention.py holds the
TPU kernels, with 1e-5 relative for the log-sum-exp (fp32 sums of up to
8,192 exponentials in another order). bf16 forward against the plain
version on the same inputs: the kernel rounds P per key tile (128 keys on
wgmma at D = 64 and 128, 64 on mma.sync) against the running max, the
plain version once against the row's max, so each
term of P.V may differ by one bf16 ulp of P: 2^-8 of the largest |v| plus
one ulp of the output (rtol 8e-3). bf16 gradients each row by row (one
query's dQ, one key's dK or dV): the row's error norm within 1e-2 of its
norm plus 1e-4 of the rms row norm. Under the causal mask the first keys'
gradients are 100x the typical one's, so a bound scaled by the largest
|value| would let a fault in most rows through; a dS, P or output rounded
the other way moves a row by one ulp, at most 2^-7, of one of its terms. The
fused backward adds dQ into fp32 with unordered adds (TMA reduce-adds at
D = 64 and 128, atomics at other D), whose order changes from run to
run: on a view its dQ is held to the contiguous run's within 1e-6 relative,
or in bf16 within two bf16 ulps, since its rounding can fall either way;
every other output of every kernel must be equal. The wgmma tile check of
each Hopper library (csrc/sm90.cuh) against the fp32 product of the same
bf16 tiles: 1e-5 relative plus 1e-4 (fp32 sums of 64 or 128 exact products).

The RMSNorm kernels (LayerNorm's without the mean and the bias) under the
LayerNorm bounds. The norm backwards at every path width with a scale of
either dtype: a bf16 scale gives dx bit-equal to the call on its fp32
values and dscale (dbias) that call's fp32 sums rounded once to bf16; a
second call gives the same bits. The fused lm-head cross entropy: loss and lse within
1e-5 absolute plus 2e-5 relative (fp32 logits summed in another order, the
softmax sum folded per 64-column partial), fp32 gradients within 1e-5
relative plus 5e-5 of the largest |value| (sums of T or V terms added with
atomics in an order that changes from run to run), bf16 gradients row by
row as the flash ones (dlogits rounded to bf16 on both sides from fp32
logits summed in another order; the bf16 backward on wgmma is held at its
tiles' edges against the plain version in its own chunked order).
"""
import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch.ops.dropout import AttentionDropout, philox_keep
from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha_mod
from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_bwd_recompute,
    fused_mha_bwd_recompute_plain, fused_mha_fwd, fused_mha_plain)
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
    qkv = torch.zeros(2, 8, 2 * 3 * 4 * 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mha_fwd(qkv[..., ::2], 4)
    qkv = qkv[..., :3 * 4 * 16]
    with pytest.raises(TypeError, match="dtype"):
        fused_mha_fwd(qkv.half(), 4)
    with pytest.raises(ValueError, match="range"):
        fused_mha_fwd(torch.zeros(1, 1025, 3 * 64, device=cuda), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w", [(1000, 768), (77, 512), (5, 100),
                                    (3, 4100), (24 * 257, 1280),
                                    (24 * 77, 1024)])
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


def _close_mha_rows(got, want, heads, rel=1e-2, floor=1e-4):
    """A packed gradient dqkv [B, S, 3*H*D] row by row, as the flash
    gradients: one query's dQ, one key's dK or dV of one head each within
    rel of its norm plus floor of the rms row norm."""
    b, s, w = got.shape
    for g, wt in zip(got.reshape(b, s, 3, heads, -1).unbind(2),
                     want.reshape(b, s, 3, heads, -1).unbind(2)):
        _close_rows(g, wt, rel, floor)


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


RECOMPUTE_SHAPES = [(4, 257, 16, 64, False), (4, 257, 16, 80, False),
                    (4, 77, 16, 64, True), (2, 1024, 2, 128, False),
                    (2, 1024, 2, 128, True), (2, 130, 3, 40, True),
                    (2, 45, 3, 36, True), (2, 33, 3, 36, False),
                    (24, 257, 16, 80, False), (64, 77, 12, 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", RECOMPUTE_SHAPES)
def test_fused_mha_stats_and_recompute_backward_match_plain(
        cuda, dtype, b, s, h, d, causal):
    gen = torch.Generator().manual_seed(6)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, dtype)
    scale = d ** -0.5
    out, stats = fused_mha_fwd(qkv, h, causal=causal, with_stats=True)
    want_out, want_stats = fused_mha_plain(qkv, h, scale, causal,
                                           with_stats=True)
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(out, want_out, rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    before = fused_mha_bwd_recompute.launches
    got = fused_mha_bwd_recompute(qkv, do, stats, h, causal=causal)
    assert fused_mha_bwd_recompute.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == dtype
    want = fused_mha_bwd_recompute_plain(qkv, do, h, scale, causal)
    _close_grads(got, want, dtype)
    if dtype == torch.bfloat16:
        want32 = fused_mha_bwd_recompute_plain(qkv.float(), do.float(), h,
                                               scale, causal)
        torch.testing.assert_close(
            got.float(), want32, rtol=2e-2,
            atol=2 ** -5 * float(want32.abs().max()))
        _close_mha_rows(got, want, h)
        _close_mha_rows(got, want32, h, rel=2e-2)


# The forward with row statistics at the wgmma kernels' tiles' edges
# (csrc/attn_fwd_sm90.cuh past S = 128, two-pass: 128-row blocks, 128-key
# tiles, K resident up to S = 1024 at D = 64, S = 896 at D = 80 (ViT-H/14's
# head: a 64-column and a 16-column panel) and S = 512 at D = 128, through
# the ring above; at S <= 128 and D = 64 the one-pass kernel of
# csrc/attn_short_sm90.cuh, at other D tc::fwd), both masks, rate 0 and
# 0.1, on the packed projection and on the [B, S, *] view of S-major
# storage, which must give the same bits. The output is held row by row
# (fused_mha_row_bound): both sides round P to bf16 from fp32 values that
# differ in their last bits, so a term of a row may move by one ulp of its
# P, and the output may round the other way.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 257, 512, 1024])
def test_fused_mha_wgmma_forward_at_tile_edges(cuda, s, d, causal, rate):
    b, h = 2, 3
    gen = torch.Generator().manual_seed(s + d + int(causal))
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    drop = AttentionDropout(rate, 0x0123456789ABCDEF, 2) if rate else None
    keep = None if drop is None else drop.multipliers(
        b, h, s, s, mha_mod.dropout_mult(rate, torch.bfloat16), cuda)

    def run(x):
        if drop is None:
            return fused_mha_fwd(x, h, causal=causal, with_stats=True)
        return mha_mod.fused_mha_dropout_fwd(x, h, drop, causal=causal)
    out, stats = run(qkv)
    want, want_stats = fused_mha_plain(qkv, h, d ** -0.5, causal,
                                       with_stats=True, keep=keep)
    assert out.shape == (b, s, h * d) and out.dtype == torch.bfloat16
    _within_row_bound(out, want, mha_mod.fused_mha_row_bound(qkv, h, causal,
                                                             keep))
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    out_v, stats_v = run(qkv.transpose(0, 1).contiguous().transpose(0, 1))
    if s > 1:  # at S = 1 both layouts are one order
        assert out_v.stride(0) < out_v.stride(1)
    assert torch.equal(out_v, out) and torch.equal(stats_v, stats)


def _within_row_bound(got, want, bound):
    err = (got.float() - want.float()).abs()
    used = float((err / bound).nan_to_num(nan=0.0, posinf=1e9).max())
    assert used <= 1, f"{used:.3f} of the row bound"


# The one-pass forward (csrc/attn_short_sm90.cuh: bf16, S <= 128, D = 64, a
# whole head per block; wgmma at S <= 64, mma.sync past it), asked for and
# as the route fused_mha.cu picks, at its key counts' edges and the paths'
# batches (ViT-B/32's 384 and 256, ViT-L/14's 64, ViT-H/14's 24) and heads,
# in each mode:
# the output within the row bound, P within one bf16 ulp, the statistics
# within 1e-4 relative (fp32 sums in another order), the three modes' outputs
# equal, and the same bits on a second run and on the S-major view.
@pytest.mark.parametrize("b,h", [(2, 3), (384, 8), (256, 12), (64, 12),
                                 (24, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 7, 50, 64, 65, 77, 127, 128])
def test_fused_mha_one_pass_forward_matches_plain(cuda, s, causal, b, h):
    d = 64
    gen = torch.Generator().manual_seed(s + 3 * b + int(causal))
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    view = qkv.transpose(0, 1).contiguous().transpose(0, 1)
    want, p_want = fused_mha_plain(qkv, h, d ** -0.5, causal,
                                   with_probs=True)
    _, stats_want = fused_mha_plain(qkv, h, d ** -0.5, causal,
                                    with_stats=True)
    bound = mha_mod.fused_mha_row_bound(qkv, h, causal)
    for route in ("auto", "one_pass"):
        kw = dict(causal=causal, route=route)
        out = fused_mha_fwd(qkv, h, **kw)
        out_p, p = fused_mha_fwd(qkv, h, with_probs=True, **kw)
        out_s, stats = fused_mha_fwd(qkv, h, with_stats=True, **kw)
        assert torch.equal(out_p, out) and torch.equal(out_s, out)
        _within_row_bound(out, want, bound)
        torch.testing.assert_close(p.float(), p_want.float(), rtol=8e-3,
                                   atol=1e-6)
        torch.testing.assert_close(stats, stats_want, rtol=1e-4, atol=1e-5)
        again, p_again = fused_mha_fwd(qkv, h, with_probs=True, **kw)
        out_v, p_v = fused_mha_fwd(view, h, with_probs=True, **kw)
        assert torch.equal(again, out) and torch.equal(p_again, p)
        assert torch.equal(out_v, out) and torch.equal(p_v, p)
        if s > 1:  # at S = 1 both layouts are one order
            assert out_v.stride(0) < out_v.stride(1)


def test_fused_mha_routes_refuse_what_they_do_not_take(cuda):
    qkv = torch.zeros(2, 65, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    for bad in (torch.zeros(2, 129, 3 * 2 * 64, device=cuda,
                            dtype=torch.bfloat16),     # S past one tile
                qkv.float(),                           # fp32
                torch.zeros(2, 65, 3 * 2 * 80, device=cuda,
                            dtype=torch.bfloat16)):    # D = 80
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mha_fwd(bad, 2, route="one_pass")
    with pytest.raises(ValueError, match="route"):
        fused_mha_fwd(qkv, 2, route="sdpa")


# The one-pass backward (csrc/attn_short_bwd_sm90.cuh: bf16, S <= 128,
# D = 64, a whole head per block; wgmma at S <= 64, mma.sync past it) in
# both modes, asked for and as the route fused_mha.cu picks, at its key
# counts' edges and the paths' shapes: the saved-P backward from the plain
# forward's P, the recompute backward from the kernel forward's statistics,
# against the plain versions elementwise and row by row (and against the
# fp32 plain version); one launch counted a call; the same bits on a second
# run, on the route "auto" and on the S-major view.
@pytest.mark.parametrize("saved", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("b,s,h,causal", [
    *((2, s, 3, c) for s in (1, 7, 50, 64, 65, 77, 128) for c in (False,
                                                                    True)),
    (384, 50, 12, False), (384, 77, 8, True), (64, 77, 12, True),
    (24, 77, 16, True)])
def test_fused_mha_one_pass_backward_matches_plain(cuda, b, s, h, causal,
                                                   saved):
    d, scale = 64, 64 ** -0.5
    gen = torch.Generator().manual_seed(s + 5 * b + int(causal))
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, torch.bfloat16)
    views = [t.transpose(0, 1).contiguous().transpose(0, 1)
             for t in (qkv, do)]
    if saved:
        _, p = fused_mha_plain(qkv, h, scale, causal, with_probs=True)
        fn = fused_mha_bwd

        def run(x, g, route="one_pass"):
            return fused_mha_bwd(x, g, p, h, causal=causal, route=route)

        def plain(dt):
            return fused_mha_bwd_plain(qkv.to(dt), do.to(dt), p.to(dt), h,
                                       scale)
    else:  # the kernel forward's statistics, as the train step's
        _, stats = fused_mha_fwd(qkv, h, causal=causal, with_stats=True)
        fn = fused_mha_bwd_recompute

        def run(x, g, route="one_pass"):
            return fused_mha_bwd_recompute(x, g, stats, h, causal=causal,
                                           route=route)

        def plain(dt):
            return fused_mha_bwd_recompute_plain(qkv.to(dt), do.to(dt), h,
                                                 scale, causal)
    before = fn.launches
    got = run(qkv, do)
    assert fn.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    want = plain(torch.bfloat16)
    _close_grads(got, want, torch.bfloat16)
    _close_mha_rows(got, want, h)
    _close_mha_rows(got, plain(torch.float32), h, rel=2e-2)
    view = run(*views)
    assert torch.equal(run(qkv, do), got)
    assert torch.equal(run(qkv, do, "auto"), got)
    assert torch.equal(view, got)
    if s > 1:  # at S = 1 both layouts are one order
        assert view.stride(0) < view.stride(1)


# The saved-P one-pass backward on a P an element into a larger buffer, so
# that P's first and last bytes lie off 16-byte boundaries (its edge heads'
# bytes in those granules are plain loads): the bits of the same P in an
# allocation of its own, down to P's total of 2 bytes (B = H = S = 1).
@pytest.mark.parametrize("b,s,h", [(1, 1, 1), (1, 7, 1), (2, 7, 3),
                                   (2, 50, 3), (2, 77, 3)])
def test_fused_mha_one_pass_backward_reads_p_off_its_alignment(cuda, b, s,
                                                               h):
    d = 64
    gen = torch.Generator().manual_seed(s + 7 * b)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, torch.bfloat16)
    _, p = fused_mha_plain(qkv, h, d ** -0.5, True, with_probs=True)
    buf = torch.full((p.numel() + 16,), float("nan"), device=cuda,
                     dtype=torch.bfloat16)
    shifted = buf[1:1 + p.numel()].view_as(p).copy_(p)
    assert shifted.data_ptr() % 16 != 0
    want = fused_mha_bwd(qkv, do, p, h, causal=True, route="one_pass")
    got = fused_mha_bwd(qkv, do, shifted, h, causal=True, route="one_pass")
    assert torch.equal(got, want)


def test_fused_mha_backward_routes_refuse_what_they_do_not_take(cuda):
    def args(s, d, dtype=torch.bfloat16):
        qkv = torch.zeros(2, s, 3 * 2 * d, device=cuda, dtype=dtype)
        do = torch.zeros(2, s, 2 * d, device=cuda, dtype=dtype)
        p = mha_mod.probs_buffer(2, 2, s, d, dtype, cuda).zero_()
        stats = torch.ones(2, 2, 2, s, device=cuda)
        return qkv, do, p, stats
    for s, d, dtype in ((129, 64, torch.bfloat16),   # S past one tile
                        (65, 80, torch.bfloat16),    # D = 80
                        (65, 64, torch.float32)):    # fp32
        qkv, do, p, stats = args(s, d, dtype)
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mha_bwd(qkv, do, p, 2, route="one_pass")
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mha_bwd_recompute(qkv, do, stats, 2, route="one_pass")
    qkv, do, p, stats = args(65, 64)
    with pytest.raises(ValueError, match="route"):
        fused_mha_bwd(qkv, do, p, 2, route="sdpa")
    with pytest.raises(ValueError, match="route"):
        fused_mha_bwd_recompute(qkv, do, stats, 2, route="sdpa")


# The recompute backward at the wgmma kernels' tiles' edges
# (csrc/attn_bwd_sm90.cuh: 128-row blocks; 128-key tiles at D = 64 and 80
# and 64 at D = 128 in part 1, 64-query tiles in part 2; at D = 80 a
# 64-column and a 16-column panel), both masks, rate 0 and 0.1, on the
# plain forward's statistics, bf16 gradients row by row; the [B, S, *] view
# of S-major storage must give the contiguous run's bits
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [129, 192, 257, 320, 512, 1024])
def test_fused_mha_wgmma_recompute_backward_at_tile_edges(cuda, s, d, causal,
                                                          rate):
    b, h = 2, 3
    gen = torch.Generator().manual_seed(s + d + int(causal) + 7)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, torch.bfloat16)
    drop = AttentionDropout(rate, 0x0123456789ABCDEF, 6) if rate else None
    keep = None if drop is None else drop.multipliers(
        b, h, s, s, mha_mod.dropout_mult(rate, torch.bfloat16), cuda)
    _, stats = fused_mha_plain(qkv, h, d ** -0.5, causal, with_stats=True,
                               keep=keep)

    def run(x, g):
        if drop is None:
            return fused_mha_bwd_recompute(x, g, stats, h, causal=causal)
        return mha_mod.fused_mha_dropout_bwd(x, g, stats, h, drop,
                                             causal=causal)
    got = run(qkv, do)
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    want = fused_mha_bwd_recompute_plain(qkv, do, h, d ** -0.5, causal, keep)
    _close_mha_rows(got, want, h)
    got_v = run(*(t.transpose(0, 1).contiguous().transpose(0, 1)
                  for t in (qkv, do)))
    assert got_v.stride(0) < got_v.stride(1)
    assert torch.equal(got_v, got)


# The saved-P backward past S = 128 at the wgmma kernels' tiles' edges
# (csrc/attn_bwd_sm90.cuh's saved-P mode: 128-row blocks, 128-key tiles at
# D = 64 and 80 and 64 at D = 128 in part 1, 64-query tiles in part 2, P
# read by TMA), both masks, on the plain forward's P in the forward's padded
# layout: bf16 gradients row by row (TOLERANCES["fused_mha_bwd rows"]),
# the same bits on a second run and on the S-major view, and tc:: (route
# 2) on the same P within the same bound
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [129, 192, 257, 320, 513, 1024])
def test_fused_mha_wgmma_saved_backward_at_tile_edges(cuda, s, d, causal):
    b, h = 2, 3
    gen = torch.Generator().manual_seed(s + d + int(causal) + 11)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, torch.bfloat16)
    _, p_plain = fused_mha_plain(qkv, h, d ** -0.5, causal, with_probs=True)
    p = mha_mod.probs_buffer(b, h, s, d, torch.bfloat16, cuda).copy_(p_plain)
    assert p.stride(2) == mha_mod.probs_pitch(s, d, torch.bfloat16)
    got = fused_mha_bwd(qkv, do, p, h, causal=causal)
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    want = fused_mha_bwd_plain(qkv, do, p, h, d ** -0.5)
    _close_mha_rows(got, want, h)
    assert torch.equal(fused_mha_bwd(qkv, do, p, h, causal=causal), got)
    got_v = fused_mha_bwd(*(t.transpose(0, 1).contiguous().transpose(0, 1)
                            for t in (qkv, do)), p, h, causal=causal)
    assert torch.equal(got_v, got)
    _close_mha_rows(fused_mha_bwd(qkv, do, p, h, causal=causal, route="tc"),
                    want, h)


# The saved-P backward's gate past S = 128: route 0 takes the forward's P
# to the wgmma pair, the same bits every run. The same P an element off its
# 16-byte alignment, which TMA cannot read, is refused there (so route 0 ran
# the wgmma pair's branch) while tc:: (route 2) takes it with the aligned
# P's bits; a P in any other layout (contiguous at S = 257, transposed) is
# refused by the wrapper. chip_smoke.py phase 3 holds the same refusal at
# the legs' shapes, and its MCT_BWD_TILE_FAULT builds show which kernels
# that route runs.
@pytest.mark.parametrize("d", [64, 80])
def test_fused_mha_saved_backward_gate(cuda, d):
    b, s, h = 2, 257, 3
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, torch.bfloat16)
    _, p = fused_mha_fwd(qkv, h, with_probs=True)
    pitch = mha_mod.probs_pitch(s, d, torch.bfloat16)
    buf = torch.zeros(b * h * s * pitch + 8, device=cuda,
                      dtype=torch.bfloat16)
    p_off = buf[1:1 + b * h * s * pitch].view(b, h, s, pitch)[..., :s]
    p_off.copy_(p)
    assert p_off.data_ptr() % 16 != 0
    got = fused_mha_bwd(qkv, do, p, h)
    assert torch.equal(fused_mha_bwd(qkv, do, p, h), got)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_mha_bwd(qkv, do, p_off, h)
    assert torch.equal(fused_mha_bwd(qkv, do, p_off, h, route="tc"),
                       fused_mha_bwd(qkv, do, p, h, route="tc"))
    for other in (p.contiguous(), p.transpose(-1, -2)):
        for route in ("auto", "tc"):
            with pytest.raises(ValueError, match="the forward's P"):
                fused_mha_bwd(qkv, do, other, h, route=route)


# P's row pitch as csrc/fused_mha.cu decides it (mct_fused_mha_probs_pitch):
# S where the one-pass kernels (S <= 128), tc:: or simt:: read P, S rounded
# up to 8 (16 bytes) for the bf16 wgmma kernels past S = 128 at D = 64, 80
# and 128; the forward writes P at it
@pytest.mark.parametrize("s,d,dtype,pitch", [
    (50, 64, torch.bfloat16, 50), (77, 64, torch.bfloat16, 77),
    (128, 64, torch.bfloat16, 128), (129, 64, torch.bfloat16, 136),
    (257, 64, torch.bfloat16, 264), (1024, 64, torch.bfloat16, 1024),
    (257, 80, torch.bfloat16, 264), (513, 128, torch.bfloat16, 520),
    (257, 40, torch.bfloat16, 257), (257, 64, torch.float32, 257)])
def test_probs_pitch_rounds_rows_past_the_one_pass_kernels(cuda, s, d, dtype,
                                                           pitch):
    assert mha_mod.probs_pitch(s, d, dtype) == pitch
    p = mha_mod.probs_buffer(2, 3, s, d, dtype, cuda)
    assert p.shape == (2, 3, s, s)
    assert p.stride() == (3 * s * pitch, s * pitch, pitch, 1)
    qkv = torch.zeros(1, s, 3 * d, device=cuda, dtype=dtype)
    _, p = fused_mha_fwd(qkv, 1, with_probs=True)
    assert p.stride(2) == pitch


# The forward's P past S = 128 in its padded layout (rows probs_pitch(S)
# apart, 16-byte stores from the wgmma forward's stage, element stores from
# tc::fwd on route 2): equal to the plain version's P within one bf16 ulp
# (TOLERANCES["fused_mha_fwd P"]), masked pairs 0, and the output the same
# bits as the forward's without P
@pytest.mark.parametrize("route", ["auto", "tc"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [129, 257, 320, 1024])
def test_fused_mha_forward_writes_p_in_the_padded_layout(cuda, s, d, causal,
                                                         route):
    b, h = 2, 3
    gen = torch.Generator().manual_seed(s + d)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda,
                                                         torch.bfloat16)
    out, p = fused_mha_fwd(qkv, h, causal=causal, with_probs=True,
                           route=route)
    assert p.shape == (b, h, s, s)
    assert p.stride() == (h * s * p.stride(2), s * p.stride(2),
                          mha_mod.probs_pitch(s, d, torch.bfloat16), 1)
    _, want = fused_mha_plain(qkv, h, d ** -0.5, causal, with_probs=True)
    torch.testing.assert_close(p, want, rtol=8e-3, atol=1e-6)
    if causal:
        assert not p.float().triu(1).any()
    assert torch.equal(out, fused_mha_fwd(qkv, h, causal=causal,
                                          route=route))


def test_fused_mha_autograd_recompute_runs_its_kernels(cuda):
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(2, 257, 3 * 4 * 80, generator=gen).to(cuda)
    qkv.requires_grad_(True)
    do = torch.randn(2, 257, 4 * 80, generator=gen).to(cuda)
    before = (fused_mha_fwd.launches, fused_mha_bwd.launches,
              fused_mha_bwd_recompute.launches)
    (got,) = torch.autograd.grad(fused_mha(qkv, 4, save_probs=False), qkv,
                                 do)
    assert (fused_mha_fwd.launches, fused_mha_bwd.launches,
            fused_mha_bwd_recompute.launches) == \
        (before[0] + 1, before[1], before[2] + 1)
    x = qkv.detach().requires_grad_(True)
    q, k, v = x.reshape(2, 257, 3, 4, 80).permute(2, 0, 3, 1, 4).unbind(0)
    ref = torch.softmax((q @ k.transpose(-1, -2)) * 80 ** -0.5, -1) @ v
    (want,) = torch.autograd.grad(ref.transpose(1, 2).reshape(2, 257, -1),
                                  x, do)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", [(8, 257, 4, 80, False),
                                            (8, 77, 4, 64, True),
                                            (3, 45, 2, 36, True)])
def test_smajor_views_for_every_attention_kernel(cuda, dtype, b, s, h, d,
                                                  causal):
    """Each kernel on the [B, S, *] view of [S, B, *] storage gives what it
    gives on the contiguous tensor, and returns S-major outputs."""
    gen = torch.Generator().manual_seed(8)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, dtype)
    qkv_v, do_v = (t.transpose(0, 1).contiguous().transpose(0, 1)
                   for t in (qkv, do))
    out, p = fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
    _, stats = fused_mha_fwd(qkv, h, causal=causal, with_stats=True)
    out_v, p_v = fused_mha_fwd(qkv_v, h, causal=causal, with_probs=True)
    out_v2, stats_v = fused_mha_fwd(qkv_v, h, causal=causal, with_stats=True)
    assert out_v.stride(0) < out_v.stride(1)
    for got, want in ((out_v, out), (out_v2, out), (p_v, p),
                      (stats_v, stats),
                      (fused_mha_fwd(qkv_v, h, causal=causal), out),
                      (fused_mha_bwd(qkv_v, do_v, p, h, causal=causal),
                       fused_mha_bwd(qkv, do, p, h, causal=causal)),
                      (fused_mha_bwd_recompute(qkv_v, do_v, stats, h,
                                               causal=causal),
                       fused_mha_bwd_recompute(qkv, do, stats, h,
                                               causal=causal))):
        assert torch.equal(got, want)
    dqkv_v = fused_mha_bwd_recompute(qkv_v, do_v, stats, h, causal=causal)
    assert dqkv_v.stride(0) < dqkv_v.stride(1)
    _close_grads(dqkv_v, fused_mha_bwd_recompute_plain(
        qkv_v, do_v, h, d ** -0.5, causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w", [(19200, 768), (77, 512), (5, 100),
                                    (3, 4100), (4097, 1024),
                                    (24 * 257, 1280), (64 * 77, 768)])
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


# (B, H, Sq, Sk, D, causal): GPT-345m's heads at a cut batch, ragged and
# cross lengths (not multiples of the kernels' 64-row tiles), D = 40 (tensor
# cores, padded to 48), D = 36 (CUDA cores in bf16 too) and D = 128
FLASH_SHAPES = [(2, 16, 2048, 2048, 64, True), (1, 2, 1100, 1100, 64, True),
                (1, 2, 4200, 4200, 64, True), (2, 3, 300, 200, 64, True),
                (2, 3, 200, 300, 64, False), (1, 2, 130, 260, 40, True),
                (1, 2, 77, 77, 36, True), (1, 1, 64, 64, 128, False)]


def _close_rows(got, want, rel=1e-2, floor=1e-4):
    """Each row (the last axis) within rel of its norm plus floor of the
    rms row norm."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    norms = want.norm(dim=-1)
    bound = rel * norms + floor * norms.square().mean().sqrt()
    err = (got - want).norm(dim=-1)
    assert bool((err <= bound).all()), float((err / bound).max())


def _flash_inputs(cuda, dtype, b, h, sq, sk, d, seed=9):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=gen).to(cuda, dtype)
            for s in (sq, sk, sk, sq)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, dtype, b, h, sq, sk, d, causal):
    q, k, v, do = _flash_inputs(cuda, dtype, b, h, sq, sk, d)
    scale = d ** -0.5
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    assert fa.flash_fwd.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(
            out.float(), want_out.float(), rtol=8e-3,
            atol=2 ** -8 * float(v.float().abs().max()))
    # the backward kernels on the plain forward's out and lse
    delta = fa.flash_delta(do, want_out)
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, causal=causal)
    fused = fa.flash_bwd_fused(q, k, v, want_out, want_lse, do,
                               causal=causal)
    wq = fa.flash_bwd_dq_plain(q, k, v, do, want_lse, delta, scale, causal)
    wk, wv = fa.flash_bwd_dkv_plain(q, k, v, do, want_lse, delta, scale,
                                    causal)
    for got, want in zip((dq, dk, dv, *fused), (wq, wk, wv) * 2):
        assert got.shape == want.shape and got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)
        else:
            _close_rows(got, want)
    if dtype == torch.float32 or d not in fa.WGMMA_FUSED_HEAD_DIMS:
        # the same kernel forms the fused and the split dK, dV
        assert torch.equal(fused[1], dk) and torch.equal(fused[2], dv)


# The wgmma fused backward at its tiles' edges (128-key blocks, 64- or
# 128-query tiles): lengths that are no multiple of them, Sq != Sk, both
# head dims it takes, both masks, rate 0 and 0.1, on the packed
# projection's views when Sq == Sk (bf16 gradients row by row)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(333, 333), (300, 200), (200, 300)])
def test_flash_wgmma_fused_backward_at_tile_edges(cuda, sq, sk, d, causal,
                                                  rate):
    b, h = 2, 3
    gen = torch.Generator().manual_seed(sq + sk + d)
    if sq == sk:
        qkv = torch.randn(b, sq, 3 * h * d, generator=gen).to(
            cuda, torch.bfloat16)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                       4).unbind(0)
        do = torch.randn(b, sq, h, d, generator=gen).to(
            cuda, torch.bfloat16).transpose(1, 2)
    else:
        q, k, v, do = _flash_inputs(cuda, torch.bfloat16, b, h, sq, sk, d)
    drop = AttentionDropout(rate, 0x0123456789ABCDEF, 3) if rate else None
    keep = None if drop is None else drop.multipliers(
        b, h, sq, sk, fa.dropout_mult(rate), cuda)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, scale, causal, keep)
    got = (fa.flash_bwd_fused(q, k, v, out, lse, do, causal=causal)
           if drop is None else
           fa.flash_bwd_fused_dropout(q, k, v, out, lse, do, drop,
                                      causal=causal))
    want = fa.flash_bwd_fused_plain(q, k, v, out, lse, do, scale, causal,
                                    keep)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close_rows(g, w)


# The wgmma split backward (dQ: 128-query blocks, 128- or 64-key tiles; dKV:
# 128-key blocks, 64-query tiles) at its tiles' edges: lengths that are no
# multiple of them, Sq != Sk, one length past the fused backward's reach,
# both head dims it takes, both masks, rate 0 and 0.1, on the packed
# projection's views when Sq == Sk (bf16 gradients row by row). Each output
# element has one owner, so a second run gives the same bits.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(333, 333), (300, 200), (200, 300),
                                   (4200, 4200)])
def test_flash_wgmma_split_backward_at_tile_edges(cuda, sq, sk, d, causal,
                                                  rate):
    b, h = (1, 2) if sq > 1024 else (2, 3)
    gen = torch.Generator().manual_seed(sq + sk + d + 1)
    if sq == sk:
        qkv = torch.randn(b, sq, 3 * h * d, generator=gen).to(
            cuda, torch.bfloat16)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                       4).unbind(0)
        do = torch.randn(b, sq, h, d, generator=gen).to(
            cuda, torch.bfloat16).transpose(1, 2)
    else:
        q, k, v, do = _flash_inputs(cuda, torch.bfloat16, b, h, sq, sk, d)
    drop = AttentionDropout(rate, 0x0123456789ABCDEF, 5) if rate else None
    keep = None if drop is None else drop.multipliers(
        b, h, sq, sk, fa.dropout_mult(rate), cuda)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, scale, causal, keep)
    delta = fa.flash_delta(do, out)

    def run():
        if drop is None:
            return (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
                    *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                      causal=causal))
        return (fa.flash_bwd_dq_dropout(q, k, v, do, lse, delta, drop,
                                        causal=causal),
                *fa.flash_bwd_dkv_dropout(q, k, v, do, lse, delta, drop,
                                          causal=causal))
    got = run()
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal,
                                  keep),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                    keep))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close_rows(g, w)
    for g, again in zip(got, run()):
        assert torch.equal(g, again)


# The wgmma flash forward (csrc/attn_fwd_sm90.cuh, online softmax) at its
# tiles' edges (128-row blocks, 128-key tiles), Sq != Sk, both head dims,
# both masks, rate 0 and 0.1; the packed projection's head views where
# Sq == Sk, which must give the bits of contiguous copies
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(256, 256), (2048, 2048), (2049, 2049),
                                   (700, 1100), (1100, 700)])
def test_flash_wgmma_forward_at_tile_edges(cuda, sq, sk, d, causal, rate):
    b, h = 1, 2
    gen = torch.Generator().manual_seed(sq + sk + d)
    if sq == sk:
        qkv = torch.randn(b, sq, 3 * h * d, generator=gen).to(
            cuda, torch.bfloat16)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                       4).unbind(0)
    else:
        q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, b, h, sq, sk, d)
    drop = AttentionDropout(rate, 0x0123456789ABCDEF, 4) if rate else None
    keep = None if drop is None else drop.multipliers(
        b, h, sq, sk, fa.dropout_mult(rate), cuda)

    def run(*qkv_):
        if drop is None:
            return fa.flash_fwd(*qkv_, causal=causal)
        return fa.flash_fwd_dropout(*qkv_, drop, causal=causal)
    out, lse = run(q, k, v)
    want, want_lse = fa.flash_fwd_plain(q, k, v, d ** -0.5, causal, keep)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=8e-3,
                               atol=2 ** -8 * float(want.float().abs().max()))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if sq == sk:
        out_c, lse_c = run(*(t.contiguous() for t in (q, k, v)))
        assert torch.equal(out_c, out) and torch.equal(lse_c, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_on_packed_views(cuda, dtype, causal):
    """q, k, v as head views of one [B, S, 3*H*D] projection give what the
    contiguous tensors give; the gradients land in one packed buffer."""
    b, s, h, d = 2, 1100, 4, 64
    gen = torch.Generator().manual_seed(10)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    do = torch.randn(b, h, s, d, generator=gen).to(cuda, dtype)
    views = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1, 4).unbind(0)
    copies = [t.contiguous() for t in views]
    out_v, lse_v = fa.flash_fwd(*views, causal=causal)
    out_c, lse_c = fa.flash_fwd(*copies, causal=causal)
    assert torch.equal(out_v, out_c) and torch.equal(lse_v, lse_c)
    delta = fa.flash_delta(do, out_c)
    for kernel in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        got = kernel(*views, do, lse_c, delta, causal=causal)
        want = kernel(*copies, do, lse_c, delta, causal=causal)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    dq, dk, dv, packed = fa.flash_bwd(*views, out_c, lse_c, do,
                                      causal=causal, scale=d ** -0.5)
    wq, wk, wv = fa.flash_bwd_fused(*copies, out_c, lse_c, do, causal=causal)
    assert packed.shape == (b, s, 3, h, d) and packed.is_contiguous()
    assert torch.equal(packed[:, :, 1].transpose(1, 2), wk)
    assert torch.equal(packed[:, :, 2].transpose(1, 2), wv)
    # the atomics' fp32 order moves dQ by fp32 ulps, so a bf16 dQ can round
    # the other way: two bf16 ulps (rtol 1.6e-2)
    torch.testing.assert_close(
        packed[:, :, 0].transpose(1, 2).float(), wq.float(), atol=1e-6,
        rtol=1e-6 if dtype == torch.float32 else 1.6e-2)


@pytest.mark.parametrize("s,fused", [(2048, True), (4200, False)])
def test_flash_autograd_runs_the_jax_packages_backward(cuda, s, fused):
    b, h, d = 1, 2, 64
    gen = torch.Generator().manual_seed(11)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda)
    qkv.requires_grad_(True)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda)
    counters = (fa.flash_fwd, fa.flash_bwd_fused, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    before = [f.launches for f in counters]
    (got,) = torch.autograd.grad(fa.flash_attention_qkv(qkv, h, causal=True),
                                 qkv, do)
    assert [f.launches - n for f, n in zip(counters, before)] == \
        ([1, 1, 0, 0] if fused else [1, 0, 1, 1])
    x = qkv.detach().requires_grad_(True)
    q, k, v = x.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    ref = torch.softmax((q @ k.transpose(-1, -2)) * d ** -0.5 + torch.full(
        (s, s), float("-inf"), device=cuda).triu(1), -1) @ v
    (want,) = torch.autograd.grad(ref.transpose(1, 2).reshape(b, s, -1), x,
                                  do)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 300, 64, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(torch.zeros(1, 2, 300, 128, device=cuda)[..., ::2], q, q)
    big = torch.zeros(1, 1, 300, 256, device=cuda)
    with pytest.raises(ValueError, match="range"):
        fa.flash_fwd(big, big, big)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w", [(8 * 2048, 1024), (77, 512), (5, 100),
                                    (3, 4100)])
def test_rms_norm_kernels_match_plain(cuda, dtype, rows, w):
    rng = np.random.default_rng(11)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda, dtype) for a in
             (rng.standard_normal((rows, w)) * 3 + 1,
              rng.standard_normal((rows, w))))
    scale = torch.from_numpy(rng.standard_normal(w).astype(np.float32)).to(
        cuda)
    before = (ln.rms_norm_fwd.launches, ln.rms_norm_bwd.launches)
    y = ln.rms_norm_fwd(x, scale)
    dx, dscale = ln.rms_norm_bwd(x, scale, dy)
    assert (ln.rms_norm_fwd.launches, ln.rms_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert y.dtype == dx.dtype == dtype and dscale.dtype == torch.float32
    want_dx, want_dscale = ln.rms_norm_bwd_plain(x, scale, dy)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(y, ln.rms_norm_plain(x, scale), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(dx, want_dx, rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(dscale, want_dscale, rtol=1e-5, atol=1e-4)


# The LayerNorm and RMSNorm forwards (csrc/layernorm.cu ln_fwd: persistent
# grid, a row a warp or, at W = 512 in bf16, a half-warp; chunk counts
# exact at the paths' widths) at one row, a row count no block multiple
# and the ViT-B/32 vision tower's 19200, at every path width, against the
# plain version under the bounds of test_layer_norm_kernel_matches_plain.
@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [512, 768, 1024, 1280, 2048])
@pytest.mark.parametrize("rows", [1, 3, 4099, 19200])
def test_norm_forward_at_path_widths(cuda, rows, w, dtype, rms):
    rng = np.random.default_rng(rows + w)
    x, scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in
                      (rng.standard_normal((rows, w)) * 3 + 1,
                       rng.standard_normal(w), rng.standard_normal(w)))
    xd = x.to(dtype)
    if rms:
        got, want = ln.rms_norm_fwd(xd, scale), ln.rms_norm_plain(xd, scale)
        want32 = ln.rms_norm_plain(xd.float(), scale)
    else:
        got = layer_norm_fwd(xd, scale, bias)
        want = layer_norm_plain(xd, scale, bias)
        want32 = layer_norm_plain(xd.float(), scale, bias)
    assert got.dtype == dtype and got.shape == (rows, w)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want32, rtol=2e-2, atol=2e-2)


NORM_WIDTHS = [512, 768, 1024, 1280, 2048]


def _norm_fns(kind):
    if kind == "layernorm":
        return ln.layer_norm_bwd, ln.layer_norm_bwd_plain
    return ln.rms_norm_bwd, ln.rms_norm_bwd_plain


# The norm backwards (csrc/layernorm.cu ln_bwd: persistent, a row a warp, a
# half-warp at W = 512 or two warps at W = 2048 in bf16, the column sums in
# registers; ln_bwd_sum adds the blocks' partial rows) at every path width,
# in fp32 and bf16, with a scale of either dtype, at one row, 5 rows, fewer
# rows than a full grid has warps, and 4099 rows. dx under the bounds of
# test_layer_norm_backward_matches_plain, the fp32 column sums within 1e-5
# relative plus 1e-4 of the plain version's; a bf16 scale is read as it is,
# so dx equals the call on its values in fp32 bit for bit and dscale (and
# dbias) come back in bf16, the fp32 call's sums rounded once; a second
# call gives the same bits (no atomics).
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", NORM_WIDTHS)
@pytest.mark.parametrize("rows", [1, 5, 100, 4099])
def test_norm_backward_at_path_widths(cuda, rows, w, dtype, pdtype, kind):
    bwd, plain = _norm_fns(kind)
    rng = np.random.default_rng(rows * 7 + w)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda, dtype) for a in
             (rng.standard_normal((rows, w)) * 3 + 1,
              rng.standard_normal((rows, w))))
    scale = torch.from_numpy(rng.standard_normal(w).astype(np.float32)).to(
        cuda, pdtype)
    got = bwd(x, scale, dy)
    again = bwd(x, scale, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].dtype == dtype and got[0].shape == (rows, w)
    assert all(g.dtype == pdtype and g.shape == (w,) for g in got[1:])
    fp32 = bwd(x, scale.float(), dy)
    if pdtype == torch.bfloat16:
        assert torch.equal(got[0], fp32[0])
        assert all(torch.equal(g, f.to(pdtype))
                   for g, f in zip(got[1:], fp32[1:]))
    want = plain(x, scale.float(), dy)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(fp32[0], want[0], rtol=tol[0], atol=tol[1])
    for g, wg in zip(fp32[1:], want[1:]):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-4)


# The forwards read a bf16 scale and bias as they are: the output equals the
# call on their values in fp32 bit for bit (bf16 -> fp32 is exact).
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", NORM_WIDTHS)
def test_norm_forward_reads_bf16_parameters(cuda, w, dtype, kind):
    rng = np.random.default_rng(w + 3)
    x, scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in
                      (rng.standard_normal((300, w)) * 3 + 1,
                       rng.standard_normal(w), rng.standard_normal(w)))
    x, scale, bias = x.to(dtype), scale.bfloat16(), bias.bfloat16()
    if kind == "layernorm":
        got = layer_norm_fwd(x, scale, bias)
        want = layer_norm_fwd(x, scale.float(), bias.float())
    else:
        got, want = ln.rms_norm_fwd(x, scale), ln.rms_norm_fwd(x, scale.float())
    assert got.dtype == dtype and torch.equal(got, want)


# One call with bf16 parameters: the forward one kernel, the backward its
# rows' kernel and the sum over the blocks, and no cast kernel (counted by
# torch.profiler); under autograd, dscale and dbias come back in bf16.
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_calls_launch_no_cast_kernel(cuda, kind):
    from torch.profiler import ProfilerActivity, profile
    x, dy = (torch.randn(4099, 768, device=cuda).bfloat16() for _ in range(2))
    scale, bias = (torch.randn(768, device=cuda).bfloat16() for _ in range(2))
    if kind == "layernorm":
        def fwd():
            return layer_norm_fwd(x, scale, bias)

        def bwd():
            return layer_norm_bwd(x, scale, dy)
    else:
        def fwd():
            return ln.rms_norm_fwd(x, scale)

        def bwd():
            return ln.rms_norm_bwd(x, scale, dy)
    for fn, stem, most in ((fwd, "ln_fwd", 1), (bwd, "ln_bwd", 2)):
        fn()  # the build
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert 1 <= len(names) <= most and all(stem in n for n in names), \
            names
    params = [t.detach().requires_grad_(True)
              for t in ((scale, bias) if kind == "layernorm" else (scale,))]
    y = (layer_norm(x, *params) if kind == "layernorm"
         else ln.rms_norm(x, *params))
    grads = torch.autograd.grad(y, params, dy)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_rms_norm_autograd_runs_both_kernels(cuda):
    x = torch.randn(50, 768, device=cuda, requires_grad=True)
    scale = torch.randn(768, device=cuda, requires_grad=True)
    dy = torch.randn(50, 768, device=cuda)
    before = (ln.rms_norm_fwd.launches, ln.rms_norm_bwd.launches)
    got = torch.autograd.grad(ln.rms_norm(x, scale), (x, scale), dy)
    assert (ln.rms_norm_fwd.launches, ln.rms_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(ln.rms_norm_plain(x, scale), (x, scale), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _ce_inputs(cuda, dtype, t, w, v, tied, seed=12):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(t, w, generator=gen).to(cuda, dtype)
    emb = (torch.randn(v, w, generator=gen) * 0.05).to(cuda, dtype)
    labels = torch.randint(0, v, (t,), generator=gen).to(cuda)
    dloss = (torch.rand(t, generator=gen) / t).to(cuda)
    return x, emb.t() if tied else emb.t().contiguous(), labels, dloss


# (T, W, V, tied): 4813 tokens span three groups of the tensor-core
# kernels' tile order (16, 16 and 6 token tiles of 128, the last of 77)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,w,v,tied", [(1024, 1024, 50304, True),
                                        (1000, 1024, 1000, False),
                                        (4813, 1024, 1000, True),
                                        (300, 128, 1000, True),
                                        (77, 1000, 333, True)])
def test_fused_ce_kernels_match_plain(cuda, dtype, t, w, v, tied):
    x, head, labels, dloss = _ce_inputs(cuda, dtype, t, w, v, tied)
    before = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    loss, lse = ce.fused_ce_fwd(x, head, labels)
    want_loss, want_lse = ce.fused_ce_fwd_plain(x, head, labels)
    torch.testing.assert_close(loss, want_loss, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=1e-5)
    dx, dw = ce.fused_ce_bwd(x, head, labels, want_lse, dloss)
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert dx.dtype == dw.dtype == dtype and dw.shape == head.shape
    want_dx, want_dw = ce.fused_ce_bwd_plain(x, head, labels, want_lse, dloss)
    for g, want in ((dx, want_dx), (dw.t(), want_dw.t())):
        if dtype == torch.float32:
            torch.testing.assert_close(
                g, want, rtol=1e-5, atol=5e-5 * float(want.abs().max()))
        else:
            _close_rows(g, want)


# The wgmma backward at its tiles' edges (128 x 256 output tiles, chunks
# of CHUNK_TOKENS tokens): T and V no multiples of them, T below one chunk
# and above it (a ragged last chunk), tied and untied heads
@pytest.mark.parametrize("t,w,v,tied", [(300, 256, 1000, True),
                                        (129, 128, 257, False),
                                        (4173, 512, 3000, False),
                                        (8192, 256, 50304, True),
                                        (4096 + 130, 384, 50304, True)])
def test_fused_ce_wgmma_backward_at_tile_edges(cuda, t, w, v, tied):
    x, head, labels, dloss = _ce_inputs(cuda, torch.bfloat16, t, w, v, tied)
    _, lse = ce.fused_ce_fwd_plain(x, head, labels)
    dx, dw = ce.fused_ce_bwd(x, head, labels, lse, dloss)
    assert dx.dtype == dw.dtype == torch.bfloat16 and dw.shape == head.shape
    want_dx, want_dw = ce.fused_ce_bwd_plain(x, head, labels, lse, dloss,
                                             chunk=ce.bwd_plan(t, v)[0])
    _close_rows(dx, want_dx)
    _close_rows(dw.t(), want_dw.t())


# The wgmma forward at its tiles' edges (128 x 256 logits tiles in groups
# of 32 token tiles, 64-column partials): T and V no multiples of them,
# tied and untied heads
@pytest.mark.parametrize("t,w,v,tied", [(300, 256, 1000, True),
                                        (129, 128, 257, False),
                                        (4173, 512, 3000, False),
                                        (8192, 256, 50304, True),
                                        (4096 + 130, 384, 50304, True),
                                        (77, 1000, 333, False)])
def test_fused_ce_wgmma_forward_at_tile_edges(cuda, t, w, v, tied):
    x, head, labels, _ = _ce_inputs(cuda, torch.bfloat16, t, w, v, tied)
    loss, lse = ce.fused_ce_fwd(x, head, labels)
    want_loss, want_lse = ce.fused_ce_fwd_plain(x, head, labels)
    torch.testing.assert_close(loss, want_loss, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=1e-5)


def test_wgmma_tile_products_match_fp32(cuda):
    """Each Hopper library's wgmma tile check, every operand layout and
    (N, K) its kernels use, through TMA and through swizzled stores."""
    from megatron_clip_tpu_torch.ops.kernels import sm90
    gen = torch.Generator().manual_seed(13)
    a = torch.randn(64, 128, generator=gen).to(cuda, torch.bfloat16)
    b = torch.randn(128, 256, generator=gen).to(cuda, torch.bfloat16)
    for lib in sm90.LIBRARIES:
        for ta, tb, regs, n, k in sm90.LAYOUTS:
            want = sm90.tile_product_plain(a[:, :k], b[:k, :n])
            for tma in (0, 1):
                got = sm90.tile_product(lib, a[:, :k], b[:k, :n], ta=ta,
                                        tb=tb, a_regs=regs, via_tma=tma)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_fused_ce_autograd_runs_both_kernels_into_the_tied_embedding(cuda):
    x, head, labels, _ = _ce_inputs(cuda, torch.bfloat16, 500, 256, 3000,
                                    True)
    emb = head.t().float().requires_grad_(True)  # [V, W] fp32 master
    xr = x.detach().requires_grad_(True)
    before = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    loss = ce.fused_linear_cross_entropy(xr, emb.t().to(torch.bfloat16),
                                         labels).mean()
    loss.backward()
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert emb.grad.shape == (3000, 256) and emb.grad.dtype == torch.float32
    want_dx, want_dw = ce.fused_ce_bwd_plain(
        x, head, labels, ce.fused_ce_fwd_plain(x, head, labels)[1],
        torch.full((500,), 1 / 500, device=cuda))
    _close_rows(xr.grad, want_dx)
    _close_rows(emb.grad, want_dw.t())


def test_fused_ce_kernels_refuse_what_they_do_not_take(cuda):
    x, head, labels, _ = _ce_inputs(cuda, torch.bfloat16, 64, 128, 256, True)
    with pytest.raises(TypeError, match="dtype"):
        ce.fused_ce_fwd(x, head.float(), labels)
    with pytest.raises(ValueError, match="contiguous"):
        ce.fused_ce_fwd(x.t().contiguous().t(), head, labels)
    with pytest.raises(ValueError, match="expected"):
        ce.fused_ce_fwd(x, head[:64], labels)


# Attention dropout. Each library's exported mask (`dropout_mask`, the bits
# its kernels draw) equals ops/dropout.philox_keep bit for bit; each
# dropout kernel matches its plain version fed the same Philox multipliers
# under its rate-0 twin's bounds (a kept probability is scaled by a
# multiplier both sides hold exactly, a dropped one is 0); and kernels built
# to draw a wrong mask (MCT_DROPOUT_FAULT: per 64 x 64 tile, or a column
# off) export other bits and fail the forward's bound.
DROP = AttentionDropout(0.1, 0x0123456789ABCDEF, 5)


@pytest.mark.parametrize("lib", [fa, mha_mod], ids=["flash", "fused_mha"])
@pytest.mark.parametrize("bh,rows,cols", [(32, 512, 512), (3, 333, 333),
                                          (2, 2048, 2048)])
def test_exported_mask_equals_the_plain_philox(cuda, lib, bh, rows, cols):
    got = lib.dropout_mask(bh, rows, cols, DROP.rate, DROP.seed, DROP.offset,
                           cuda)
    want = philox_keep(DROP.seed, DROP.offset, range(bh), range(rows),
                       range(cols), DROP.rate, cuda)
    assert torch.equal(got, want)


# A launch of a piece of the step (tensor rank 1 of 2, holding 8 of 16
# heads, of a data rank whose rows start at row 3): head bh draws the bits
# of the step's head 3 x 16 + 8 + (bh / 8) 16 + bh % 8.
PLACED = DROP._replace(bh_base=3 * 16 + 8, bh_heads=8, bh_stride=16)


@pytest.mark.parametrize("lib", [fa, mha_mod], ids=["flash", "fused_mha"])
def test_a_placed_launch_draws_the_step_heads_bits(cuda, lib):
    bh, s = 16, 512
    got = lib.dropout_mask(bh, s, s, PLACED.rate, PLACED.seed, PLACED.offset,
                           cuda, placement=PLACED[3:])
    heads = PLACED.head(torch.arange(bh))
    assert heads.tolist() == [56 + i // 8 * 16 + i % 8 for i in range(bh)]
    want = philox_keep(PLACED.seed, PLACED.offset, heads, range(s), range(s),
                       PLACED.rate, cuda)
    assert torch.equal(got, want)


def test_placed_dropout_kernels_match_plain(cuda):
    """The forwards and the backwards (flash's fused and split, the fused
    MHA's recompute) of a placed launch against their plain versions fed
    the placed multipliers."""
    b, h, s, d = 2, 8, 512, 128
    scale = d ** -0.5
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, b, h, s, s, d)
    keep = PLACED.multipliers(b, h, s, s, fa.dropout_mult(PLACED.rate), cuda)
    out, lse = fa.flash_fwd_dropout(q, k, v, PLACED, causal=True)
    want, want_lse = fa.flash_fwd_plain(q, k, v, scale, True, keep)
    torch.testing.assert_close(out.float(), want.float(), rtol=8e-3,
                               atol=2 ** -8 * float(want.abs().max()))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    delta = fa.flash_delta(do, want)
    wants = fa.flash_bwd_fused_plain(q, k, v, want, want_lse, do, scale, True,
                                     keep)
    gots = (fa.flash_bwd_fused_dropout(q, k, v, want, want_lse, do, PLACED,
                                       causal=True),
            (fa.flash_bwd_dq_dropout(q, k, v, do, want_lse, delta, PLACED,
                                     causal=True),
             *fa.flash_bwd_dkv_dropout(q, k, v, do, want_lse, delta, PLACED,
                                       causal=True)))
    for got in gots:
        for g, w in zip(got, wants):
            _close_rows(g, w)
    qkv = torch.cat([t.transpose(1, 2).reshape(b, s, h * d)
                     for t in (q, k, v)], -1).contiguous()
    dout = do.transpose(1, 2).reshape(b, s, h * d).contiguous()
    keep = PLACED.multipliers(b, h, s, s, mha_mod.dropout_mult(
        PLACED.rate, torch.bfloat16), cuda)
    out, stats = mha_mod.fused_mha_dropout_fwd(qkv, h, PLACED, causal=True)
    want = fused_mha_plain(qkv, h, scale, True, keep=keep)
    torch.testing.assert_close(out, want, rtol=8e-3, atol=4e-3)
    dqkv = mha_mod.fused_mha_dropout_bwd(qkv, dout, stats, h, PLACED,
                                         causal=True)
    want_g = fused_mha_bwd_recompute_plain(qkv, dout, h, scale, True, keep)
    _close_grads(dqkv, want_g, torch.bfloat16)
    _close_mha_rows(dqkv, want_g, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", [(2, 512, 16, 128, True),
                                            (2, 512, 12, 64, False),
                                            (2, 333, 16, 128, True)])
def test_fused_mha_dropout_kernels_match_plain(cuda, dtype, b, s, h, d,
                                               causal):
    gen = torch.Generator().manual_seed(4)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    do = torch.randn(b, s, h * d, generator=gen).to(cuda, dtype)
    keep = DROP.multipliers(b, h, s, s, mha_mod.dropout_mult(DROP.rate, dtype),
                            cuda)
    before = (mha_mod.fused_mha_dropout_fwd.launches,
              mha_mod.fused_mha_dropout_bwd.launches)
    out, stats = mha_mod.fused_mha_dropout_fwd(qkv, h, DROP, causal=causal)
    dqkv = mha_mod.fused_mha_dropout_bwd(qkv, do, stats, h, DROP,
                                         causal=causal)
    assert (mha_mod.fused_mha_dropout_fwd.launches,
            mha_mod.fused_mha_dropout_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want, want_stats = fused_mha_plain(qkv, h, d ** -0.5, causal,
                                       with_stats=True, keep=keep)
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(out, want, rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-5)
    want_g = fused_mha_bwd_recompute_plain(qkv, do, h, d ** -0.5, causal,
                                           keep)
    _close_grads(dqkv, want_g, dtype)
    if dtype == torch.bfloat16:
        _close_mha_rows(dqkv, want_g, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal", [(2, 16, 2048, 128, True),
                                            (2, 4, 1100, 128, False)])
def test_flash_dropout_kernels_match_plain(cuda, dtype, b, h, s, d, causal):
    q, k, v, do = _flash_inputs(cuda, dtype, b, h, s, s, d)
    keep = DROP.multipliers(b, h, s, s, fa.dropout_mult(DROP.rate), cuda)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_dropout(q, k, v, DROP, causal=causal)
    want, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal, keep)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), want.float(), rtol=8e-3,
                                   atol=2 ** -8 * float(want.abs().max()))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    delta = fa.flash_delta(do, want)
    wants = fa.flash_bwd_fused_plain(q, k, v, want, want_lse, do, scale,
                                     causal, keep)
    gots = (fa.flash_bwd_fused_dropout(q, k, v, want, want_lse, do, DROP,
                                       causal=causal),
            (fa.flash_bwd_dq_dropout(q, k, v, do, want_lse, delta, DROP,
                                     causal=causal),
             *fa.flash_bwd_dkv_dropout(q, k, v, do, want_lse, delta, DROP,
                                       causal=causal)))
    for got in gots:
        for g, w in zip(got, wants):
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)
            else:
                _close_rows(g, w)


@pytest.mark.parametrize("fault", ["MCT_DROPOUT_FAULT=1",
                                   "MCT_DROPOUT_FAULT=2"])
def test_a_wrong_draw_fails_the_checks(cuda, fault):
    from megatron_clip_tpu_torch.ops.kernels import _build
    b, h, s, d = 1, 4, 512, 128
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, b, h, s, s, d)
    want, _ = fa.flash_fwd_plain(q, k, v, d ** -0.5, True, DROP.multipliers(
        b, h, s, s, fa.dropout_mult(DROP.rate), cuda))
    truth = philox_keep(DROP.seed, DROP.offset, range(h), range(s), range(s),
                        DROP.rate, cuda)
    with _build.variant(fault):
        for lib in (fa, mha_mod):
            assert not torch.equal(lib.dropout_mask(
                h, s, s, DROP.rate, DROP.seed, DROP.offset, cuda), truth)
        out, _ = fa.flash_fwd_dropout(q, k, v, DROP, causal=True)
    err = (out.float() - want.float()).abs()
    bound = 2 ** -8 * float(want.abs().max()) + 8e-3 * want.float().abs()
    assert bool((err > bound).any())


def test_dropout_autograd_runs_the_dropout_kernels(cuda):
    from megatron_clip_tpu_torch.ops.attention import multi_head_attention
    counts = (fa.flash_fwd_dropout, fa.flash_bwd_fused_dropout,
              mha_mod.fused_mha_dropout_fwd, mha_mod.fused_mha_dropout_bwd,
              fa.flash_fwd, mha_mod.fused_mha_fwd)
    gen = torch.Generator().manual_seed(6)
    w = 256
    params = {"wqkv": (torch.randn(w, 3 * w, generator=gen) * 0.05).to(cuda),
              "wo": (torch.randn(w, w, generator=gen) * 0.05).to(cuda)}
    for s, ran in ((512, (0, 0, 1, 1, 0, 0)), (2048, (1, 1, 0, 0, 0, 0))):
        x = torch.randn(2, s, w, generator=gen).to(cuda, torch.bfloat16)
        x.requires_grad_(True)
        before = [fn.launches for fn in counts]
        y = multi_head_attention(x, params, 2, causal=True, dropout_rate=0.1,
                                 seed=3, offset=1)
        y.float().sum().backward()
        assert tuple(fn.launches - n for fn, n in zip(counts, before)) == ran
