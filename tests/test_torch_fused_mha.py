"""Port's fused packed-QKV attention vs the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode. The CUDA kernel itself needs the card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold it against the plain
version there.
Tolerance 2e-5 (fp32), as tests/test_fused_mha.py holds the TPU kernel. In
bf16 the plain version rounds the probabilities and the output where the
Pallas kernel does, so the two agree within one bf16 ulp (atol 4e-3, rtol
8e-3). A whole attention block in bf16 is held within two ulps: the port's
`dense` adds the bias before its one rounding, the JAX package rounds the
product and then adds the bias in bf16.

The backward: the port's autograd Function (plain versions on the CPU)
against `jax.vjp` through the Pallas kernel in interpret mode with saved
probabilities (MCT_MHA_SAVE_PROBS=1, the JAX default). fp32 2e-4, as
tests/test_fused_mha.py holds the TPU kernel's gradients. bf16: both sides
round P, dS and the outputs at the same points, but a dS that lies near a
rounding boundary can round the other way when dP is summed in another
order, which moves one term of dQ or dK by 2^-8 |dS K|; held to two bf16
ulps (rtol 1.6e-2) plus 2^-7 of the largest |gradient|.

The recompute backward (`save_probs=False`) against `jax.vjp` through the
Pallas kernel under MCT_MHA_SAVE_PROBS=0, which runs
`_bwd_kernel_recompute`: fp32 2e-4, bf16 the saved-P test's bounds and, as
those bounds cannot see whether delta and dS used the fp32 or the bf16 P
(half an ulp of P moves dS by less than one of its own ulps), the whole
gradient within RECOMPUTE_BF16_REL_L2 of its norm. Where both sides round at
the same points they differ only by rare rounding flips, far inside that;
the saved-P arithmetic on a recomputed P (bf16 P in delta and dS) flips
about a third of the dS roundings, and
test_recompute_bf16_bound_tells_the_modes_apart holds it beyond twice the
bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.attention import \
    multi_head_attention as jax_multi_head_attention
from megatron_clip_tpu.ops.pallas.fused_mha import (fused_attention_from_qkv,
                                                   fused_mha_packed_sm)
from megatron_clip_tpu_torch.ops.attention import (
    attention_route, multi_head_attention, sdpa)
from chip_smoke import TOLERANCES, compare_rows, mha_parts
from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha_mod
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
    BWD_ROUTES, FWD_ROUTES, bf16_ulp, dropout_mult, fused_mha,
    fused_mha_bwd, fused_mha_bwd_plain, fused_mha_bwd_recompute,
    fused_mha_bwd_recompute_plain, fused_mha_dropout, fused_mha_fwd,
    fused_mha_plain, fused_mha_row_bound)

SHAPES = [(4, 50, 4, 64), (2, 77, 8, 64), (2, 33, 2, 32)]
# the one-pass backward's edges on the card (csrc/attn_short_bwd_sm90.cuh:
# S <= 128, D = 64, key counts of 64, 80 and 128)
ONE_PASS_EDGES = [(2, 1, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64),
                  (2, 128, 2, 64)]
# ViT-H/14's vision head: D = 80, S = 257 (five 64-row tiles, the last of
# one row on the card)
RECOMPUTE_SHAPES = SHAPES + [(2, 257, 2, 80)]
# past S = 128 the card's forward writes P with rows padded to 8 elements
# (fused_mha.probs_pitch): 136 at S = 129, 264 at ViT-L/14's and ViT-H/14's
# S = 257
PADDED_P_SHAPES = [(2, 129, 2, 64), (2, 257, 2, 80)]
RECOMPUTE_BF16_REL_L2 = 5e-4


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", SHAPES)
def test_plain_matches_jax_fused_kernel(causal, b, s, h, d):
    qkv = np.random.default_rng(0).standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)
    want = fused_attention_from_qkv(jnp.asarray(qkv), h, causal=causal,
                                    interpret=True)
    got = fused_mha_fwd(torch.from_numpy(qkv), h, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", SHAPES)
def test_plain_matches_jax_fused_kernel_bf16(causal, b, s, h, d):
    qkv = np.random.default_rng(0).standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)
    want = fused_attention_from_qkv(jnp.asarray(qkv, jnp.bfloat16), h,
                                    causal=causal, interpret=True)
    got = fused_mha_fwd(torch.from_numpy(qkv).bfloat16(), h, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=4e-3)


# The row bound the card holds bf16 forwards to (fused_mha_row_bound: one
# bf16 ulp of P on every term of a row, plus one output ulp): the Pallas
# kernel in interpret mode, which rounds P from its own fp32 softmax, lies
# within it at the paths' S = 50 and 77; so does a P with one element of
# every row moved by an ulp; a forward that leaves out each row's last
# unmasked key (the fault build of the one-pass kernel) does not.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", SHAPES[:2])
def test_row_bound_holds_rounding_flips_and_refuses_a_left_out_key(
        causal, b, s, h, d):
    qkv = np.random.default_rng(3).standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)
    x = torch.from_numpy(qkv).bfloat16()
    bound = fused_mha_row_bound(x, h, causal)
    want, p = fused_mha_plain(x, h, d ** -0.5, causal, with_probs=True)
    jax_out = fused_attention_from_qkv(jnp.asarray(qkv, jnp.bfloat16), h,
                                       causal=causal, interpret=True)
    got = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    assert bool(((got - want.float()).abs() <= bound).all())
    # one P a row moved by one ulp, the output rounded once from fp32
    _, _, v = x.float().reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    flipped = p.float().clone()
    cols = torch.randint(0, s, (b, h, s, 1), generator=torch.Generator()
                         .manual_seed(4))
    if causal:
        cols = torch.minimum(cols, torch.arange(s).view(1, 1, s, 1))
    moved = flipped.gather(-1, cols)
    flipped.scatter_(-1, cols, moved + bf16_ulp(moved))
    out = torch.matmul(flipped, v).to(torch.bfloat16).float()
    out = out.permute(0, 2, 1, 3).reshape(b, s, h * d)
    assert bool(((out - want.float()).abs() <= bound).all())
    # the last unmasked key of every row left out
    scores = torch.matmul(*(t for t in (x.float().reshape(b, s, 3, h, d)
                                        .permute(2, 0, 3, 1, 4)[0],
                                        x.float().reshape(b, s, 3, h, d)
                                        .permute(2, 0, 3, 4, 1)[1]))) \
        * d ** -0.5
    last = torch.arange(s) if causal else torch.full((s,), s - 1)
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    keep[torch.arange(s), last] = s == 1
    wrong = torch.softmax(scores.masked_fill(~keep, -1e30), -1)
    wrong = torch.matmul(wrong.to(torch.bfloat16).float(), v)
    wrong = wrong.to(torch.bfloat16).float().permute(0, 2, 1, 3).reshape(
        b, s, h * d)
    assert float(((wrong - want.float()).abs() / bound).max()) > 1


def test_forward_routes_take_the_plain_version_on_the_cpu():
    qkv = torch.randn(2, 9, 3 * 2 * 64)
    want = fused_mha_plain(qkv, 2, 0.125, True)
    for route in FWD_ROUTES:
        assert torch.equal(fused_mha_fwd(qkv, 2, causal=True, route=route),
                           want)
    with pytest.raises(ValueError, match="route"):
        fused_mha_fwd(qkv, 2, route="sdpa")


def test_backward_routes_take_the_plain_version_on_the_cpu():
    qkv, do = (torch.from_numpy(a) for a in _inputs(2, 9, 2, 64, seed=8))
    _, p = fused_mha_plain(qkv, 2, 0.125, True, with_probs=True)
    _, stats = fused_mha_plain(qkv, 2, 0.125, True, with_stats=True)
    want = fused_mha_bwd_plain(qkv, do, p, 2, 0.125)
    want_rc = fused_mha_bwd_recompute_plain(qkv, do, 2, 0.125, True)
    for route in BWD_ROUTES:
        assert torch.equal(fused_mha_bwd(qkv, do, p, 2, causal=True,
                                         route=route), want)
        assert torch.equal(fused_mha_bwd_recompute(
            qkv, do, stats, 2, causal=True, route=route), want_rc)
    with pytest.raises(ValueError, match="route"):
        fused_mha_bwd(qkv, do, p, 2, route="sdpa")
    with pytest.raises(ValueError, match="route"):
        fused_mha_bwd_recompute(qkv, do, stats, 2, route="sdpa")


def _saved_p_grads(x, g, p, h, causal, edit_ds=None, last_key_out=False):
    """The saved-P backward of `_bwd_head` written out on bf16 x, g and P,
    with dS (rounded to bf16) edited by `edit_ds`, or with each query row's
    last unmasked key left out of its delta and dS (the one-pass kernel's
    fault build): packed dqkv in bf16."""
    b, s, w = x.shape
    d = w // (3 * h)
    q, k, v = x.float().reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    gg = g.float().reshape(b, s, h, d).transpose(1, 2)
    pc = p.float()
    dp = gg @ v.transpose(-1, -2)
    pd = pc.clone()
    if last_key_out:
        last = torch.arange(s) if causal else torch.full((s,), s - 1)
        pd[..., torch.arange(s), last] = 0
    ds = (pd * (dp - (dp * pd).sum(-1, keepdim=True)) * d ** -0.5)
    ds = ds.to(torch.bfloat16).float()
    if edit_ds is not None:
        ds = edit_ds(ds)
    grads = torch.stack([ds @ k, ds.transpose(-1, -2) @ q,
                         pc.transpose(-1, -2) @ gg])
    return grads.permute(1, 3, 0, 2, 4).reshape(b, s, w).to(torch.bfloat16)


# The row bound the card holds the bf16 saved-P backward to
# (TOLERANCES["fused_mha_bwd rows"], chip_smoke.compare_rows: each row of
# dQ, dK and dV within 1e-2 of its norm plus 1e-4 of the rms row norm): it
# passes a backward whose dS has one element moved by one bf16 ulp (the
# largest of each head: the rounding flip a kernel's other summation order
# can cause), and refuses one that leaves each query row's last unmasked
# key out of its delta and dS, as the fault build of the one-pass kernel
# does.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", SHAPES[:2])
def test_saved_p_row_bound_holds_a_flip_and_refuses_a_left_out_key(
        causal, b, s, h, d):
    x, g = (torch.from_numpy(a).bfloat16() for a in _inputs(b, s, h, d,
                                                            seed=9))
    _, p = fused_mha_plain(x, h, d ** -0.5, causal, with_probs=True)
    want = fused_mha_bwd_plain(x, g, p, h, d ** -0.5)
    rel, floor = TOLERANCES["fused_mha_bwd rows"]["bf16"]
    assert torch.equal(_saved_p_grads(x, g, p, h, causal), want)

    def flip(ds):
        flat = ds.flatten(-2)
        at = flat.abs().argmax(-1, keepdim=True)
        moved = flat.gather(-1, at)
        return flat.scatter(-1, at, moved + bf16_ulp(moved)).view_as(ds)
    flipped = _saved_p_grads(x, g, p, h, causal, edit_ds=flip)
    assert not torch.equal(flipped, want)
    for part, got, w in zip("qkv", mha_parts(flipped, h), mha_parts(want, h)):
        compare_rows(f"d{part} one dS ulp", got, w, rel, floor)
    wrong = _saved_p_grads(x, g, p, h, causal, last_key_out=True)
    for part, got, w in zip("qk", mha_parts(wrong, h), mha_parts(want, h)):
        with pytest.raises(AssertionError, match="row exceeds"):
            compare_rows(f"d{part} last key out", got, w, rel, floor)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_sdpa_oracle(causal):
    b, s, h, d = 2, 40, 3, 16
    qkv = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, 3 * h * d)).astype(np.float32))
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    want = sdpa(q, k, v, causal=causal).transpose(1, 2).reshape(b, s, h * d)
    got = fused_mha_plain(qkv, h, d ** -0.5, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", SHAPES + ONE_PASS_EDGES + PADDED_P_SHAPES)
def test_backward_matches_jax_saved_probs(monkeypatch, dtype, causal, b, s,
                                          h, d):
    monkeypatch.setenv("MCT_MHA_SAVE_PROBS", "1")
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((b, s, h * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: fused_attention_from_qkv(
        x, h, causal=causal, interpret=True), jnp.asarray(qkv, dtype))
    (want,) = vjp(jnp.asarray(do, dtype))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    (got,) = torch.autograd.grad(fused_mha(x, h, causal=causal), x,
                                 torch.from_numpy(do).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                                   atol=2 ** -7 * np.abs(want).max())


def _padded(p: torch.Tensor, pitch: int) -> torch.Tensor:
    """p [B, H, S, S] copied into the [..., :S] view of a [B, H, S, pitch]
    tensor of NaN, as the card's forward lays P out at pitch > S."""
    buf = torch.full((*p.shape[:3], pitch), float("nan"), dtype=p.dtype)
    return buf[..., :p.shape[-1]].copy_(p)


# The saved-P backward's plain version reads P at any row pitch: the same
# dqkv from a P whose rows lie `pitch` elements apart (the padding NaN) as
# from the contiguous P, at lengths on both sides of the one-pass kernels'
# S = 128
@pytest.mark.parametrize("s", [50, 77, 128, 129, 257, 1024])
def test_plain_saved_p_backward_reads_any_row_pitch(s):
    h, d = 1, 16
    qkv, do = (torch.from_numpy(t) for t in _inputs(1, s, h, d, seed=s))
    _, p = fused_mha_fwd(qkv, h, with_probs=True)
    padded = _padded(p, -(-s // 8) * 8 + 8)
    assert padded.stride(2) > s
    assert torch.equal(fused_mha_bwd(qkv, do, padded, h),
                       fused_mha_bwd(qkv, do, p, h))


# The saved-P backward on P in the card's padded layout (rows 16-byte units
# apart past S = 128): the same dqkv as from the same P contiguous, and the
# forward's output and the gradient within the JAX kernels' bounds of
# tests/test_fused_mha.py (2e-5 and 2e-4, fp32) of `_fwd_kernel` and
# `_bwd_kernel` in interpret mode; the autograd Function's gradient, with
# its forward handing the padded P to its backward as the card's does, the
# same bits.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", PADDED_P_SHAPES)
def test_saved_p_backward_reads_the_padded_layout(monkeypatch, causal, b, s,
                                                  h, d):
    monkeypatch.setenv("MCT_MHA_SAVE_PROBS", "1")
    qkv, do = _inputs(b, s, h, d, seed=11)
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    out, dense = fused_mha_fwd(x, h, causal=causal, with_probs=True)
    p = _padded(dense, -(-s // 8) * 8)
    assert p.stride(2) > s and torch.equal(p, dense)
    got = fused_mha_bwd(x, g, p, h, causal=causal)
    assert torch.equal(got, fused_mha_bwd(x, g, dense, h, causal=causal))
    want_out, vjp = jax.vjp(lambda t: fused_attention_from_qkv(
        t, h, causal=causal, interpret=True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    saved = []

    def fwd_padded(*args, **kw):
        out, p = fwd(*args, **kw)
        saved.append(_padded(p, p.shape[-1] // 8 * 8 + 8))
        return out, saved[-1]
    fwd = mha_mod.fused_mha_fwd
    monkeypatch.setattr(mha_mod, "fused_mha_fwd", fwd_padded)
    xg = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(fused_mha(xg, h, causal=causal), xg, g)
    assert len(saved) == 1 and saved[0].stride(2) > s
    assert torch.equal(auto, got)


def _inputs(b, s, h, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, 3 * h * d)).astype(np.float32),
            rng.standard_normal((b, s, h * d)).astype(np.float32))


def _jax_recompute_grad(monkeypatch, qkv, do, h, causal, dtype):
    monkeypatch.setenv("MCT_MHA_SAVE_PROBS", "0")
    _, vjp = jax.vjp(lambda x: fused_attention_from_qkv(
        x, h, causal=causal, interpret=True), jnp.asarray(qkv, dtype))
    (want,) = vjp(jnp.asarray(do, dtype))
    return np.asarray(want.astype(jnp.float32))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", RECOMPUTE_SHAPES + ONE_PASS_EDGES)
def test_recompute_backward_matches_jax(monkeypatch, dtype, causal, b, s, h,
                                        d):
    qkv, do = _inputs(b, s, h, d)
    want = _jax_recompute_grad(monkeypatch, qkv, do, h, causal, dtype)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    (got,) = torch.autograd.grad(
        fused_mha(x, h, causal=causal, save_probs=False), x,
        torch.from_numpy(do).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1.6e-2,
                                   atol=2 ** -7 * np.abs(want).max())
        assert _rel_l2(got, want) <= RECOMPUTE_BF16_REL_L2


def test_recompute_bf16_bound_tells_the_modes_apart(monkeypatch):
    """The saved-P backward fed the recomputed probabilities rounded to
    bf16 (bf16 P in delta and dS) is the version the bf16 bound must
    refuse."""
    b, s, h, d = 2, 257, 2, 80
    qkv, do = _inputs(b, s, h, d)
    want = _jax_recompute_grad(monkeypatch, qkv, do, h, False, "bfloat16")
    x, g = (torch.from_numpy(a).bfloat16() for a in (qkv, do))
    _, p = fused_mha_plain(x, h, d ** -0.5, with_probs=True)
    wrong = fused_mha_bwd_plain(x, g, p, h, d ** -0.5).float().numpy()
    assert _rel_l2(wrong, want) > 2 * RECOMPUTE_BF16_REL_L2


@pytest.mark.parametrize("causal", [False, True])
def test_recompute_and_saved_probs_agree_in_fp32(causal):
    """In fp32 rounding P to the input dtype changes nothing, so the two
    backward modes do the same arithmetic: equal gradients."""
    qkv, do = _inputs(2, 40, 3, 16, seed=4)
    grads = []
    for save_probs in (True, False):
        x = torch.from_numpy(qkv).requires_grad_(True)
        grads.append(torch.autograd.grad(
            fused_mha(x, 3, causal=causal, save_probs=save_probs), x,
            torch.from_numpy(do))[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_row_stats_give_the_softmax(causal):
    """The forward's row statistics: exp(s scale - m) / l is the softmax
    that P rounds."""
    b, s, h, d = 2, 45, 3, 16
    qkv, _ = _inputs(b, s, h, d, seed=5)
    x = torch.from_numpy(qkv)
    out, stats = fused_mha_fwd(x, h, causal=causal, with_stats=True)
    assert stats.shape == (2, b, h, s) and stats.dtype == torch.float32
    torch.testing.assert_close(out, fused_mha_fwd(x, h, causal=causal))
    q, k, _ = x.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) * d ** -0.5
    p = torch.exp(scores - stats[0][..., None]) / stats[1][..., None]
    if causal:
        p = p.tril()
    _, want = fused_mha_plain(x, h, d ** -0.5, causal, with_probs=True)
    torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("causal", [False, True])
def test_smajor_view_matches_jax_fused_mha_packed_sm(causal):
    """`fused_mha` on the [B, S, 3W] view of S-major storage, recompute
    backward, against the JAX package's S-major kernel in interpret mode
    (forward 2e-5, gradient 2e-4, as tests/test_fused_mha.py holds it).
    The output and the gradient come back S-major."""
    b, s, h, d = 8, 50, 4, 64
    qkv, do = _inputs(b, s, h, d, seed=6)
    want, vjp = jax.vjp(lambda x: fused_mha_packed_sm(
        x, h, d ** -0.5, causal, True), jnp.asarray(qkv))
    (want_g,) = vjp(jnp.asarray(do))
    sbw = torch.from_numpy(qkv.transpose(1, 0, 2).copy()).requires_grad_(True)
    out = fused_mha(sbw.transpose(0, 1), h, causal=causal, save_probs=False)
    assert out.shape == (b, s, h * d) and out.stride(0) < out.stride(1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    (g,) = torch.autograd.grad(out, sbw, torch.from_numpy(do))
    np.testing.assert_allclose(g.transpose(0, 1).numpy(), np.asarray(want_g),
                               rtol=2e-4, atol=2e-4)


def _block_inputs():
    rng = np.random.default_rng(2)
    b, s, w = 2, 50, 128
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = {"wqkv": rng.standard_normal((w, 3 * w)) * w ** -0.5,
              "bqkv": rng.standard_normal(3 * w) * 0.1,
              "wo": rng.standard_normal((w, w)) * w ** -0.5,
              "bo": rng.standard_normal(w) * 0.1}
    return x, {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    """One block's attention params: packed QKV GEMM -> fused attention ->
    output GEMM, same numpy inputs on both sides."""
    x, params = _block_inputs()
    want = jax_multi_head_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, 4,
        causal=causal)
    got = multi_head_attention(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
        4, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax_bf16(causal):
    """The same block with bf16 activations and fp32 weights cast at use,
    as both packages run it under the bf16 policy."""
    x, params = _block_inputs()
    want = jax_multi_head_attention(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in params.items()}, 4, causal=causal)
    got = multi_head_attention(
        torch.from_numpy(x).bfloat16(),
        {k: torch.from_numpy(v) for k, v in params.items()}, 4,
        causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1.6e-2, atol=8e-3)


# dropout at S = 8 with 4 heads of 8: no head group for the fused dropout
# kernels (16 heads a cell) and S below flash's gate
@pytest.mark.parametrize("kw", [{"bias": torch.zeros(1)}, {"rope": object()},
                                {"kv_heads": 2},
                                {"dropout_rate": 0.1, "seed": 1},
                                {"context_parallel": True},
                                {"use_flash": False}])
def test_outside_the_gate_raises(kw, monkeypatch):
    """Outside both kernels' gates the attention takes `sdpa_bshd`, as the
    JAX package does (its numerics: tests/test_torch_sdpa.py): the route is
    "sdpa" and the output the JAX `multi_head_attention`'s (which runs
    `sdpa_bshd` on the CPU) within 1e-5. Context parallelism still raises,
    naming its ROADMAP item."""
    x = torch.zeros(1, 8, 32)
    params = {"wqkv": torch.zeros(32, 96), "wo": torch.zeros(32, 32)}
    if kw.get("context_parallel"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            multi_head_attention(x, params, 4, **kw)
        return
    rng = np.random.default_rng(len(kw))
    hkv = kw.get("kv_heads", 4)
    x = rng.standard_normal((1, 8, 32)).astype(np.float32)
    params = {"wqkv": rng.standard_normal((32, (4 + 2 * hkv) * 8)) / 6,
              "wo": rng.standard_normal((32, 32)) / 6}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    kw = dict(kw)
    jkw = {k: v for k, v in kw.items() if k not in ("seed", "bias", "rope")}
    if "bias" in kw:
        kw["bias"] = torch.zeros(1)
        jkw["bias"] = jnp.zeros(1)
    if "rope" in kw:
        from megatron_clip_tpu.ops.rope import rope_cos_sin as jax_tables
        from megatron_clip_tpu_torch.ops.rope import rope_cos_sin
        kw["rope"], jkw["rope"] = rope_cos_sin(8, 8), jax_tables(8, 8)
    if "seed" in kw:
        from megatron_clip_tpu_torch.ops.dropout import hidden_keep
        keep = hidden_keep((1, 4, 8, 8), kw["dropout_rate"], kw["seed"], 0,
                           "cpu")
        jkw["dropout_rng"] = jax.random.PRNGKey(0)
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(keep.numpy()))
    want = jax_multi_head_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, 4,
        **jkw)
    got = multi_head_attention(torch.from_numpy(x),
                               {k: torch.from_numpy(v)
                                for k, v in params.items()}, 4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ... each refusal naming its ROADMAP Queue A item by number: item 1 the
# unfused sdpa path and an additive bias, item 5 context parallelism, item 7
# CoCa's cross-attention
@pytest.mark.parametrize("kw,item", [
    ({"bias": torch.zeros(1)}, 1), ({"rope": object()}, 1),
    ({"kv_heads": 2}, 1), ({"dropout_rate": 0.1, "seed": 1}, 1),
    ({"use_flash": False}, 1), ({"context_parallel": True}, 5),
    ({"kv": torch.zeros(1, 8, 32)}, 7)])
def test_refusals_name_their_queue_a_item(kw, item):
    """Item 1's cases (the unfused `sdpa_bshd` route) are ported: they
    route to "sdpa" and no longer raise; items 5 and 7 still raise naming
    their item."""
    x = torch.zeros(1, 8, 32)
    params = {"wqkv": torch.zeros(32, 96), "wo": torch.zeros(32, 32)}
    if item == 1:
        hkv = kw.get("kv_heads", 4)
        assert attention_route(
            8, 4, hkv, 96 // (4 + 2 * hkv), rope=kw.get("rope"),
            use_flash=kw.get("use_flash", True),
            dropout_rate=kw.get("dropout_rate", 0.0), seed=kw.get("seed"),
            bias="bias" in kw) == "sdpa"
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue A item {item}\b"):
        multi_head_attention(x, params, 4, **kw)



# The dropout route (fused_mha_packed_dropout, _fwd_kernel_dropout and
# _bwd_kernel_dropout) against the port's plain versions fed the JAX
# kernel's own mask, `_dropout_mask(key, ...)` (the keep multipliers in
# qkv's dtype): the forward 2e-5 and the qkv gradient 2e-4 in fp32, the
# bounds of tests/test_fused_mha.py. The port's backward forms delta from
# P and dP M as the JAX kernel does, so both sides are the same sums.
DROPOUT_SHAPES = [(2, 50, 4, 64), (2, 26, 4, 32)]


def _jax_dropout(qkv, do, h, causal, rate, dtype, key):
    from megatron_clip_tpu.ops.pallas.fused_mha import (
        _dropout_mask, fused_mha_packed_dropout)
    x = jnp.asarray(qkv, dtype)
    d = qkv.shape[-1] // (3 * h)
    out, vjp = jax.vjp(lambda t: fused_mha_packed_dropout(
        t, key, h, d ** -0.5, causal, rate, True), x)
    (grad,) = vjp(jnp.asarray(do, dtype))
    mask = _dropout_mask(key, qkv.shape[0], qkv.shape[1], h, rate, dtype)
    f32 = (lambda a: np.asarray(a.astype(jnp.float32)))
    return f32(out), f32(grad), f32(mask)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", DROPOUT_SHAPES)
def test_dropout_route_matches_jax_fused_mha_packed_dropout(causal, b, s, h,
                                                            d):
    qkv, do = _inputs(b, s, h, d, seed=11)
    key = jax.random.PRNGKey(s + h)
    want, want_g, mask = _jax_dropout(qkv, do, h, causal, 0.1, jnp.float32,
                                      key)
    keep = torch.from_numpy(mask)
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    got = fused_mha_plain(x, h, d ** -0.5, causal, keep=keep)
    got_g = fused_mha_bwd_recompute_plain(x, g, h, d ** -0.5, causal, keep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=2e-4, atol=2e-4)


def test_dropout_route_bf16_keeps_the_rounded_multiplier():
    """In bf16 the JAX mask holds keep * 1/(1 - rate) rounded to bf16,
    1.109375 at rate 0.1, and so does the port's (`dropout_mult`); with it
    the bf16 forward agrees within one ulp, as the rate-0 route."""
    b, s, h, d = 2, 50, 4, 64
    qkv, do = _inputs(b, s, h, d, seed=12)
    want, _, mask = _jax_dropout(qkv, do, h, True, 0.1, jnp.bfloat16,
                                 jax.random.PRNGKey(0))
    assert set(np.unique(mask)) == {0.0, 1.109375}
    assert dropout_mult(0.1, torch.bfloat16) == 1.109375
    assert dropout_mult(0.1, torch.float32) == np.float32(1 / 0.9)
    got = fused_mha_plain(torch.from_numpy(qkv).bfloat16(), h, d ** -0.5,
                          True, keep=torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=4e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_autograd_uses_the_philox_mask(causal):
    """fused_mha_dropout on the CPU: the plain versions fed the kernels'
    Philox mask of (seed, offset), forward and backward alike."""
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    b, s, h, d = 2, 50, 4, 64
    qkv, do = _inputs(b, s, h, d, seed=13)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = fused_mha_dropout(x, h, causal=causal, rate=0.1, seed=77,
                            offset=4)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(do))
    keep = AttentionDropout(0.1, 77, 4).multipliers(
        b, h, s, s, dropout_mult(0.1, torch.float32))
    assert torch.equal(out, fused_mha_plain(x.detach(), h, d ** -0.5, causal,
                                            keep=keep))
    assert torch.equal(grad, fused_mha_bwd_recompute_plain(
        x.detach(), torch.from_numpy(do), h, d ** -0.5, causal, keep))
    assert not torch.equal(out, fused_mha(x.detach(), h, causal=causal))
