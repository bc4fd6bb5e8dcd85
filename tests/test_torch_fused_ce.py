"""The port's fused lm-head cross entropy (ops/kernels/fused_ce.py) against
the JAX package's `fused_linear_cross_entropy` on the CPU.

On the CPU the port runs the plain versions of its kernels; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_fused_ce.py does. The
CUDA kernels need the card: tests/test_torch_kernels_cuda.py and
chip_smoke.py hold them against the plain versions there.

Tolerances, with their reasons:
- fp32 loss 1e-4 absolute plus 1e-5 relative and gradients 2e-5 absolute,
  the JAX suite's own (tests/test_fused_ce.py): logits and softmax sums in
  another order.
- bf16: dlogits are rounded to bf16 before both contractions on both sides.
  The port's dlogits of one chunk against the JAX kernels' own
  `_softmax_resid` cast to bf16: fp32 logits summed in another order can put
  an entry on the other side of a rounding boundary, so at most one bf16 ulp
  (at most 2^-7 relative) apart, and equal on all but a few entries. The gradients
  through the whole function within two bf16 ulps (rtol 1.6e-2) plus 2^-7
  of the largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.pallas import fused_ce as jax_ce
from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce


def _inputs(t, w, v, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, w)).astype(np.float32)
    wm = (0.1 * rng.standard_normal((w, v))).astype(np.float32)
    lbl = rng.integers(0, v, t).astype(np.int32)
    m = (rng.random(t) > 0.2).astype(np.float32)
    return x, wm, lbl, m


def _jax_loss_and_grads(x, wm, lbl, m):
    def loss(x, wm):
        per = jax_ce.fused_linear_cross_entropy(x, wm, jnp.asarray(lbl))
        return jnp.sum(per * m) / m.sum(), per
    (_, per), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wm))
    return np.asarray(per), [np.asarray(g) for g in grads]


def _port_loss_and_grads(x, wm, lbl, m, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(wm).to(dtype).requires_grad_(True)
    per = ce.fused_linear_cross_entropy(xt, wt, torch.from_numpy(lbl))
    mt = torch.from_numpy(m)
    ((per * mt).sum() / mt.sum()).backward()
    return per.detach(), xt.grad, wt.grad


@pytest.mark.parametrize("t,w,v", [(256, 128, 1024), (300, 128, 1000)])
def test_plain_versions_match_jax_fused_ce(t, w, v):
    x, wm, lbl, m = _inputs(t, w, v)
    want_per, (want_gx, want_gw) = _jax_loss_and_grads(x, wm, lbl, m)
    before = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    per, gx, gw = _port_loss_and_grads(x, wm, lbl, m)
    # the CPU takes the plain versions
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == before
    np.testing.assert_allclose(per.numpy(), want_per, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), want_gx, atol=2e-5, rtol=0)
    np.testing.assert_allclose(gw.numpy(), want_gw, atol=2e-5, rtol=0)


def test_forward_returns_the_jax_lse():
    x, wm, lbl, _ = _inputs(300, 128, 1000, seed=1)
    want_loss, want_lse = jax_ce._fwd(jnp.asarray(x), jnp.asarray(wm),
                                      jnp.asarray(lbl), 256, 512)
    loss, lse = ce.fused_ce_fwd(torch.from_numpy(x), torch.from_numpy(wm),
                                torch.from_numpy(lbl))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:300],
                               atol=1e-4, rtol=1e-5)


def test_bf16_dlogits_are_rounded_as_the_jax_kernels_round_them():
    t, w, v = 300, 128, 1000
    x, wm, lbl, m = _inputs(t, w, v, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(wm).to(torch.bfloat16)
    lbl_t = torch.from_numpy(lbl)
    _, lse = ce.fused_ce_fwd(xb, wb, lbl_t)
    dloss = torch.from_numpy(m / m.sum())
    got = ce.fused_ce_dlogits_plain(xb, wb.float(), lbl_t, lse, dloss)
    want = jax_ce._softmax_resid(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16),
        jnp.asarray(lbl)[:, None], jnp.asarray(lse.numpy())[:, None],
        jnp.asarray(dloss.numpy())[:, None], 0, v, v).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16
    diff = (got.float() - want).abs()
    assert float((diff > 0).float().mean()) < 1e-3
    assert bool((diff <= 2 ** -7 * want.abs()).all())
    # the rounding is there: the fp32 dlogits differ from the rounded ones
    fp32 = ce.fused_ce_dlogits_plain(xb.float(), wb.float(), lbl_t, lse,
                                     dloss)
    assert float((fp32 != got.float()).float().mean()) > 0.5


def test_bf16_gradients_match_jax():
    x, wm, lbl, m = _inputs(256, 128, 1024, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(wm, jnp.bfloat16)

    def loss(x, w):
        per = jax_ce.fused_linear_cross_entropy(x, w, jnp.asarray(lbl))
        return jnp.sum(per * m) / m.sum()
    want = jax.grad(loss, argnums=(0, 1))(xb, wb)
    _, gx, gw = _port_loss_and_grads(
        np.asarray(xb.astype(jnp.float32)), np.asarray(wb.astype(jnp.float32)),
        lbl, m, dtype=torch.bfloat16)
    for g, w in zip((gx, gw), want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1.6e-2,
                                   atol=2 ** -7 * np.abs(w).max())


def test_tied_head_is_read_through_its_transposed_view():
    """The tied head is the [V, W] embedding's [W, V] view; its gradient
    lands in the embedding's layout and equals the JAX dW transposed."""
    x, wm, lbl, m = _inputs(300, 128, 1000, seed=4)
    _, (want_gx, want_gw) = _jax_loss_and_grads(x, wm, lbl, m)
    emb = torch.from_numpy(np.ascontiguousarray(wm.T)).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    head = emb.t()
    assert not head.is_contiguous() and head.t().is_contiguous()
    per = ce.fused_linear_cross_entropy(xt, head, torch.from_numpy(lbl))
    mt = torch.from_numpy(m)
    ((per * mt).sum() / mt.sum()).backward()
    assert emb.grad.shape == (1000, 128)
    np.testing.assert_allclose(emb.grad.numpy(), want_gw.T, atol=2e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, atol=2e-5, rtol=0)


def test_wrappers_refuse_a_graph_and_keep_forward_only_calls_cheap():
    x, wm, lbl, _ = _inputs(8, 16, 32, seed=6)
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ce.fused_ce_fwd(xt, torch.from_numpy(wm), torch.from_numpy(lbl))
    with torch.no_grad():
        per = ce.fused_linear_cross_entropy(xt, torch.from_numpy(wm),
                                            torch.from_numpy(lbl))
    assert per.shape == (8,) and per.grad_fn is None


@pytest.mark.parametrize("t,v,rows,pitch", [(300, 1000, 384, 1000),
                                            (16384, 50304, 4096, 50304),
                                            (4096, 333, 4096, 336),
                                            (4097, 50304, 4096, 50304),
                                            (1, 7, 128, 8)])
def test_backward_chunk_plan(t, v, rows, pitch):
    """The wgmma backward's dlogits scratch: chunks of whole 128-row tiles,
    at most CHUNK_TOKENS tokens; rows padded to 16 bytes."""
    assert ce.bwd_plan(t, v) == (rows, pitch)
    assert rows % 128 == 0 and rows <= ce.CHUNK_TOKENS and pitch % 8 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_backward_order_matches_jax(dtype):
    """The backward in the wgmma kernel's order (dlogits per chunk of 128
    tokens, dX rounded once per chunk, dW summed across three chunks in
    fp32 and rounded once) against the JAX VJP, at the file's tolerances."""
    t, w, v = 300, 128, 1000
    x, wm, lbl, m = _inputs(t, w, v, seed=7)
    rows, _ = ce.bwd_plan(t, v, chunk=128)
    assert -(-t // rows) == 3
    dloss = torch.from_numpy(m / m.sum())
    if dtype == "float32":
        _, (want_gx, want_gw) = _jax_loss_and_grads(x, wm, lbl, m)
        xt, wt = torch.from_numpy(x), torch.from_numpy(wm)
        _, lse = ce.fused_ce_fwd(xt, wt, torch.from_numpy(lbl))
        gx, gw = ce.fused_ce_bwd_plain(xt, wt, torch.from_numpy(lbl), lse,
                                       dloss, chunk=rows)
        np.testing.assert_allclose(gx.numpy(), want_gx, atol=2e-5, rtol=0)
        np.testing.assert_allclose(gw.numpy(), want_gw, atol=2e-5, rtol=0)
        return
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(wm, jnp.bfloat16)

    def loss(x, w):
        per = jax_ce.fused_linear_cross_entropy(x, w, jnp.asarray(lbl))
        return jnp.sum(per * m) / m.sum()
    want = jax.grad(loss, argnums=(0, 1))(xb, wb)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    wt = torch.from_numpy(np.asarray(wb.astype(jnp.float32))).to(
        torch.bfloat16)
    _, lse = ce.fused_ce_fwd(xt, wt, torch.from_numpy(lbl))
    got = ce.fused_ce_bwd_plain(xt, wt, torch.from_numpy(lbl), lse, dloss,
                                chunk=rows)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1.6e-2,
                                   atol=2 ** -7 * np.abs(w).max())
