"""Port's LayerNorm and RMSNorm vs the JAX package's fused LayerNorm and
RMSNorm kernels.

On the CPU the port runs the plain version of its kernel; the JAX side runs
the Pallas kernel, which interprets itself off the TPU. The CUDA kernel
needs the card: tests/test_torch_kernels_cuda.py and chip_smoke.py hold it
against the plain version there. Tolerance 1e-5, as
tests/test_pallas_layernorm.py holds the TPU kernel.

The backward: the port's autograd Function against `jax.vjp` of
`fused_layer_norm` (its rule `_fln_bwd`). dx 1e-5; dscale and dbias are
fp32 sums over every row taken in another order, 1e-5 relative plus 1e-4
absolute (their values reach a few hundred at 1000 rows).

RMSNorm: the port's `rms_norm` against `fused_rms_norm` (the Pallas kernel
with rms=True) and the jnp `rms_norm` the JAX package's models call, forward
1e-5; its backward against `jax.vjp` of `fused_rms_norm` (rule `_frms_bwd`),
dx 1e-5 and dscale as dscale above.

bf16 scale and bias, as the pure_bf16 paths pass them: the gradients come
back in the parameters' dtype, as `_fln_bwd` / `_frms_bwd` return them
(`astype(scale.dtype)`), which is the contract the CUDA kernel writes
directly. Each side rounds its fp32 sums once to bf16; the sums agree within
the fp32 bounds above, so where they straddle a rounding boundary the two
differ by one bf16 ulp: at most 2^-7 relative (just above a power of two),
plus the 1e-4 above. The forward and
dx as above in fp32; a bf16 x's forward and dx within one bf16 ulp (4e-3 +
8e-3 relative), each side rounding fp32 values once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.normalization import rms_norm as jax_rms_norm
from megatron_clip_tpu.ops.pallas.layernorm import (fused_layer_norm,
                                                    fused_rms_norm)
from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
from megatron_clip_tpu_torch.ops.kernels.layernorm import layer_norm_plain
from megatron_clip_tpu_torch.ops.normalization import layer_norm, rms_norm


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(4, 77, 512), (1000, 768)])
def test_layer_norm_matches_jax_fused_kernel(shape):
    x, scale, bias = _inputs(shape)
    want = fused_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 77, 512), (1000, 768)])
def test_layer_norm_backward_matches_jax_vjp(shape):
    x, scale, bias = _inputs(shape, seed=3)
    dy = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(fused_layer_norm, jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    got = torch.autograd.grad(layer_norm(*args), args, torch.from_numpy(dy))
    for g, w, atol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)


def test_bf16_input_keeps_dtype_with_fp32_stats():
    x, scale, bias = _inputs((6, 96), seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = layer_norm_plain(xb.float(), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)



@pytest.mark.parametrize("shape", [(4, 77, 512), (1000, 768), (3, 5, 100)])
def test_rms_norm_matches_jax_fused_kernel_and_jnp(shape):
    x, scale, _ = _inputs(shape, seed=5)
    before = ln.rms_norm_fwd.launches
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    assert ln.rms_norm_fwd.launches == before  # the CPU takes the plain version
    for want in (fused_rms_norm(jnp.asarray(x), jnp.asarray(scale)),
                 jax_rms_norm(jnp.asarray(x), jnp.asarray(scale))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 77, 512), (1000, 768)])
def test_rms_norm_backward_matches_jax_vjp(shape):
    x, scale, _ = _inputs(shape, seed=6)
    dy = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(fused_rms_norm, jnp.asarray(x), jnp.asarray(scale))
    want = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale)]
    got = torch.autograd.grad(rms_norm(*args), args, torch.from_numpy(dy))
    for g, w, atol in zip(got, want, (1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)


def test_rms_norm_bf16_keeps_dtype_and_eps():
    """bf16 in, bf16 out with fp32 statistics; eps is 1e-6 (megatron
    RMSNorm), not LayerNorm's 1e-5: a row of zeros normalises to 0 and a
    tiny row is scaled by 1/sqrt(ms + 1e-6)."""
    x, scale, _ = _inputs((6, 96), seed=8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = rms_norm(xb, torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        ln.rms_norm_plain(xb.float(), torch.from_numpy(scale)).numpy(),
        rtol=1e-2, atol=1e-2)
    tiny = torch.full((1, 4), 1e-3)
    np.testing.assert_allclose(rms_norm(tiny, torch.ones(4)).numpy(),
                               1e-3 / np.sqrt(1e-6 + 1e-6), rtol=1e-5)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rmsnorm"])
@pytest.mark.parametrize("shape", [(2, 77, 512), (6, 96)])
def test_bf16_parameters_match_jax_vjp(shape, rms, x_dtype):
    x, scale, bias = _inputs(shape, seed=9)
    dy = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(x_dtype), getattr(torch, x_dtype)
    params = (scale,) if rms else (scale, bias)
    jfn = fused_rms_norm if rms else fused_layer_norm
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    jparams = [jnp.asarray(p).astype(jnp.bfloat16) for p in params]
    want_y, vjp = jax.vjp(jfn, jx, *jparams)
    want = vjp(jdy)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tparams = [torch.from_numpy(p).to(torch.bfloat16).requires_grad_(True)
               for p in params]
    y = (rms_norm if rms else layer_norm)(tx, *tparams)
    got = torch.autograd.grad(y, [tx, *tparams],
                              torch.from_numpy(dy).to(tdt))
    tol = (1e-5, 1e-5) if x_dtype == "float32" else (8e-3, 4e-3)
    assert y.dtype == tdt and want_y.dtype == jdt
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               rtol=tol[0], atol=tol[1])
    assert got[0].dtype == tdt and want[0].dtype == jdt
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=tol[0], atol=tol[1])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-4)
