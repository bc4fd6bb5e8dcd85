"""The port's rotary embeddings (ops/rope.py) and SwiGLU
(ops/activations.py::swiglu) against the JAX package's on the CPU.

Inputs from numpy with a seed, passed to both. Tolerances: the tables and
the rotations in fp32 within 1e-6 (cos/sin of the same fp32 angles, one
product and one sum per element; positions up to 300 make angles up to 300
rad, whose fp32 cos/sin can differ in the last place between libraries:
2e-6 there); SwiGLU 1e-6 (silu of the same values); the packed rotation's
gradient against autograd of the per-head rotation in float64, 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops import rope as jax_rope
from megatron_clip_tpu.ops.activations import swiglu as jax_swiglu
from megatron_clip_tpu_torch.ops import rope
from megatron_clip_tpu_torch.ops.activations import swiglu


@pytest.mark.parametrize("percent,interp", [(1.0, None), (0.5, None),
                                            (1.0, 4.0)])
def test_tables_match_jax(percent, interp):
    got = rope.rope_cos_sin(300, 64, 10000.0, rotary_percent=percent,
                            seq_len_interpolation_factor=interp)
    want = jax_rope.rope_cos_sin(300, 64, 10000.0, rotary_percent=percent,
                                 seq_len_interpolation_factor=interp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("percent", [1.0, 0.5])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_apply_rope_matches_jax(percent, layout):
    rng = np.random.default_rng(0)
    shape = (2, 3, 40, 32) if layout == "bhsd" else (2, 40, 3, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    cos, sin = jax_rope.rope_cos_sin(40, 32, rotary_percent=percent)
    jfn, pfn = ((jax_rope.apply_rope, rope.apply_rope) if layout == "bhsd"
                else (jax_rope.apply_rope_bshd, rope.apply_rope_bshd))
    want = jfn(jnp.asarray(x), cos, sin)
    got = pfn(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
              torch.from_numpy(np.array(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if percent < 1:  # the channels past the rotary width pass through
        np.testing.assert_array_equal(got[..., 16:].numpy(), x[..., 16:])


@pytest.mark.parametrize("heads,kv_heads,percent", [(4, 4, 1.0), (4, 2, 1.0),
                                                    (4, 1, 0.5)])
def test_packed_rotation_and_its_gradient(heads, kv_heads, percent):
    """apply_rope_qkv rotates the q and k heads of the packed projection
    as apply_rope_bshd rotates each, passes v through, and its backward is
    the rotation's transpose."""
    d, s = 16, 24
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, s, (heads + 2 * kv_heads) * d))).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(qkv.shape))
    cos, sin = (t.double() for t in rope.rope_cos_sin(
        s, d, rotary_percent=percent))

    def split_rope(t):
        n = (heads + kv_heads) * d
        qk = rope.apply_rope_bshd(t[..., :n].unflatten(-1, (-1, d)), cos, sin)
        return torch.cat([qk.flatten(-2), t[..., n:]], -1)
    got = rope.apply_rope_qkv(qkv, cos, sin, heads, kv_heads)
    want = split_rope(qkv)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    gg, = torch.autograd.grad(got, qkv, g)
    gw, = torch.autograd.grad(want, qkv, g)
    torch.testing.assert_close(gg, gw, rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_bias", [False, True])
def test_swiglu_matches_jax(with_bias):
    """The first half of the projection is the value, the second the gate:
    silu(gate) * value (checkpoints/llama_hf.py concatenates up, then gate,
    in that order)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 2 * 24)).astype(np.float32)
    b = rng.standard_normal(2 * 24).astype(np.float32) if with_bias else None
    want = jax_swiglu(jnp.asarray(x), None if b is None else jnp.asarray(b))
    got = swiglu(torch.from_numpy(x),
                 None if b is None else torch.from_numpy(b))
    assert got.shape == (3, 7, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    value, gate = x[..., :24], x[..., 24:]
    if b is None:
        np.testing.assert_allclose(
            got.numpy(), value * gate / (1 + np.exp(-gate)), rtol=1e-5,
            atol=1e-6)
