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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.attention import \
    multi_head_attention as jax_multi_head_attention
from megatron_clip_tpu.ops.pallas.fused_mha import fused_attention_from_qkv
from megatron_clip_tpu_torch.ops.attention import multi_head_attention, sdpa
from megatron_clip_tpu_torch.ops.kernels.fused_mha import (fused_mha_fwd,
                                                           fused_mha_plain)

SHAPES = [(4, 50, 4, 64), (2, 77, 8, 64), (2, 33, 2, 32)]


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


@pytest.mark.parametrize("kw", [{"bias": torch.zeros(1)}, {"rope": object()},
                                {"kv_heads": 2}, {"dropout_rate": 0.1},
                                {"context_parallel": True},
                                {"use_flash": False}])
def test_outside_the_gate_raises(kw):
    x = torch.zeros(1, 8, 32)
    params = {"wqkv": torch.zeros(32, 96), "wo": torch.zeros(32, 32)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        multi_head_attention(x, params, 4, **kw)

