"""Port's LayerNorm vs the JAX package's fused LayerNorm kernel.

On the CPU the port runs the plain version of its kernel; the JAX side runs
the Pallas kernel, which interprets itself off the TPU. The CUDA kernel
needs the card: tests/test_torch_kernels_cuda.py and chip_smoke.py hold it
against the plain version there. Tolerance 1e-5, as
tests/test_pallas_layernorm.py holds the TPU kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.pallas.layernorm import fused_layer_norm
from megatron_clip_tpu_torch.ops.kernels.layernorm import layer_norm_plain
from megatron_clip_tpu_torch.ops.normalization import layer_norm


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


def test_bf16_input_keeps_dtype_with_fp32_stats():
    x, scale, bias = _inputs((6, 96), seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = layer_norm_plain(xb.float(), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)

