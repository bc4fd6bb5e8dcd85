"""LayerNorm and RMSNorm over the last axis.

Counterpart of `megatron_clip_tpu/ops/normalization.py::layer_norm` and
`rms_norm`. The device of `x` decides: a CUDA tensor runs the hand-written
kernels (`ops/kernels/layernorm.py`, forward and backward), a CPU tensor
their plain versions. The JAX package reaches its Pallas LayerNorm only
under MCT_PALLAS_LN=1 and never dispatches its `fused_rms_norm`: its
`rms_norm` is the jnp function, which computes the same thing. The port
uses its kernels for every LayerNorm and RMSNorm on the card.
"""
import torch

from megatron_clip_tpu_torch.ops.kernels import layernorm


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean)/sqrt(var+eps) * scale + bias; fp32 statistics, result
    in x's dtype. Any leading shape; differentiable."""
    w = x.shape[-1]
    y = layernorm.layer_norm(x.reshape(-1, w).contiguous(), scale, bias, eps)
    return y.reshape(x.shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale (megatron RMSNorm); fp32
    statistics, result in x's dtype. Any leading shape; differentiable."""
    w = x.shape[-1]
    y = layernorm.rms_norm(x.reshape(-1, w).contiguous(), scale, eps)
    return y.reshape(x.shape)
