"""LayerNorm over the last axis.

Counterpart of `megatron_clip_tpu/ops/normalization.py::layer_norm`. The
device of `x` decides: a CUDA tensor runs the hand-written kernels
(`ops/kernels/layernorm.py`, forward and backward), a CPU tensor their plain
versions. The JAX package reaches its Pallas kernel only under
MCT_PALLAS_LN=1; the port uses its kernels for every LayerNorm on the card.
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
