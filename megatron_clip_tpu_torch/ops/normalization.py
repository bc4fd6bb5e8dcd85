"""LayerNorm over the last axis.

Counterpart of `megatron_clip_tpu/ops/normalization.py::layer_norm`. The
device of `x` decides: a CUDA tensor runs the hand-written kernel
(`ops/kernels/layernorm.py`), a CPU tensor its plain version. The JAX package
reaches its Pallas kernel only under MCT_PALLAS_LN=1; the port uses its kernel
for every LayerNorm on the card.
"""
import torch

from megatron_clip_tpu_torch.ops.kernels.layernorm import layer_norm_fwd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean)/sqrt(var+eps) * scale + bias; fp32 statistics, result
    in x's dtype. Any leading shape."""
    w = x.shape[-1]
    y = layer_norm_fwd(x.reshape(-1, w).contiguous(), scale, bias, eps)
    return y.reshape(x.shape)
