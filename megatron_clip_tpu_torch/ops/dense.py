"""Linear layers in the JAX package's [in, out] weight layout."""
from typing import Optional

import torch


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b), with w [in, out] and b cast to x's dtype at use.

    With a bias this is one addmm, so on the GPU the bias joins the fp32
    accumulator in cuBLASLt's epilogue and the result is rounded to x's
    dtype once. The JAX package rounds the product, then adds the bias in
    x's dtype: in bf16 the two differ by one rounding, and a separate
    broadcast add costs a full pass over the output."""
    w = w.to(x.dtype)
    if b is None:
        return torch.matmul(x, w)
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])
