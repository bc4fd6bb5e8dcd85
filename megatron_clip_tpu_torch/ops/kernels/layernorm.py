"""LayerNorm forward: the CUDA kernel's wrapper and its plain version.

Counterpart of `megatron_clip_tpu/ops/pallas/layernorm.py::fused_layer_norm`
(forward). The kernel is `csrc/layernorm.cu`. `layer_norm_fwd` takes the plain
version for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""
import ctypes

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

_SIGNATURES = {
    "mct_layer_norm_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean)/sqrt(var + eps) * scale + bias over the last axis;
    statistics and the affine in fp32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [rows, W] contiguous fp32/bf16; scale, bias [W]. Returns [rows, W]
    in x's dtype."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fwd: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("layer_norm_fwd: x must be a non-empty contiguous "
                         f"[rows, W] tensor, got shape {tuple(x.shape)}")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "layer_norm_fwd has no backward kernel yet (ROADMAP: train-step "
            "slice); call it under torch.no_grad()")
    rows, w = x.shape
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (w,) or t.device != x.device:
            raise ValueError(f"layer_norm_fwd: {name} must be [{w}] on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    y = torch.empty_like(x)
    lib = _build.load("layernorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mct_layer_norm_fwd(x.data_ptr(), scale.data_ptr(),
                                    bias.data_ptr(), y.data_ptr(), rows, w,
                                    eps, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd: kernel launch failed "
                           f"(cudaError {rc}) for shape {tuple(x.shape)}")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0
