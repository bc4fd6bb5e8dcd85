"""LayerNorm: the CUDA kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of `megatron_clip_tpu/ops/pallas/layernorm.py::fused_layer_norm`:
its forward kernel and its VJP rule `_fln_bwd` (jnp in the JAX package, a
kernel here). The kernels are in `csrc/layernorm.cu`. `layer_norm_fwd` and
`layer_norm_bwd` take the plain version for a CPU tensor; for a CUDA tensor
they launch the kernel or raise. `layer_norm` is what the model calls.
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
    "mct_layer_norm_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/layernorm.cu: the backward keeps 4 warps x [2][W] fp32 column sums in
# shared memory, and its blocks (4 rows each, looping) write at most
# MAX_BWD_BLOCKS partial rows
MAX_BWD_WIDTH = 6144
MAX_BWD_BLOCKS = 1024


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


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         dy: torch.Tensor, eps: float = 1e-5):
    """The JAX package's `_fln_bwd` line by line: mean and rstd recomputed
    from x in fp32; dx = rstd (g - mean(g) - xhat mean(g xhat)) with
    g = dy scale, in x's dtype; dscale = sum dy xhat and dbias = sum dy over
    every row, in scale's dtype."""
    xf = x.float()
    dyf = dy.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    g = dyf * scale.float()
    dx = rstd * (g - g.mean(-1, keepdim=True)
                 - xhat * (g * xhat).mean(-1, keepdim=True))
    red = tuple(range(x.dim() - 1))
    dscale = (dyf * xhat).sum(red)
    dbias = dyf.sum(red)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous "
                         f"[rows, W] tensor, got shape {tuple(x.shape)}")


def _fp32_vector(name: str, what: str, t: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    w = x.shape[1]
    t = t.to(torch.float32).contiguous()
    if t.shape != (w,) or t.device != x.device:
        raise ValueError(f"{name}: {what} must be [{w}] on {x.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def _no_graph(name: str, *tensors: torch.Tensor) -> None:
    # the kernels write into fresh tensors: a graph through them would be
    # cut without a word, so autograd callers go through layer_norm
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is not differentiable itself; call "
                           "layer_norm, whose autograd Function runs the "
                           "backward kernel")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [rows, W] contiguous fp32/bf16; scale, bias [W]. Returns [rows, W]
    in x's dtype."""
    _no_graph("layer_norm_fwd", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check_rows("layer_norm_fwd", x)
    rows, w = x.shape
    scale = _fp32_vector("layer_norm_fwd", "scale", scale, x)
    bias = _fp32_vector("layer_norm_fwd", "bias", bias, x)
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


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-5):
    """Gradient of `layer_norm_fwd`: x and dy [rows, W] contiguous in one
    dtype (fp32/bf16), scale [W]. Returns (dx in x's dtype, dscale, dbias in
    scale's dtype); dscale and dbias are sums over every row."""
    _no_graph("layer_norm_bwd", x, scale, dy)
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    _check_rows("layer_norm_bwd", x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError("layer_norm_bwd: dy must be contiguous with x's "
                         f"shape, dtype and device, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    rows, w = x.shape
    if w > MAX_BWD_WIDTH:
        raise ValueError(f"layer_norm_bwd: width {w} above the kernel's "
                         f"{MAX_BWD_WIDTH}")
    scale32 = _fp32_vector("layer_norm_bwd", "scale", scale, x)
    nparts = min(-(-rows // 4), MAX_BWD_BLOCKS)
    dx = torch.empty_like(x)
    part = torch.empty((nparts, 2, w), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, w), dtype=torch.float32, device=x.device)
    lib = _build.load("layernorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mct_layer_norm_bwd(x.data_ptr(), scale32.data_ptr(),
                                    dy.data_ptr(), dx.data_ptr(),
                                    part.data_ptr(), nparts, sums.data_ptr(),
                                    rows, w, eps, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd: kernel launch failed "
                           f"(cudaError {rc}) for shape {tuple(x.shape)}")
    layer_norm_bwd.launches += 1
    return dx, sums[0].to(scale.dtype), sums[1].to(scale.dtype)


layer_norm_bwd.launches = 0


class LayerNorm(torch.autograd.Function):
    """Saves (x, scale) as the JAX rule `_fln_fwd` does; the backward runs
    `layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy.contiguous(),
                                           ctx.eps)
        return dx, dscale, dbias.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x [rows, W] -> LayerNorm(x) in x's dtype, differentiable in x, scale
    and bias through the backward kernel."""
    return LayerNorm.apply(x, scale, bias, eps)
