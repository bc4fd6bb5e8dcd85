"""LayerNorm and RMSNorm: the CUDA kernels' wrappers, their plain versions
and the autograd Functions that join them.

Counterpart of `megatron_clip_tpu/ops/pallas/layernorm.py::fused_layer_norm`
(its forward kernel and its VJP rule `_fln_bwd`) and of `fused_rms_norm`
(the same kernel with rms=True, and `_frms_bwd`); the rules are jnp in the
JAX package and kernels here. The kernels are in `csrc/layernorm.cu`, the
RMS ones as variants of the LayerNorm ones. `layer_norm_fwd`,
`layer_norm_bwd`, `rms_norm_fwd` and `rms_norm_bwd` take the plain version
for a CPU tensor; for a CUDA tensor they launch the kernel or raise.
`layer_norm` and `rms_norm` are what the model calls. The kernels read
scale and bias in their own dtype (fp32 or bf16) and the backward writes
dscale and dbias in scale's dtype: a call launches no cast kernel.
"""
import ctypes

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "mct_layer_norm_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "mct_layer_norm_bwd": (_BWD_ARGS, ctypes.c_int),
    "mct_rms_norm_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int),
    "mct_rms_norm_bwd": (_BWD_ARGS, ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/layernorm.cu: rows too wide for registers take a kernel that keeps 4
# warps x [2][W] fp32 column sums in shared memory (RMS: [1][W]); the
# partial rows of the scratch are at most one per 4 rows and MAX_BWD_BLOCKS
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


def _param(name: str, what: str, t: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """A [W] parameter on x's device in fp32 or bf16, as it is (contiguous:
    a copy only for a strided view)."""
    w = x.shape[1]
    if t.shape != (w,) or t.device != x.device:
        raise ValueError(f"{name}: {what} must be [{w}] on {x.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: {what} dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return t.contiguous()


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in fp32,
    result in x's dtype (`_ln_kernel` with rms=True)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                       dy: torch.Tensor, eps: float = 1e-6):
    """The JAX package's `_frms_bwd` line by line: rstd recomputed from x in
    fp32; dx = rstd (g - xhat mean(g xhat)) with xhat = x rstd and
    g = dy scale, in x's dtype; dscale = sum dy xhat over every row, in
    scale's dtype."""
    xf = x.float()
    dyf = dy.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dyf * scale.float()
    dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    dscale = (dyf * xhat).sum(tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _no_graph(name: str, *tensors: torch.Tensor) -> None:
    # the kernels write into fresh tensors: a graph through them would be
    # cut without a word, so autograd callers go through layer_norm or
    # rms_norm
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is not differentiable itself; call "
                           "layer_norm or rms_norm, whose autograd Function "
                           "runs the backward kernel")


def _launch(fn: str, x: torch.Tensor, args: list) -> None:
    """Call the library's `fn` with `args` and the current stream; raise if
    the launch failed."""
    lib = _build.load("layernorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc}) for "
                           f"shape {tuple(x.shape)}")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [rows, W] contiguous fp32/bf16; scale, bias [W]. Returns [rows, W]
    in x's dtype."""
    _no_graph("layer_norm_fwd", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check_rows("layer_norm_fwd", x)
    scale = _param("layer_norm_fwd", "scale", scale, x)
    bias = _param("layer_norm_fwd", "bias", bias, x)
    if scale.dtype != bias.dtype:  # the kernel reads both in one dtype
        scale, bias = scale.float(), bias.float()
    y = torch.empty_like(x)
    _launch("mct_layer_norm_fwd", x,
            [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             *x.shape, eps, _DTYPES[x.dtype], _DTYPES[scale.dtype]])
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def _bwd(name: str, fn: str, nsums: int, x: torch.Tensor,
         scale: torch.Tensor, dy: torch.Tensor, eps: float):
    """Launch the backward kernels `fn` with `nsums` column sums per column;
    returns (dx, sums [nsums, W] in scale's dtype)."""
    _check_rows(name, x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be contiguous with x's shape, "
                         f"dtype and device, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    rows, w = x.shape
    if w > MAX_BWD_WIDTH:
        raise ValueError(f"{name}: width {w} above the kernel's "
                         f"{MAX_BWD_WIDTH}")
    scale = _param(name, "scale", scale, x)
    max_parts = min(-(-rows // 4), MAX_BWD_BLOCKS)
    dx = torch.empty_like(x)
    part = torch.empty((max_parts, nsums, w), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((nsums, w), dtype=scale.dtype, device=x.device)
    _launch(fn, x, [x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), max_parts,
                    sums.data_ptr(), rows, w, eps, _DTYPES[x.dtype],
                    _DTYPES[scale.dtype]])
    return dx, sums


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-5):
    """Gradient of `layer_norm_fwd`: x and dy [rows, W] contiguous in one
    dtype (fp32/bf16), scale [W]. Returns (dx in x's dtype, dscale, dbias in
    scale's dtype); dscale and dbias are sums over every row."""
    _no_graph("layer_norm_bwd", x, scale, dy)
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    dx, sums = _bwd("layer_norm_bwd", "mct_layer_norm_bwd", 2, x, scale, dy,
                    eps)
    layer_norm_bwd.launches += 1
    return dx, sums[0], sums[1]


layer_norm_bwd.launches = 0


class LayerNorm(torch.autograd.Function):
    """Saves (x, scale) as the JAX rule `_fln_fwd` does; the backward runs
    `layer_norm_bwd`, and casts dbias only where bias's dtype is not
    scale's."""

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


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x [rows, W] contiguous fp32/bf16; scale [W]. Returns [rows, W] in x's
    dtype."""
    _no_graph("rms_norm_fwd", x, scale)
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    _check_rows("rms_norm_fwd", x)
    scale = _param("rms_norm_fwd", "scale", scale, x)
    y = torch.empty_like(x)
    _launch("mct_rms_norm_fwd", x, [x.data_ptr(), scale.data_ptr(),
                                    y.data_ptr(), *x.shape, eps,
                                    _DTYPES[x.dtype], _DTYPES[scale.dtype]])
    rms_norm_fwd.launches += 1
    return y


rms_norm_fwd.launches = 0


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6):
    """Gradient of `rms_norm_fwd`: x and dy [rows, W] contiguous in one dtype
    (fp32/bf16), scale [W]. Returns (dx in x's dtype, dscale in scale's
    dtype, the sum over every row)."""
    _no_graph("rms_norm_bwd", x, scale, dy)
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, scale, dy, eps)
    dx, sums = _bwd("rms_norm_bwd", "mct_rms_norm_bwd", 1, x, scale, dy, eps)
    rms_norm_bwd.launches += 1
    return dx, sums[0]


rms_norm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """Saves (x, scale) as the JAX rule `_frms_fwd` does; the backward runs
    `rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x [rows, W] -> RMSNorm(x) in x's dtype, differentiable in x and scale
    through the backward kernel."""
    return RMSNorm.apply(x, scale, eps)
