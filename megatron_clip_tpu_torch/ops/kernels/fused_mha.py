"""Fused packed-QKV attention, forward: the CUDA kernel's wrapper and its
plain version.

Counterpart of `megatron_clip_tpu/ops/pallas/fused_mha.py::fused_mha_packed`
(forward) as reached through `fused_attention_from_qkv`. The kernel is
`csrc/fused_mha.cu`. `fused_mha_fwd` takes the plain version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""
import ctypes

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

# the fused path's gate (ops/attention.py); above it the TPU package falls
# back to flash attention
MAX_FUSED_SEQ = 1024
MAX_HEAD_DIM = 128

_SIGNATURES = {
    "mct_fused_mha_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    causal: bool = False) -> torch.Tensor:
    """qkv [B, S, 3*H*D] -> [B, S, H*D]. fp32 scores and softmax; the
    probabilities are rounded to qkv's dtype before P.V, which accumulates
    in fp32; the result is rounded to qkv's dtype."""
    b, s, w3 = qkv.shape
    d = w3 // (3 * heads)
    q, k, v = (qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
               .float().unbind(0))                               # [B,H,S,D]
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(p, v)                                     # [B,H,S,D]
    return out.transpose(1, 2).reshape(b, s, heads * d).to(qkv.dtype)


def fused_mha_fwd(qkv: torch.Tensor, heads: int, *,
                  causal: bool = False) -> torch.Tensor:
    """Attention straight off the packed QKV projection output, scores
    scaled by D**-0.5.

    qkv: [B, S, 3*H*D] (q|k|v each H*D wide), contiguous fp32/bf16.
    Returns [B, S, H*D] in qkv's dtype."""
    b, s, w3 = qkv.shape
    if w3 % (3 * heads):
        raise ValueError(f"fused_mha_fwd: last dim {w3} is not 3*heads*D "
                         f"for heads={heads}")
    d = w3 // (3 * heads)
    scale = d ** -0.5
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, heads, scale, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha_fwd: unsupported device {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"fused_mha_fwd: dtype {qkv.dtype} not supported "
                        "(float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError("fused_mha_fwd: qkv must be contiguous")
    if not (1 <= s <= MAX_FUSED_SEQ and 1 <= d <= MAX_HEAD_DIM
            and 1 <= b <= 65535 and heads <= 65535):
        raise ValueError(f"fused_mha_fwd: shape B={b} S={s} H={heads} D={d} "
                         f"outside the kernel's range (S <= {MAX_FUSED_SEQ}, "
                         f"D <= {MAX_HEAD_DIM}, B <= 65535)")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_mha_fwd has no backward kernel yet (ROADMAP: train-step "
            "slice); call it under torch.no_grad()")
    out = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("fused_mha", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mct_fused_mha_fwd(qkv.data_ptr(), out.data_ptr(), b, s,
                                   heads, d, float(scale), int(causal),
                                   _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_mha_fwd: kernel launch failed "
                           f"(cudaError {rc}) for B={b} S={s} H={heads} D={d}")
    fused_mha_fwd.launches += 1
    return out


fused_mha_fwd.launches = 0
