"""Fused packed-QKV attention: the CUDA kernels' wrappers, their plain
versions and the autograd Function that joins them.

Counterpart of `megatron_clip_tpu/ops/pallas/fused_mha.py::fused_mha_packed`
as reached through `fused_attention_from_qkv`, in its default saved-P mode
(`MCT_MHA_SAVE_PROBS=1`): the forward also writes the softmax probabilities P
rounded to qkv's dtype, and the backward reads them. The kernels are in
`csrc/fused_mha.cu`. `fused_mha_fwd` and `fused_mha_bwd` take the plain
version for a CPU tensor; for a CUDA tensor they launch the kernel or raise.
`fused_mha` is what the model calls: under autograd it runs the forward with
P and saves (qkv, P) for the backward kernel, otherwise the forward alone.

P's layout is [B, H, S, S] (the JAX kernel's is [B, S, H*S]): a residual
between the two halves, never compared with the JAX package's.
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
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "mct_fused_mha_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(t: torch.Tensor, heads: int, parts: int):
    """[B, S, parts*H*D] -> `parts` fp32 tensors [B, H, S, D]."""
    b, s, w = t.shape
    d = w // (parts * heads)
    return (t.reshape(b, s, parts, heads, d).permute(2, 0, 3, 1, 4).float()
            .unbind(0))


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    causal: bool = False, with_probs: bool = False):
    """qkv [B, S, 3*H*D] -> [B, S, H*D], and with `with_probs` also
    P [B, H, S, S]. fp32 scores and softmax; the probabilities are rounded
    to qkv's dtype (that is P) before P.V, which accumulates in fp32; the
    result is rounded to qkv's dtype."""
    b, s, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, 3)                        # [B,H,S,D]
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(p.float(), v)                             # [B,H,S,D]
    out = out.transpose(1, 2).reshape(b, s, -1).to(qkv.dtype)
    return (out, p) if with_probs else out


def fused_mha_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, p: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """The backward from saved P, line by line as the JAX package's
    `_bwd_head`: dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) scale
    rounded to qkv's dtype, dQ = dS K, dK = dS^T Q, each product in fp32;
    returns packed dqkv [B, S, 3*H*D] in qkv's dtype. P is 0 on masked
    pairs, so the causal mask needs no second statement here."""
    b, s, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, 3)
    (g,) = _split_heads(do, heads, 1)
    pf = p.float()
    dv = torch.matmul(pf.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = (pf * (dp - (dp * pf).sum(-1, keepdim=True)) * scale).to(qkv.dtype)
    dq = torch.matmul(ds.float(), k)
    dk = torch.matmul(ds.float().transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv])                           # [3,B,H,S,D]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, -1).to(qkv.dtype)


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _head_dim(name: str, qkv: torch.Tensor, heads: int) -> int:
    b, s, w3 = qkv.shape
    if w3 % (3 * heads):
        raise ValueError(f"{name}: last dim {w3} is not 3*heads*D for "
                         f"heads={heads}")
    d = w3 // (3 * heads)
    if qkv.device.type == "cuda" and not (
            1 <= s <= MAX_FUSED_SEQ and 1 <= d <= MAX_HEAD_DIM
            and 1 <= b <= 65535 and heads <= 65535):
        raise ValueError(f"{name}: shape B={b} S={s} H={heads} D={d} outside "
                         f"the kernel's range (S <= {MAX_FUSED_SEQ}, "
                         f"D <= {MAX_HEAD_DIM}, B <= 65535)")
    return d


def _no_graph(name: str, *tensors: torch.Tensor) -> None:
    # the kernels write into fresh tensors: a graph through them would be
    # cut without a word, so autograd callers go through fused_mha
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is not differentiable itself; call "
                           "fused_mha, whose autograd Function runs the "
                           "backward kernel")


def fused_mha_fwd(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                  with_probs: bool = False):
    """Attention straight off the packed QKV projection output, scores
    scaled by D**-0.5.

    qkv: [B, S, 3*H*D] (q|k|v each H*D wide), contiguous fp32/bf16.
    Returns [B, S, H*D] in qkv's dtype and, with `with_probs`, also the
    probabilities P [B, H, S, S] in qkv's dtype for `fused_mha_bwd`."""
    _no_graph("fused_mha_fwd", qkv)
    d = _head_dim("fused_mha_fwd", qkv, heads)
    scale = d ** -0.5
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, heads, scale, causal, with_probs)
    _check_cuda("fused_mha_fwd", qkv)
    b, s, _ = qkv.shape
    out = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    p = (torch.empty((b, heads, s, s), dtype=qkv.dtype, device=qkv.device)
         if with_probs else None)
    lib = _build.load("fused_mha", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mct_fused_mha_fwd(qkv.data_ptr(), out.data_ptr(),
                                   None if p is None else p.data_ptr(), b, s,
                                   heads, d, float(scale), int(causal),
                                   _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_mha_fwd: kernel launch failed "
                           f"(cudaError {rc}) for B={b} S={s} H={heads} D={d}")
    fused_mha_fwd.launches += 1
    return (out, p) if with_probs else out


fused_mha_fwd.launches = 0


def fused_mha_bwd(qkv: torch.Tensor, do: torch.Tensor, p: torch.Tensor,
                  heads: int, *, causal: bool = False) -> torch.Tensor:
    """Gradient of `fused_mha_fwd` with respect to qkv, from its saved P.

    qkv [B, S, 3*H*D], do [B, S, H*D], p [B, H, S, S], all contiguous in one
    dtype (fp32/bf16). Returns packed dqkv [B, S, 3*H*D] in that dtype."""
    _no_graph("fused_mha_bwd", qkv, do, p)
    d = _head_dim("fused_mha_bwd", qkv, heads)
    b, s, _ = qkv.shape
    if do.shape != (b, s, heads * d) or p.shape != (b, heads, s, s):
        raise ValueError(f"fused_mha_bwd: do {tuple(do.shape)} / p "
                         f"{tuple(p.shape)} do not match qkv "
                         f"{tuple(qkv.shape)} with heads={heads}")
    if qkv.device.type == "cpu":
        return fused_mha_bwd_plain(qkv, do, p, heads, d ** -0.5)
    for t in (qkv, do, p):
        _check_cuda("fused_mha_bwd", t)
        if t.dtype != qkv.dtype or t.device != qkv.device:
            raise TypeError("fused_mha_bwd: qkv, do and p must share dtype "
                            "and device")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(b * heads * s, dtype=torch.float32, device=qkv.device)
    lib = _build.load("fused_mha", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mct_fused_mha_bwd(qkv.data_ptr(), do.data_ptr(),
                                   p.data_ptr(), dqkv.data_ptr(),
                                   delta.data_ptr(), b, s, heads, d,
                                   float(d ** -0.5), int(causal),
                                   _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_mha_bwd: kernel launch failed "
                           f"(cudaError {rc}) for B={b} S={s} H={heads} D={d}")
    fused_mha_bwd.launches += 1
    return dqkv


fused_mha_bwd.launches = 0


class FusedMHA(torch.autograd.Function):
    """The forward writes P; the backward reads it (the JAX custom_vjp's
    `_fused_fwd` / `_fused_bwd` with saved probabilities)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, causal: bool):
        out, p = fused_mha_fwd(qkv, heads, causal=causal, with_probs=True)
        ctx.save_for_backward(qkv, p)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, p = ctx.saved_tensors
        return fused_mha_bwd(qkv, do.contiguous(), p, ctx.heads,
                             causal=ctx.causal), None, None


def fused_mha(qkv: torch.Tensor, heads: int, *,
              causal: bool = False) -> torch.Tensor:
    """[B, S, 3*H*D] -> [B, S, H*D]. Under autograd (grad enabled and qkv
    requiring it) the forward also writes P for the backward kernel; else
    the forward runs alone and writes no P."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedMHA.apply(qkv, heads, causal)
    return fused_mha_fwd(qkv, heads, causal=causal)
