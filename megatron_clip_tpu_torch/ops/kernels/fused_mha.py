"""Fused packed-QKV attention: the CUDA kernels' wrappers, their plain
versions and the autograd Function that joins them.

Counterpart of `megatron_clip_tpu/ops/pallas/fused_mha.py::fused_mha_packed`
as reached through `fused_attention_from_qkv`, in both of its backward
modes. With saved probabilities (`MCT_MHA_SAVE_PROBS=1`, the JAX default,
`save_probs=True` here) the forward also writes the softmax probabilities P
rounded to qkv's dtype and the backward (`_bwd_kernel`) reads them. Without
(`MCT_MHA_SAVE_PROBS=0`, `save_probs=False`) the backward
(`_bwd_kernel_recompute`) forms P again from qkv; the forward writes each
row's softmax max and denominator for it, 8 bytes a row. The kernels are in
`csrc/fused_mha.cu`. `fused_mha_fwd`, `fused_mha_bwd` and
`fused_mha_bwd_recompute` take the plain version for a CPU tensor, whatever
their `route`; for a CUDA tensor they launch the kernel or raise.
`fused_mha` is what the model calls: under autograd it runs the forward
with P or with the row statistics and saves them with qkv for the matching
backward kernel, otherwise the forward alone.

Every function takes a [B, S, *] view with contiguous rows and any batch and
sequence strides, and returns its outputs strided as qkv is. An S-major
tensor [S, B, 3*H*D] goes in as `qkv_sbw.transpose(0, 1)`: with
`save_probs=False` that is the counterpart of `fused_mha_packed_sm`
(`_fwd_kernel_sm`, `_bwd_kernel_sm`, which recomputes P too).

Dropout. `fused_mha_dropout` is the counterpart of `fused_mha_packed_dropout`
(`_fwd_kernel_dropout`, `_bwd_kernel_dropout`), taken while the JAX
package's gate `dropout_kernel_eligible` (copied here) holds: the forward
with row statistics and the recompute backward, each drawing the keep mask
M in the kernel (`csrc/philox.cuh`, `ops/dropout.py`) where the TPU kernels
read a [B, H, S, S] mask from device memory. M is keep / (1 - rate) rounded
to qkv's dtype, as `_dropout_mask` builds it (1.109375 in bf16 at rate 0.1,
1.1111112 in fp32). The forward rounds P M to qkv's dtype before P.V; the
backward forms dV from that, dP M, delta_i = sum_j (dP M)_ij P_ij and dS.
The plain versions take M as an explicit [B, H, S, S] fp32 tensor (`keep`).
`fused_mha_dropout_fwd` and `fused_mha_dropout_bwd` count their own
launches.

The residuals are this port's own and never compared with the JAX package's:
P is [B, H, S, S] (the JAX kernel's [B, S, H*S]), on the card the
[..., :S] view of a [B, H, S, probs_pitch(S, D, dtype)] buffer whose rows
the wgmma kernels past S = 128 pad to whole 16-byte rows, and the recompute
mode keeps (qkv, row statistics) where the JAX kernel keeps qkv alone and
recomputes the statistics inside its whole-row tile.
"""
import ctypes
import functools
from typing import Optional

import torch

from megatron_clip_tpu_torch.ops.dropout import (
    C_ARGTYPES, MASK_SIGNATURE, NO_DROPOUT_C_ARGS, AttentionDropout,
    attention_dropout, exported_mask)
from megatron_clip_tpu_torch.ops.kernels import _build

# the fused path's gate (ops/attention.py); above it the TPU package falls
# back to flash attention
MAX_FUSED_SEQ = 1024
MAX_HEAD_DIM = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# B, S, H, D, scale, causal, dtype[, the dropout arguments], stream
_SHAPE = [_I, _I, _I, _I, ctypes.c_float, _I, _I]
_SIGNATURES = {
    "mct_fused_mha_fwd": ([_P, _L, _L, _P, _L, _L, _P, _L, _P] + _SHAPE
                          + C_ARGTYPES + [_I, _P], _I),
    "mct_fused_mha_bwd": ([_P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _L, _P]
                          + _SHAPE + [_I, _P], _I),
    "mct_fused_mha_bwd_recompute": ([_P, _L, _L, _P, _L, _L, _P, _P, _L, _L,
                                     _P] + _SHAPE + C_ARGTYPES + [_I, _P],
                                    _I),
    "mct_fused_mha_bwd_needs_delta": ([_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                       _I, _I, _I, _I, _I], _I),
    "mct_fused_mha_probs_pitch": ([_I, _I, _I], _L),
    "mct_dropout_mask": MASK_SIGNATURE,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward's kernels by name (`mct_fused_mha_fwd`'s route): "auto" the
# one `csrc/fused_mha.cu` gives the shape; the one-pass kernel (bf16,
# S <= 128, D = 64) and tc::fwd, for the A/Bs that time one against the
# other
FWD_ROUTES = {"auto": 0, "one_pass": 1, "tc": 2}
# the backwards' kernels by name (`mct_fused_mha_bwd`'s and
# `mct_fused_mha_bwd_recompute`'s route), as the forward's: the one-pass
# kernel (bf16, S <= 128, D = 64, no dropout) keeps delta in registers, the
# others in a [B*H*S] fp32 scratch
BWD_ROUTES = {"auto": 0, "one_pass": 1, "tc": 2}


@functools.lru_cache(maxsize=None)
def probs_pitch(s: int, d: int, dtype: torch.dtype) -> int:
    """The row pitch, in elements, of the probabilities P [B, H, S, S] that
    the card's forward writes and its saved-P backward reads, as
    csrc/fused_mha.cu decides it (`mct_fused_mha_probs_pitch`: S, or S
    rounded up to 8 where the wgmma kernels past S = 128 read P by TMA).
    Builds the kernels' library: on the card only. Kept per shape, so that
    a call asks the library once."""
    return _build.load("fused_mha", _SIGNATURES).mct_fused_mha_probs_pitch(
        s, d, _DTYPES[dtype])


def probs_buffer(b: int, heads: int, s: int, d: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """An empty P [B, H, S, S] in the card's layout: the [..., :S] view of
    a [B, H, S, probs_pitch(S, D, dtype)] tensor."""
    return torch.empty((b, heads, s, probs_pitch(s, d, dtype)), dtype=dtype,
                       device=device)[..., :s]


def _check_probs_layout(name: str, p: torch.Tensor, d: int) -> int:
    """The card's P must be laid out as the forward writes it
    (`probs_buffer`); returns its row pitch."""
    b, h, s, _ = p.shape
    pitch = probs_pitch(s, d, p.dtype)
    if p.stride() != (h * s * pitch, s * pitch, pitch, 1):
        raise ValueError(f"{name}: p (strides {tuple(p.stride())}) is not "
                         f"the forward's P: the [..., :S] view of a "
                         f"contiguous [B, H, S, {pitch}] tensor")
    return pitch


def _split_heads(t: torch.Tensor, heads: int, parts: int):
    """[B, S, parts*H*D] -> `parts` fp32 tensors [B, H, S, D]."""
    b, s, w = t.shape
    d = w // (parts * heads)
    return (t.reshape(b, s, parts, heads, d).permute(2, 0, 3, 1, 4).float()
            .unbind(0))


def _merge_heads(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] or [parts, B, H, S, D] fp32 -> [B, S, parts*H*D] in
    `like`'s dtype and layout (S-major in memory when `like` is)."""
    if t.dim() == 4:
        t = t.unsqueeze(0)
    b, s = like.shape[:2]
    t = t.permute(1, 3, 0, 2, 4).reshape(b, s, -1).to(like.dtype)
    if like.stride(0) < like.stride(1):
        return t.transpose(0, 1).contiguous().transpose(0, 1)
    return t.contiguous()


def _empty_like_layout(like: torch.Tensor, width: int) -> torch.Tensor:
    """An empty [B, S, width] tensor, S-major in memory when `like` is."""
    b, s = like.shape[:2]
    if like.stride(0) < like.stride(1):
        return torch.empty((s, b, width), dtype=like.dtype,
                           device=like.device).transpose(0, 1)
    return torch.empty((b, s, width), dtype=like.dtype, device=like.device)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            causal: bool) -> torch.Tensor:
    """fp32 scaled scores [B, H, S, S], masked keys filled with -1e30."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        s = scores.shape[-1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    return scores


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    causal: bool = False, with_probs: bool = False,
                    with_stats: bool = False,
                    keep: Optional[torch.Tensor] = None):
    """qkv [B, S, 3*H*D] -> [B, S, H*D]; with `with_probs` also P
    [B, H, S, S], with `with_stats` also the row statistics [2, B, H, S]
    fp32 (each row's max of the scaled scores, then sum exp(s - max)).
    fp32 scores and softmax; the probabilities are rounded to qkv's dtype
    (that is P) before P.V, which accumulates in fp32; the result is rounded
    to qkv's dtype. With `keep`, the dropout multipliers M [B, H, S, S]
    fp32, P.V takes P M rounded to qkv's dtype (`_fwd_kernel_dropout`)."""
    if with_probs and keep is not None:
        raise ValueError("fused_mha_plain: dropout keeps no P")
    q, k, v = _split_heads(qkv, heads, 3)                        # [B,H,S,D]
    scores = _scores(q, k, scale, causal)
    p = torch.softmax(scores, dim=-1)
    if keep is not None:
        p = p * keep
    p = p.to(qkv.dtype)
    out = _merge_heads(torch.matmul(p.float(), v), qkv)
    extra = []
    if with_probs:
        extra.append(p)
    if with_stats:
        m = scores.amax(-1)
        extra.append(torch.stack([m, (scores - m[..., None]).exp().sum(-1)]))
    return (out, *extra) if extra else out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of x (its binade's spacing, 2^-7 of
    the binade's floor), 0 where x is 0; fp32."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return torch.where(x != 0, ulp, torch.zeros_like(ulp))


def fused_mha_row_bound(qkv: torch.Tensor, heads: int, causal: bool = False,
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bound a bf16 forward's output is held to, row by row: at row i,
    column c of head h, T_ic + ulp(|out_ic| + T_ic) with T_ic = sum_j
    ulp(P_ij) |v_jc|, P the plain version's probabilities as P.V takes them
    (times `keep`, rounded to qkv's dtype) and out its output. A kernel
    whose fp32 probabilities differ from the plain version's in their last
    bits rounds some P to the neighbouring bf16 value, one ulp of that P on
    one term of the row (T), and each side rounds its output once, by half
    an ulp at a magnitude of at most |out| + T: this bound allows exactly
    that (fp32 [B, S, H*D])."""
    q, k, v = _split_heads(qkv, heads, 3)
    p = torch.softmax(_scores(q, k, q.shape[-1] ** -0.5, causal), dim=-1)
    if keep is not None:
        p = p * keep
    p = p.to(qkv.dtype)
    out = torch.matmul(p.float(), v).to(qkv.dtype)
    terms = torch.matmul(bf16_ulp(p), v.abs())
    bound = terms + bf16_ulp(out.float().abs() + terms)
    b, s = qkv.shape[:2]
    return bound.permute(0, 2, 1, 3).reshape(b, s, -1)


def _bwd_head(q, k, v, g, p, scale, dtype, keep=None):
    """The JAX package's `_bwd_head` on [B, H, S, D] fp32 tensors: dV =
    P^T dO with P rounded to `dtype`, dP = dO V^T, dS = p (dP - rowsum(dP
    p)) scale rounded to `dtype` with p as given, dQ = dS K, dK = dS^T Q,
    each product in fp32. With `keep` (M), `_bwd_kernel_dropout`'s: dV from
    P M rounded to `dtype` and dP M in place of dP. Returns
    [3, B, H, S, D]."""
    pc = (p if keep is None else p * keep).to(dtype).float()
    dv = torch.matmul(pc.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dtype).float()
    return torch.stack([torch.matmul(ds, k),
                        torch.matmul(ds.transpose(-1, -2), q), dv])


def fused_mha_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, p: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """The backward from saved P, line by line as the JAX package's
    `_bwd_kernel`: `_bwd_head` with P as saved (in qkv's dtype) in every
    product; returns packed dqkv [B, S, 3*H*D] in qkv's dtype. P is 0 on
    masked pairs, so the causal mask needs no second statement here."""
    q, k, v = _split_heads(qkv, heads, 3)
    (g,) = _split_heads(do, heads, 1)
    return _merge_heads(_bwd_head(q, k, v, g, p.float(), scale, qkv.dtype),
                        qkv)


def fused_mha_bwd_recompute_plain(qkv: torch.Tensor, do: torch.Tensor,
                                  heads: int, scale: float,
                                  causal: bool = False,
                                  keep: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The backward recomputing P, line by line as the JAX package's
    `_bwd_kernel_recompute`: fp32 scores times scale, causal fill of -1e30,
    fp32 softmax p, then `_bwd_head` with that fp32 p in delta and dS and p
    rounded to qkv's dtype only in dV = bf16(p)^T dO. With `keep` (M) it is
    `_bwd_kernel_dropout`, line by line. Returns packed dqkv [B, S, 3*H*D]
    in qkv's dtype."""
    q, k, v = _split_heads(qkv, heads, 3)
    (g,) = _split_heads(do, heads, 1)
    p = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return _merge_heads(_bwd_head(q, k, v, g, p, scale, qkv.dtype, keep), qkv)


def _heads_per_cell(heads: int, hd: int) -> Optional[int]:
    """The JAX package's head-group size (`fused_mha.py::_heads_per_cell`):
    128 / head_dim heads per cell, so that the cell's lanes are a multiple
    of 128; None if the geometry cannot give that."""
    if 128 % hd != 0:
        return None
    hp = max(1, 128 // hd)
    return hp if heads % hp == 0 else None


def dropout_kernel_eligible(s: int, heads: int, hd: int,
                            budget: int = 10 * 1024 * 1024) -> bool:
    """The JAX package's gate of the fused dropout kernels
    (`fused_mha.py::dropout_kernel_eligible`), copied: the head group must
    exist and one cell's hp bf16 mask planes plus three fp32 [S, S] scratch
    tiles must fit 10 MiB. The port's kernels need neither, but the route
    must be the JAX package's."""
    hp = _heads_per_cell(heads, hd)
    if hp is None:
        return False
    return hp * s * s * 2 + 3 * s * s * 4 <= budget


def dropout_mult(rate: float, dtype: torch.dtype) -> float:
    """The fused kernels' multiplier of a kept probability: 1 / (1 - rate)
    rounded to qkv's dtype, as `_dropout_mask` scales its keep mask."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _keep(drop: AttentionDropout, qkv: torch.Tensor,
          heads: int) -> torch.Tensor:
    b, s, _ = qkv.shape
    return drop.multipliers(b, heads, s, s, dropout_mult(drop.rate, qkv.dtype),
                            qkv.device)


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous "
                         f"(strides {tuple(t.stride())})")


def _pitch(t: torch.Tensor):
    """The (batch, sequence) element strides of a [B, S, *] operand."""
    return t.stride(0), t.stride(1)


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


def _launch(name: str, device: torch.device, args, shape, dargs=(),
            lib=None) -> None:
    """Call the library's `mct_<name>` (`lib`: the loaded library, where
    the caller has it) with `args` (pointers and strides), then B, S, H, D,
    scale, causal, dtype, `dargs` (the dropout arguments and the route, of
    the functions that take them) and the current stream; raise if the
    launch failed."""
    if lib is None:
        lib = _build.load("fused_mha", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"mct_{name}")(*args, *shape, *dargs, stream)
    if rc != 0:
        b, s, h, d = shape[:4]
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc}) "
                           f"for B={b} S={s} H={h} D={d}")


def fused_mha_fwd(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                  with_probs: bool = False, with_stats: bool = False,
                  route: str = "auto"):
    """Attention straight off the packed QKV projection output, scores
    scaled by D**-0.5.

    qkv: [B, S, 3*H*D] (q|k|v each H*D wide), fp32/bf16, rows contiguous.
    Returns [B, S, H*D] in qkv's dtype and layout and, with `with_probs`,
    also the probabilities P [B, H, S, S] in qkv's dtype for
    `fused_mha_bwd` (on the card in `probs_buffer`'s layout), or with
    `with_stats` the row statistics [2, B, H, S] fp32 for
    `fused_mha_bwd_recompute`. `route` (a key of FWD_ROUTES) asks a CUDA
    tensor for one kernel; the launch fails where that kernel cannot take
    the shape."""
    _no_graph("fused_mha_fwd", qkv)
    if with_probs and with_stats:
        raise ValueError("fused_mha_fwd: with_probs and with_stats are the "
                         "two backward modes; ask for one")
    if route not in FWD_ROUTES:
        raise ValueError(f"fused_mha_fwd: route {route!r} is not one of "
                         f"{sorted(FWD_ROUTES)}")
    res = _fwd("fused_mha_fwd", qkv, heads, causal, with_probs, with_stats,
               None, FWD_ROUTES[route])
    if qkv.device.type == "cuda":
        fused_mha_fwd.launches += 1
    return res


fused_mha_fwd.launches = 0


def _fwd(name, qkv, heads, causal, with_probs, with_stats,
         drop: Optional[AttentionDropout], route: int = 0):
    d = _head_dim(name, qkv, heads)
    scale = d ** -0.5
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, heads, scale, causal, with_probs,
                               with_stats,
                               None if drop is None else _keep(drop, qkv,
                                                               heads))
    _check_cuda(name, qkv)
    b, s, _ = qkv.shape
    out = _empty_like_layout(qkv, heads * d)
    p = (probs_buffer(b, heads, s, d, qkv.dtype, qkv.device) if with_probs
         else None)
    stats = (torch.empty((2, b, heads, s), dtype=torch.float32,
                         device=qkv.device) if with_stats else None)
    _launch("fused_mha_fwd", qkv.device,
            [qkv.data_ptr(), *_pitch(qkv), out.data_ptr(), *_pitch(out),
             None if p is None else p.data_ptr(),
             0 if p is None else p.stride(2),
             None if stats is None else stats.data_ptr()],
            (b, s, heads, d, float(scale), int(causal), _DTYPES[qkv.dtype]),
            [*(NO_DROPOUT_C_ARGS if drop is None else drop.c_args(
                dropout_mult(drop.rate, qkv.dtype))), route])
    if with_probs:
        return out, p
    return (out, stats) if with_stats else out


def fused_mha_dropout_fwd(qkv: torch.Tensor, heads: int,
                          drop: AttentionDropout, *, causal: bool = False):
    """The forward with attention-probability dropout `drop` and row
    statistics: (out [B, S, H*D] in qkv's dtype and layout, stats
    [2, B, H, S] fp32) for `fused_mha_dropout_bwd`."""
    _no_graph("fused_mha_dropout_fwd", qkv)
    res = _fwd("fused_mha_dropout_fwd", qkv, heads, causal, False, True, drop)
    if qkv.device.type == "cuda":
        fused_mha_dropout_fwd.launches += 1
    return res


fused_mha_dropout_fwd.launches = 0


def _check_bwd(name: str, qkv: torch.Tensor, do: torch.Tensor, heads: int,
               residual: torch.Tensor, residual_shape, residual_dtype):
    d = _head_dim(name, qkv, heads)
    b, s, _ = qkv.shape
    if do.shape != (b, s, heads * d) or residual.shape != residual_shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} / residual "
                         f"{tuple(residual.shape)} do not match qkv "
                         f"{tuple(qkv.shape)} with heads={heads}")
    if qkv.device.type == "cpu":
        return d
    for t in (qkv, do):
        _check_cuda(name, t)
        if t.dtype != qkv.dtype or t.device != qkv.device:
            raise TypeError(f"{name}: qkv and do must share dtype and device")
    if residual.device != qkv.device or residual.dtype != residual_dtype:
        raise TypeError(f"{name}: the residual must be {residual_dtype} on "
                        f"{qkv.device}")
    return d


def _route(name: str, route: str) -> int:
    if route not in BWD_ROUTES:
        raise ValueError(f"{name}: route {route!r} is not one of "
                         f"{sorted(BWD_ROUTES)}")
    return BWD_ROUTES[route]


def _delta(lib, qkv: torch.Tensor, do: torch.Tensor, dqkv: torch.Tensor,
           heads: int, d: int, drop: Optional[AttentionDropout], route: int):
    """The [B*H*S] fp32 delta scratch of the backward's kernel on `route`,
    or None where that kernel keeps delta in registers (the library `lib`
    says which kernel takes the call)."""
    b, s, _ = qkv.shape
    if not lib.mct_fused_mha_bwd_needs_delta(
            qkv.data_ptr(), *_pitch(qkv), do.data_ptr(), *_pitch(do),
            dqkv.data_ptr(), *_pitch(dqkv), s, d, _DTYPES[qkv.dtype],
            int(drop is not None), route):
        return None
    return torch.empty(b * heads * s, dtype=torch.float32, device=qkv.device)


def fused_mha_bwd(qkv: torch.Tensor, do: torch.Tensor, p: torch.Tensor,
                  heads: int, *, causal: bool = False,
                  route: str = "auto") -> torch.Tensor:
    """Gradient of `fused_mha_fwd` with respect to qkv, from its saved P.

    qkv [B, S, 3*H*D] and do [B, S, H*D] with contiguous rows, p
    [B, H, S, S], all in one dtype (fp32/bf16); on the card P must be laid
    out as the forward writes it (`probs_buffer`), else ValueError. Returns
    packed dqkv [B, S, 3*H*D] in that dtype, strided as qkv. `route` (a key
    of BWD_ROUTES) asks a CUDA tensor for one kernel; the launch fails where
    that kernel cannot take the shape, and where the wgmma kernels past
    S = 128 take the call but P lies off its 16-byte alignment."""
    _no_graph("fused_mha_bwd", qkv, do, p)
    r = _route("fused_mha_bwd", route)
    b, s, _ = qkv.shape
    d = _check_bwd("fused_mha_bwd", qkv, do, heads, p,
                   (b, heads, s, s), qkv.dtype)
    if qkv.device.type == "cpu":
        return fused_mha_bwd_plain(qkv, do, p, heads, d ** -0.5)
    pitch = _check_probs_layout("fused_mha_bwd", p, d)
    dqkv = _empty_like_layout(qkv, qkv.shape[-1])
    lib = _build.load("fused_mha", _SIGNATURES)
    delta = _delta(lib, qkv, do, dqkv, heads, d, None, r)
    _launch("fused_mha_bwd", qkv.device,
            [qkv.data_ptr(), *_pitch(qkv), do.data_ptr(), *_pitch(do),
             p.data_ptr(), pitch, dqkv.data_ptr(), *_pitch(dqkv),
             None if delta is None else delta.data_ptr()],
            (b, s, heads, d, float(d ** -0.5), int(causal),
             _DTYPES[qkv.dtype]), [r], lib)
    fused_mha_bwd.launches += 1
    return dqkv


fused_mha_bwd.launches = 0


def fused_mha_bwd_recompute(qkv: torch.Tensor, do: torch.Tensor,
                            stats: torch.Tensor, heads: int, *,
                            causal: bool = False,
                            route: str = "auto") -> torch.Tensor:
    """Gradient of `fused_mha_fwd` with respect to qkv, recomputing P from
    qkv and the forward's row statistics (`with_stats=True`).

    qkv [B, S, 3*H*D] and do [B, S, H*D] in one dtype (fp32/bf16) with
    contiguous rows, stats [2, B, H, S] fp32. Returns packed dqkv
    [B, S, 3*H*D] in qkv's dtype, strided as qkv. The plain version (CPU)
    recomputes the statistics too. `route` as `fused_mha_bwd`'s."""
    _no_graph("fused_mha_bwd_recompute", qkv, do, stats)
    dqkv = _bwd_recompute("fused_mha_bwd_recompute", qkv, do, stats, heads,
                          causal, None,
                          _route("fused_mha_bwd_recompute", route))
    if qkv.device.type == "cuda":
        fused_mha_bwd_recompute.launches += 1
    return dqkv


fused_mha_bwd_recompute.launches = 0


def _bwd_recompute(name, qkv, do, stats, heads, causal,
                   drop: Optional[AttentionDropout], route: int = 0):
    b, s, _ = qkv.shape
    d = _check_bwd(name, qkv, do, heads, stats, (2, b, heads, s),
                   torch.float32)
    if qkv.device.type == "cuda" and not stats.is_contiguous():
        raise TypeError(f"{name}: the statistics must be contiguous")
    if qkv.device.type == "cpu":
        return fused_mha_bwd_recompute_plain(
            qkv, do, heads, d ** -0.5, causal,
            None if drop is None else _keep(drop, qkv, heads))
    dqkv = _empty_like_layout(qkv, qkv.shape[-1])
    lib = _build.load("fused_mha", _SIGNATURES)
    delta = _delta(lib, qkv, do, dqkv, heads, d, drop, route)
    _launch("fused_mha_bwd_recompute", qkv.device,
            [qkv.data_ptr(), *_pitch(qkv), do.data_ptr(), *_pitch(do),
             stats.data_ptr(), dqkv.data_ptr(), *_pitch(dqkv),
             None if delta is None else delta.data_ptr()],
            (b, s, heads, d, float(d ** -0.5), int(causal),
             _DTYPES[qkv.dtype]),
            [*(NO_DROPOUT_C_ARGS if drop is None else drop.c_args(
                dropout_mult(drop.rate, qkv.dtype))), route], lib)
    return dqkv


def fused_mha_dropout_bwd(qkv: torch.Tensor, do: torch.Tensor,
                          stats: torch.Tensor, heads: int,
                          drop: AttentionDropout, *,
                          causal: bool = False) -> torch.Tensor:
    """Gradient of `fused_mha_dropout_fwd` with respect to qkv: P
    recomputed from qkv and the row statistics, the mask drawn again from
    `drop`. Returns packed dqkv [B, S, 3*H*D] in qkv's dtype, strided as
    qkv."""
    _no_graph("fused_mha_dropout_bwd", qkv, do, stats)
    dqkv = _bwd_recompute("fused_mha_dropout_bwd", qkv, do, stats, heads,
                          causal, drop)
    if qkv.device.type == "cuda":
        fused_mha_dropout_bwd.launches += 1
    return dqkv


fused_mha_dropout_bwd.launches = 0


def dropout_mask(bh: int, rows: int, cols: int, rate: float, seed: int,
                 offset: int, device, placement=(0, 0, 0)) -> torch.Tensor:
    """The keep bits the fused kernels draw, bool [bh, rows, cols] on
    `device` (a CUDA device), its heads placed in the step by `placement`:
    `ops.dropout.exported_mask` of this library."""
    return exported_mask(_build.load("fused_mha", _SIGNATURES), bh, rows,
                         cols, rate, seed, offset, device, placement)


class FusedMHA(torch.autograd.Function):
    """The JAX custom_vjp's `_fused_fwd` / `_fused_bwd`. With `save_probs`
    the forward writes P and the backward reads it; without, the forward
    writes the row statistics and the backward recomputes P."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, causal: bool,
                save_probs: bool):
        out, residual = fused_mha_fwd(qkv, heads, causal=causal,
                                      with_probs=save_probs,
                                      with_stats=not save_probs)
        ctx.save_for_backward(qkv, residual)
        ctx.heads, ctx.causal, ctx.save_probs = heads, causal, save_probs
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, residual = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        bwd = fused_mha_bwd if ctx.save_probs else fused_mha_bwd_recompute
        return bwd(qkv, do, residual, ctx.heads,
                   causal=ctx.causal), None, None, None


class FusedMHADropout(torch.autograd.Function):
    """The JAX custom_vjp of `fused_mha_packed_dropout`: the forward keeps
    (qkv, row statistics) and the dropout's (rate, seed, offset); the
    backward recomputes P and draws the mask again."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, causal: bool, drop):
        out, stats = fused_mha_dropout_fwd(qkv, heads, drop, causal=causal)
        ctx.save_for_backward(qkv, stats)
        ctx.heads, ctx.causal, ctx.drop = heads, causal, drop
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, stats = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        return fused_mha_dropout_bwd(qkv, do, stats, ctx.heads, ctx.drop,
                                     causal=ctx.causal), None, None, None


def fused_mha_dropout(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                      rate: float, seed: Optional[int],
                      offset: int = 0) -> torch.Tensor:
    """[B, S, 3*H*D] -> [B, S, H*D] with attention-probability dropout at
    `rate` (mask of (seed, offset), see `ops/dropout.py`); differentiable.
    Rate 0 or no seed runs `fused_mha` (the rate-0 kernels, P saved)."""
    drop = attention_dropout(rate, seed, offset, heads)
    if drop is None:
        return fused_mha(qkv, heads, causal=causal)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedMHADropout.apply(qkv, heads, causal, drop)
    return fused_mha_dropout_fwd(qkv, heads, drop, causal=causal)[0]


def fused_mha(qkv: torch.Tensor, heads: int, *, causal: bool = False,
              save_probs: bool = True) -> torch.Tensor:
    """[B, S, 3*H*D] -> [B, S, H*D], any batch and sequence strides. Under
    autograd (grad enabled and qkv requiring it) the forward also writes P
    (`save_probs`, the JAX default) or the row statistics for the recompute
    backward; else the forward runs alone and writes neither."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedMHA.apply(qkv, heads, causal, save_probs)
    return fused_mha_fwd(qkv, heads, causal=causal)
