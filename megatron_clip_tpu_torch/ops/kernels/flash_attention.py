"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd Functions that join them.

Counterpart of `megatron_clip_tpu/ops/pallas/flash_attention.py::
flash_attention`, its in-kernel dropout (`_drop_keep`) included. The
kernels are in `csrc/flash_attention.cu`: the forward (`_fwd_kernel`), the
fused backward (`_bwd_fused_kernel`) and the split dQ and dKV backward
(`_bwd_dq_kernel`, `_bwd_dkv_kernel`), each with and without dropout.
`flash_fwd`, `flash_bwd_fused`, `flash_bwd_dq` and `flash_bwd_dkv`, and
their dropout twins `flash_fwd_dropout`, ..., take the plain version for a
CPU tensor; for a CUDA tensor they launch the kernel or raise. Each counts
its own launches.

Dropout (megatron --attention-dropout). The kernels draw the keep mask of
each score from Philox4x32-10 (`csrc/philox.cuh`, `ops/dropout.py`), from
the global indices of the score, so the forward and every backward draw
the same mask and none is stored. As the TPU kernels: the forward
multiplies the unnormalised fp32 p by keep / (1 - rate) in fp32 before it
is rounded for P.V, and l keeps the undropped sum; the backward takes
dP M and dV from bf16(P M), and delta = rowsum(dO * O) as it is, O being
dropped already. The plain versions take the multipliers M as an explicit
[B, H, Sq, Sk] fp32 tensor (`keep`); on the CPU the wrappers draw it with
`AttentionDropout.multipliers`. The JAX package's tile mask (per 1024-key
block from the TPU's PRNG) cannot be reproduced; its mask is per element
here (ROADMAP Queue C).

Which backward runs is the JAX package's choice, made from the key length
alone (`uses_fused_bwd`): the fused kernel while the keys, padded to 128,
span at most 4 blocks of 1024 (S <= 4096), the split kernels above. The
kernels' own tiles (64 or 128 rows) do not change it.

Layout. The public function takes q [B, H, Sq, D], k and v [B, H, Sk, D]
(the JAX layout) as views with contiguous rows of D and any other strides,
so the heads of a packed [B, S, 3*H*D] projection are read in place
(`flash_attention_qkv`). The output is written in [B, Sq, H, D] storage and
returned as its [B, H, Sq, D] view, so merging the heads afterwards is free;
dq, dk and dv are written into one packed [B, S, 3*H*D] buffer when Sq ==
Sk, which is the gradient of that projection as it stands.

Arithmetic (plain versions and kernels alike, as the TPU kernels): fp32
scores times `scale`, the causal mask row >= col with no offset when
Sq != Sk (unlike `sdpa`'s), masked scores -1e30; the forward's P
unnormalised, rounded to v's dtype before P.V, out = acc / l with l == 0
taken as 1, lse = m + log(l); the backward's P = exp(s - lse) in fp32,
delta = rowsum(dO * O) in fp32, dS = P (dP - delta) scale in fp32, dV from
bf16(P), dQ and dK from dS rounded to the input dtype.
"""
import ctypes
from typing import Optional, Tuple

import torch

from megatron_clip_tpu_torch.ops.dropout import (
    C_ARGTYPES, MASK_SIGNATURE, NO_DROPOUT_C_ARGS, AttentionDropout,
    attention_dropout, exported_mask)
from megatron_clip_tpu_torch.ops.kernels import _build

MAX_HEAD_DIM = 128
# head dims whose bf16 backward runs on wgmma (csrc/flash_attention.cu
# hop::bwd_fused, and the split pair hop::bwd_dq, hop::bwd_dkv); every other
# one on the mma.sync kernel the fused backward shares with the split dKV
WGMMA_FUSED_HEAD_DIMS = (64, 128)
NEG_INF = -1e30
# the JAX package's blocks: S padded to 128, then blocks of up to 1024; the
# fused backward while the keys span at most 4 of them
_JAX_PAD, _JAX_BLOCK, _FUSED_MAX_KEY_BLOCKS = 128, 1024, 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_V = [_P, _L, _L, _L]  # pointer, batch, head and sequence strides
# B, H, Sq, Sk, D, scale, causal, dtype, the dropout arguments, stream
_TAIL = [_I, _I, _I, _I, _I, ctypes.c_float, _I, _I, *C_ARGTYPES, _P]
_SIGNATURES = {
    "mct_flash_fwd": (4 * _V + [_P] + _TAIL, _I),
    "mct_flash_bwd_fused": (4 * _V + [_P, _P] + 2 * _V + [_P] + _TAIL, _I),
    "mct_flash_bwd_dq": (4 * _V + [_P, _P] + _V + _TAIL, _I),
    "mct_flash_bwd_dkv": (4 * _V + [_P, _P] + 2 * _V + _TAIL, _I),
    "mct_dropout_mask": MASK_SIGNATURE,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def uses_fused_bwd(sk: int) -> bool:
    """The JAX package's choice (`_flash_bwd`, default blocks): the fused
    backward while ceil(S_pad / 1024) <= 4, with S_pad the key length padded
    to its block."""
    block = min(_JAX_BLOCK, _cdiv(sk, _JAX_PAD) * _JAX_PAD)
    return _cdiv(sk, block) <= _FUSED_MAX_KEY_BLOCKS


# ---------------------------- plain versions --------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            causal: bool) -> torch.Tensor:
    """fp32 scaled scores [B, H, Sq, Sk]; masked pairs (causal: row < col)
    -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False,
                    keep: Optional[torch.Tensor] = None):
    """(out [B, H, Sq, D] in q's dtype, lse [B, H, Sq] fp32), the TPU
    forward's arithmetic over one block of every key; with `keep` (the
    dropout multipliers [B, H, Sq, Sk] fp32) P.V takes p * keep."""
    s = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    if keep is not None:
        p = p * keep
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, Sq] contiguous (the JAX
    package computes it outside its backward kernels too)."""
    return (do.float() * out.float()).sum(-1).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal, keep):
    """(P, with dropout P * keep, and dS) in fp32."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    pd = p
    if keep is not None:
        dp, pd = dp * keep, p * keep
    return pd, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float,
                       causal: bool = False,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ = bf16(dS) K, as `_bwd_dq_kernel`, dS from dP * keep with
    dropout; [B, H, Sq, D] in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal, keep)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                        causal: bool = False,
                        keep: Optional[torch.Tensor] = None):
    """(dK = bf16(dS)^T Q, dV = bf16(P)^T dO), as `_bwd_dkv_kernel`; with
    dropout dV from bf16(P * keep) and dS from dP * keep."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal, keep)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_plain(q, k, v, out, lse, do, scale: float,
                          causal: bool = False,
                          keep: Optional[torch.Tensor] = None):
    """(dQ, dK, dV), as `_bwd_fused_kernel` with delta formed outside: the
    fp32 sum of its dQ partials is the fp32 dS K that the split kernel
    accumulates, rounded once."""
    delta = flash_delta(do, out)
    return (flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, keep),
            *flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                 keep))


def dropout_mult(rate: float) -> float:
    """The flash kernels' multiplier of a kept probability: 1 / (1 - rate)
    in fp32, as `_drop_keep`."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _keep(drop: Optional[AttentionDropout], q, k) -> Optional[torch.Tensor]:
    """The plain versions' multipliers for `drop`, or None."""
    if drop is None:
        return None
    b, h, sq, _ = q.shape
    return drop.multipliers(b, h, sq, k.shape[2], dropout_mult(drop.rate),
                            q.device)


# ---------------------------- kernel wrappers -------------------------------

def _check(name: str, q, k, v, *rest) -> int:
    """Shapes [B, H, Sq, D] and [B, H, Sk, D]; on the card one dtype and
    device and contiguous rows. Returns D."""
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, H, S, D] alike")
    if q.device.type == "cpu":
        return d
    for t in (q, k, v, *rest):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v (and dO) must share a dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous "
                             f"(strides {tuple(t.stride())})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if not (1 <= d <= MAX_HEAD_DIM and b <= 65535 and h <= 65535):
        raise ValueError(f"{name}: B={b} H={h} D={d} outside the kernel's "
                         f"range (D <= {MAX_HEAD_DIM}, B and H <= 65535)")
    return d


def _no_graph(name: str, *tensors: torch.Tensor) -> None:
    # the kernels write into fresh tensors: a graph through them would be
    # cut without a word, so autograd callers go through flash_attention
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is not differentiable itself; call "
                           "flash_attention, whose autograd Function runs the "
                           "backward kernels")


def _view(t: torch.Tensor):
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.device.type == "cuda" and (t.dtype != torch.float32
                                    or not t.is_contiguous()):
        raise TypeError(f"{name} must be contiguous float32 [B, H, Sq]")
    return t


def _launch(fn: str, q, k, args, causal: bool, scale: float,
            drop: Optional[AttentionDropout]) -> None:
    """Call the library's `fn` with `args` (views and pointers), then B, H,
    Sq, Sk, D, scale, causal, dtype, the dropout arguments and the current
    stream; raise if the launch failed."""
    lib = _build.load("flash_attention", _SIGNATURES)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dargs = (NO_DROPOUT_C_ARGS if drop is None
             else drop.c_args(dropout_mult(drop.rate)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(*args, b, h, sq, sk, d, float(scale),
                              int(causal), _DTYPES[q.dtype], *dargs, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc}) for "
                           f"B={b} H={h} Sq={sq} Sk={sk} D={d}")


def dropout_mask(bh: int, rows: int, cols: int, rate: float, seed: int,
                 offset: int, device, placement=(0, 0, 0)) -> torch.Tensor:
    """The keep bits the flash kernels draw, bool [bh, rows, cols] on
    `device` (a CUDA device), its heads placed in the step by `placement`:
    `ops.dropout.exported_mask` of this library."""
    return exported_mask(_build.load("flash_attention", _SIGNATURES), bh,
                         rows, cols, rate, seed, offset, device, placement)


def _bshd_empty(b: int, s: int, h: int, d: int, like: torch.Tensor,
                parts: int = 1) -> torch.Tensor:
    """An empty [parts, B, H, S, D] view of [B, S, parts, H, D] storage."""
    t = torch.empty((b, s, parts, h, d), dtype=like.dtype, device=like.device)
    return t.permute(2, 0, 3, 1, 4)


def _fwd(name: str, q, k, v, causal: bool, scale: Optional[float],
         drop: Optional[AttentionDropout]):
    _no_graph(name, q, k, v)
    d = _check(name, q, k, v)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, _keep(drop, q, k))
    b, h, sq, _ = q.shape
    out = _bshd_empty(b, sq, h, d, q)[0]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("mct_flash_fwd", q, k,
            [*_view(q), *_view(k), *_view(v), *_view(out), lse.data_ptr()],
            causal, scale, drop)
    return out, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, Sq, D] in q's dtype, a view of [B, Sq, H, D] storage;
    lse [B, H, Sq] fp32). `scale` defaults to D**-0.5."""
    out = _fwd("flash_fwd", q, k, v, causal, scale, None)
    if q.device.type == "cuda":
        flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_fwd_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      drop: AttentionDropout, *, causal: bool = False,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_fwd` with attention-probability dropout `drop`."""
    out = _fwd("flash_fwd_dropout", q, k, v, causal, scale, drop)
    if q.device.type == "cuda":
        flash_fwd_dropout.launches += 1
    return out


flash_fwd_dropout.launches = 0


def _grad_buffers(q, k):
    """dq [B, H, Sq, D] and dk, dv [B, H, Sk, D]: views of one packed
    [B, S, 3, H, D] buffer when Sq == Sk (the packed projection's gradient),
    else of [B, Sq, H, D] and [B, Sk, 2, H, D]. Returns (dq, dk, dv,
    packed or None)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sq == sk:
        buf = _bshd_empty(b, sq, h, d, q, parts=3)
        return buf[0], buf[1], buf[2], buf.permute(1, 3, 0, 2, 4)
    dkv = _bshd_empty(b, sk, h, d, q, parts=2)
    return _bshd_empty(b, sq, h, d, q)[0], dkv[0], dkv[1], None


def _bwd_fused(name, q, k, v, out, lse, do, causal, scale, grads, drop):
    _no_graph(name, q, k, v, out, lse, do)
    d = _check(name, q, k, v, out, do)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, out, lse, do, scale, causal,
                                     _keep(drop, q, k))
    b, h, sq, _ = q.shape
    dq, dk, dv = grads or _grad_buffers(q, k)[:3]
    delta = flash_delta(do, out)
    dq_acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    _launch("mct_flash_bwd_fused", q, k,
            [*_view(q), *_view(k), *_view(v), *_view(do),
             _rows(lse, "lse").data_ptr(), delta.data_ptr(), *_view(dk),
             *_view(dv), dq_acc.data_ptr()], causal, scale, drop)
    dq.copy_(dq_acc.transpose(1, 2))
    return dq, dk, dv


def flash_bwd_fused(q, k, v, out, lse, do, *, causal: bool = False,
                    scale: Optional[float] = None, grads=None):
    """(dQ, dK, dV) in q's dtype from the forward's out and lse, in one
    launch (`_bwd_fused_kernel`). `grads`: (dq, dk, dv) views to write
    into, else `_grad_buffers`. The kernel adds dQ into a zeroed fp32
    buffer with atomics, rounded into dq after it."""
    res = _bwd_fused("flash_bwd_fused", q, k, v, out, lse, do, causal, scale,
                     grads, None)
    if q.device.type == "cuda":
        flash_bwd_fused.launches += 1
    return res


flash_bwd_fused.launches = 0


def flash_bwd_fused_dropout(q, k, v, out, lse, do, drop: AttentionDropout, *,
                            causal: bool = False,
                            scale: Optional[float] = None, grads=None):
    """`flash_bwd_fused` of the forward that dropped with `drop`."""
    res = _bwd_fused("flash_bwd_fused_dropout", q, k, v, out, lse, do, causal,
                     scale, grads, drop)
    if q.device.type == "cuda":
        flash_bwd_fused_dropout.launches += 1
    return res


flash_bwd_fused_dropout.launches = 0


def _bwd_dq(name, q, k, v, do, lse, delta, causal, scale, dq, drop):
    _no_graph(name, q, k, v, do, lse, delta)
    d = _check(name, q, k, v, do)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal,
                                  _keep(drop, q, k))
    if dq is None:
        b, h, sq, _ = q.shape
        dq = _bshd_empty(b, sq, h, d, q)[0]
    _launch("mct_flash_bwd_dq", q, k,
            [*_view(q), *_view(k), *_view(v), *_view(do),
             _rows(lse, "lse").data_ptr(), _rows(delta, "delta").data_ptr(),
             *_view(dq)], causal, scale, drop)
    return dq


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                 scale: Optional[float] = None, dq=None) -> torch.Tensor:
    """dQ in q's dtype (`_bwd_dq_kernel`), written into `dq` when given."""
    dq = _bwd_dq("flash_bwd_dq", q, k, v, do, lse, delta, causal, scale, dq,
                 None)
    if q.device.type == "cuda":
        flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dq_dropout(q, k, v, do, lse, delta, drop: AttentionDropout, *,
                         causal: bool = False, scale: Optional[float] = None,
                         dq=None) -> torch.Tensor:
    """`flash_bwd_dq` of the forward that dropped with `drop`."""
    dq = _bwd_dq("flash_bwd_dq_dropout", q, k, v, do, lse, delta, causal,
                 scale, dq, drop)
    if q.device.type == "cuda":
        flash_bwd_dq_dropout.launches += 1
    return dq


flash_bwd_dq_dropout.launches = 0


def _bwd_dkv(name, q, k, v, do, lse, delta, causal, scale, dk, dv, drop):
    _no_graph(name, q, k, v, do, lse, delta)
    d = _check(name, q, k, v, do)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                   _keep(drop, q, k))
    if dk is None:
        b, h, sk, _ = k.shape
        dkv = _bshd_empty(b, sk, h, d, q, parts=2)
        dk, dv = dkv[0], dkv[1]
    _launch("mct_flash_bwd_dkv", q, k,
            [*_view(q), *_view(k), *_view(v), *_view(do),
             _rows(lse, "lse").data_ptr(), _rows(delta, "delta").data_ptr(),
             *_view(dk), *_view(dv)], causal, scale, drop)
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                  scale: Optional[float] = None, dk=None, dv=None):
    """(dK, dV) in q's dtype (`_bwd_dkv_kernel`), written into `dk`, `dv`
    when given."""
    res = _bwd_dkv("flash_bwd_dkv", q, k, v, do, lse, delta, causal, scale,
                   dk, dv, None)
    if q.device.type == "cuda":
        flash_bwd_dkv.launches += 1
    return res


flash_bwd_dkv.launches = 0


def flash_bwd_dkv_dropout(q, k, v, do, lse, delta, drop: AttentionDropout, *,
                          causal: bool = False, scale: Optional[float] = None,
                          dk=None, dv=None):
    """`flash_bwd_dkv` of the forward that dropped with `drop`."""
    res = _bwd_dkv("flash_bwd_dkv_dropout", q, k, v, do, lse, delta, causal,
                   scale, dk, dv, drop)
    if q.device.type == "cuda":
        flash_bwd_dkv_dropout.launches += 1
    return res


flash_bwd_dkv_dropout.launches = 0


def flash_bwd(q, k, v, out, lse, do, *, causal: bool, scale: float,
              drop: Optional[AttentionDropout] = None):
    """The backward the JAX package runs at this key length: fused, or the
    split dQ and dKV kernels; with `drop` their dropout twins. Returns (dq,
    dk, dv, packed [B, S, 3, H, D] or None), see `_grad_buffers`."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    cpu = q.device.type == "cpu"
    dq, dk, dv, packed = (None,) * 4 if cpu else _grad_buffers(q, k)
    kw = dict(causal=causal, scale=scale)
    dargs = () if drop is None else (drop,)
    if uses_fused_bwd(k.shape[2]):
        fused = flash_bwd_fused if drop is None else flash_bwd_fused_dropout
        dq, dk, dv = fused(q, k, v, out, lse, do, *dargs,
                           grads=None if cpu else (dq, dk, dv), **kw)
    else:
        delta = flash_delta(do, out)
        bwd_dq, bwd_dkv = ((flash_bwd_dq, flash_bwd_dkv) if drop is None else
                           (flash_bwd_dq_dropout, flash_bwd_dkv_dropout))
        dq = bwd_dq(q, k, v, do, lse, delta, *dargs, dq=dq, **kw)
        dk, dv = bwd_dkv(q, k, v, do, lse, delta, *dargs, dk=dk, dv=dv, **kw)
    return dq, dk, dv, packed


def _fwd_any(q, k, v, causal, scale, drop):
    if drop is None:
        return flash_fwd(q, k, v, causal=causal, scale=scale)
    return flash_fwd_dropout(q, k, v, drop, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """The JAX custom_vjp's `_flash_fwd_rule` / `_flash_bwd_rule`: saves
    (q, k, v, out, lse); the dropout's (rate, seed, offset) ride along as
    plain values, as the JAX rule keeps its seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, drop):
        out, lse = _fwd_any(q, k, v, causal, scale, drop)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.drop = causal, scale, drop
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv, _ = flash_bwd(*ctx.saved_tensors, do, causal=ctx.causal,
                                  scale=ctx.scale, drop=ctx.drop)
        return dq, dk, dv, None, None, None


def _qkv_heads(qkv: torch.Tensor, heads: int):
    """[B, S, 3*H*D] -> q, k, v [B, H, S, D] views, no copy."""
    b, s, w3 = qkv.shape
    if w3 % (3 * heads):
        raise ValueError(f"last dim {w3} is not 3*heads*D for heads={heads}")
    return qkv.unflatten(-1, (3, heads, w3 // (3 * heads))).permute(
        2, 0, 3, 1, 4).unbind(0)


class FlashAttentionQKV(torch.autograd.Function):
    """Flash attention off the packed projection: the gradient is the
    packed dqkv buffer the backward kernels write, with no split or
    concatenation."""

    @staticmethod
    def forward(ctx, qkv, heads: int, causal: bool, drop):
        q, k, v = _qkv_heads(qkv, heads)
        out, lse = _fwd_any(q, k, v, causal, None, drop)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.causal, ctx.drop = heads, causal, drop
        return out.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = _qkv_heads(qkv, ctx.heads)
        do = g.reshape(out.shape[0], out.shape[2], out.shape[1],
                       out.shape[3]).transpose(1, 2)
        dq, dk, dv, packed = flash_bwd(q, k, v, out, lse, do,
                                       causal=ctx.causal,
                                       scale=q.shape[-1] ** -0.5,
                                       drop=ctx.drop)
        if packed is None:  # the plain versions (CPU)
            packed = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
        return packed.reshape(qkv.shape), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    offset: int = 0) -> torch.Tensor:
    """q [B, H, Sq, D], k, v [B, H, Sk, D] -> [B, H, Sq, D] (a view of
    [B, Sq, H, D] storage); differentiable. `scale` defaults to D**-0.5.
    `dropout_rate` > 0 with a `seed` drops attention probabilities in the
    kernels (mask of (seed, offset), see `ops/dropout.py`); rate 0 or no
    seed runs the kernels without dropout."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    drop = attention_dropout(dropout_rate, seed, offset, q.shape[1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale, drop)
    return _fwd_any(q, k, v, causal, scale, drop)[0]


def flash_attention_qkv(qkv: torch.Tensor, heads: int, *,
                        causal: bool = False, dropout_rate: float = 0.0,
                        seed: Optional[int] = None,
                        offset: int = 0) -> torch.Tensor:
    """[B, S, 3*H*D] packed projection -> [B, S, H*D], scores scaled by
    D**-0.5; differentiable, its gradient the packed dqkv. Dropout as
    `flash_attention`."""
    drop = attention_dropout(dropout_rate, seed, offset, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionQKV.apply(qkv, heads, causal, drop)
    q, k, v = _qkv_heads(qkv, heads)
    out = _fwd_any(q, k, v, causal, None, drop)[0]
    return out.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)
