"""Fused lm-head + softmax cross entropy: the CUDA kernels' wrappers, their
plain versions and the autograd Function that joins them.

Counterpart of `megatron_clip_tpu/ops/pallas/fused_ce.py::
fused_linear_cross_entropy`: its forward kernel (`_fwd_kernel`) and its
backward kernels (`_dx_kernel`, `_dw_kernel`), in `csrc/fused_ce.cu`. In
bf16 with 16-byte rows the backward runs on wgmma as three products per
chunk of `CHUNK_TOKENS` tokens (dlogits into a bf16 scratch, dX, dW summed
across the chunks in fp32; `bwd_plan`), else as one CUDA-core kernel.
`fused_ce_fwd` and `fused_ce_bwd` take the plain version for a CPU tensor;
for a CUDA tensor they launch the kernels or raise, each counting one
launch per call. `fused_linear_cross_entropy` is what `gpt_loss` calls.

Arithmetic (plain versions and kernels alike, as the TPU kernels): logits
x . w in fp32 from operands in x's dtype; lse = m + log(max(l, 1e-30));
loss = lse - logit[label] (a label outside [0, V) picks no logit);
dlogits = (softmax - onehot) * dloss rounded to x's dtype before both
contractions; dX = dlogits . w^T and dW = x^T . dlogits summed in fp32 and
rounded once, to x's and w's dtype. The plain versions walk the tokens in
chunks of `PLAIN_CHUNK`, so that as the kernels' oracle on the card they
hold one [chunk, V] fp32 slab at a time, never [T, V].

Layout. The kernels read the head as vocabulary rows, wt = w^T [V, W]
row-major. The tied head is the embedding [V, W] itself (`w` is its
transposed view, read in place); an untied `lm_head` [W, V] is copied
transposed once per call (V W elements). dW is written in that [V, W]
layout and returned as its [W, V] view.

The wgmma backward gives the same bits every run (each output tile has one
owner, the chunks are summed in token order); the CUDA-core kernel adds
its partial products into fp32 buffers with atomics, so there dX's and
dW's last fp32 bits change from run to run before their rounding (ROADMAP
Queue C).
"""
import ctypes
from typing import Tuple

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

PLAIN_CHUNK = 1024
PART_COLS = 64  # vocabulary columns of one forward partial (csrc/fused_ce.cu)
# the wgmma backward's chunk of tokens: its dlogits scratch is [chunk, V]
# bf16 (412 MB at V = 50304), and its dW sums cross chunks in fp32
CHUNK_TOKENS = 4096
_TILE_ROWS = 128  # the kernel's output rows per block

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, wt, labels, part, nparts, loss, lse, T, V, W, dtype, stream
    "mct_fused_ce_fwd": ([_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
                         _I),
    # x, wt, labels, lse, dloss, dx, dw, T, V, W, dtype, stream
    "mct_fused_ce_bwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                         _I),
    # x, wt, labels, lse, dloss, dx, dw, dw_acc, dl, dl_rows, dl_pitch, T, V,
    # W, stream
    "mct_fused_ce_bwd_sm90": ([_P] * 9 + [_I] * 5 + [_P], _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------- plain versions --------------------------------

def _chunks(t: int):
    return range(0, t, PLAIN_CHUNK)


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    v = logits.shape[1]
    ok = (labels >= 0) & (labels < v)
    got = logits.gather(1, labels.clamp(0, v - 1).long()[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros_like(got))


def fused_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [T], lse [T]) fp32 for x [T, W], w [W, V], labels [T]: the TPU
    forward's arithmetic over one block of every vocabulary column."""
    wf = w.to(x.dtype).float()
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    for i in _chunks(x.shape[0]):
        logits = x[i:i + PLAIN_CHUNK].float() @ wf
        m = logits.amax(1)
        l = torch.exp(logits - m[:, None]).sum(1)
        lse[i:i + PLAIN_CHUNK] = m + torch.log(torch.clamp(l, min=1e-30))
        loss[i:i + PLAIN_CHUNK] = lse[i:i + PLAIN_CHUNK] - _label_logit(
            logits, labels[i:i + PLAIN_CHUNK])
    return loss, lse


def fused_ce_dlogits_plain(x: torch.Tensor, wf: torch.Tensor,
                           labels: torch.Tensor, lse: torch.Tensor,
                           dloss: torch.Tensor) -> torch.Tensor:
    """(softmax - onehot) * dloss in fp32 for one chunk of tokens, rounded
    to x's dtype (`_softmax_resid` and the cast before the contractions);
    wf is the head [W, V] in fp32."""
    logits = x.float() @ wf
    p = torch.exp(logits - lse[:, None])
    v = logits.shape[1]
    ok = (labels >= 0) & (labels < v)
    rows = torch.arange(x.shape[0], device=x.device)[ok]
    p[rows, labels[ok].long()] -= 1.0
    return (p * dloss.float()[:, None]).to(x.dtype)


def bwd_plan(t: int, v: int, chunk: int = CHUNK_TOKENS) -> Tuple[int, int]:
    """The wgmma backward's scratch for T = t tokens and V = v: (rows, the
    tokens of one chunk, a multiple of the kernel's 128-row tiles and at
    most `chunk`; pitch, V rounded up to 8 for 16-byte rows). The kernel
    walks the chunks in token order."""
    rows = min(chunk, -(-t // _TILE_ROWS) * _TILE_ROWS)
    return rows, -(-v // 8) * 8


def fused_ce_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, lse: torch.Tensor,
                       dloss: torch.Tensor, chunk: int = PLAIN_CHUNK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX [T, W] in x's dtype, dW [W, V] in w's dtype), as `_dx_kernel`
    and `_dw_kernel` from the forward's lse, in chunks of `chunk` tokens:
    each chunk's dlogits rounded to x's dtype, its dX rounded once, dW
    summed across the chunks in fp32 in token order and rounded once (the
    wgmma kernel's order at chunk = `bwd_plan`'s rows)."""
    wf = w.to(x.dtype).float()
    dx = torch.empty_like(x)
    dw = torch.zeros(wf.shape, dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        j = slice(i, i + chunk)
        dlog = fused_ce_dlogits_plain(x[j], wf, labels[j], lse[j],
                                      dloss[j]).float()
        dx[j] = (dlog @ wf.t()).to(x.dtype)
        dw += x[j].float().t() @ dlog
    return dx, dw.to(w.dtype)


# ---------------------------- kernel wrappers -------------------------------

def _no_graph(name: str, *tensors: torch.Tensor) -> None:
    # the kernels write into fresh tensors: a graph through them would be
    # cut without a word, so autograd callers go through
    # fused_linear_cross_entropy
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is not differentiable itself; call "
                           "fused_linear_cross_entropy, whose autograd "
                           "Function runs the backward kernel")


def _operands(name: str, x: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor, *rest: torch.Tensor):
    """Check the card's operands; returns (wt [V, W] contiguous in x's
    dtype, labels as contiguous int32)."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or \
            labels.shape != (x.shape[0],) or x.shape[0] == 0:
        raise ValueError(f"{name}: x [T, W], w [W, V] and labels [T] "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    for t in (x, w, labels, *rest):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: unsupported device {t.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share a dtype, float32 or "
                        f"bfloat16 (got {x.dtype}, {w.dtype})")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    for t in rest:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape != labels.shape:
            raise TypeError(f"{name}: lse and dloss must be contiguous "
                            "float32 [T]")
    wt = w.t()
    if not wt.is_contiguous():  # an untied [W, V] head: one transposed copy
        wt = wt.contiguous()
    return wt, labels.to(torch.int32).contiguous()


def _sm90_route(x: torch.Tensor, wt: torch.Tensor) -> bool:
    """The backward runs on wgmma for bf16 with 16-byte rows (the TMA's
    strides and addresses), else on the CUDA cores."""
    return x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0 and \
        x.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0


def _launch(fn: str, x: torch.Tensor, args: list) -> None:
    lib = _build.load("fused_ce", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc}) for "
                           f"T={x.shape[0]} W={x.shape[1]}")


def fused_ce_fwd(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [T], lse [T]) fp32. x [T, W] contiguous, w [W, V] in x's dtype
    (fp32 or bf16), labels [T] integer."""
    _no_graph("fused_ce_fwd", x, w)
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, w, labels)
    wt, lbl = _operands("fused_ce_fwd", x, w, labels)
    t, wd = x.shape
    v = wt.shape[0]
    nparts = -(-v // PART_COLS)
    part = torch.empty((3, nparts, t), dtype=torch.float32, device=x.device)
    loss = torch.empty(t, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _launch("mct_fused_ce_fwd", x,
            [x.data_ptr(), wt.data_ptr(), lbl.data_ptr(), part.data_ptr(),
             nparts, loss.data_ptr(), lse.data_ptr(), t, v, wd,
             _DTYPES[x.dtype]])
    fused_ce_fwd.launches += 1
    return loss, lse


fused_ce_fwd.launches = 0


def fused_ce_bwd(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, dloss: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX [T, W] in x's dtype, dW [W, V] in w's dtype) from the forward's
    lse and the loss's gradient dloss [T] fp32. dW is the [W, V] view of a
    [V, W] tensor."""
    _no_graph("fused_ce_bwd", x, w, lse, dloss)
    if x.device.type == "cpu":
        return fused_ce_bwd_plain(x, w, labels, lse, dloss)
    wt, lbl = _operands("fused_ce_bwd", x, w, labels, lse, dloss)
    t, wd = x.shape
    v = wt.shape[0]
    if _sm90_route(x, wt):
        rows, pitch = bwd_plan(t, v)
        dl = torch.empty((rows, pitch), dtype=x.dtype, device=x.device)
        dx = torch.empty_like(x)
        dwt = torch.empty((v, wd), dtype=x.dtype, device=x.device)
        acc = (torch.empty((v, wd), dtype=torch.float32, device=x.device)
               if t > rows else None)
        _launch("mct_fused_ce_bwd_sm90", x,
                [x.data_ptr(), wt.data_ptr(), lbl.data_ptr(), lse.data_ptr(),
                 dloss.data_ptr(), dx.data_ptr(), dwt.data_ptr(),
                 None if acc is None else acc.data_ptr(), dl.data_ptr(),
                 rows, pitch, t, v, wd])
        fused_ce_bwd.launches += 1
        return dx, dwt.t()
    dx = torch.zeros((t, wd), dtype=torch.float32, device=x.device)
    dwt = torch.zeros((v, wd), dtype=torch.float32, device=x.device)
    _launch("mct_fused_ce_bwd", x,
            [x.data_ptr(), wt.data_ptr(), lbl.data_ptr(), lse.data_ptr(),
             dloss.data_ptr(), dx.data_ptr(), dwt.data_ptr(), t, v, wd,
             _DTYPES[x.dtype]])
    fused_ce_bwd.launches += 1
    return dx.to(x.dtype), dwt.to(w.dtype).t()


fused_ce_bwd.launches = 0


class FusedLinearCrossEntropy(torch.autograd.Function):
    """The JAX custom_vjp's `_vjp_fwd` / `_vjp_bwd`: saves (x, w, labels,
    lse); labels take no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
        loss, lse = fused_ce_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss: torch.Tensor):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = fused_ce_bwd(x, w, labels, lse, dloss.float().contiguous())
        return dx, dw, None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """x [T, W] hidden states, w [W, V] head weights in x's dtype, labels
    [T] integer -> the per-token loss [T] fp32, without forming the [T, V]
    logits; differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return FusedLinearCrossEntropy.apply(x, w, labels)
    return fused_ce_fwd(x, w, labels)[0]
