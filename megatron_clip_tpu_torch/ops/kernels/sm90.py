"""The wgmma tile check of `csrc/sm90.cuh`, the Hopper building blocks of the
fused CE forward and backward (`csrc/fused_ce.cu`), the fused flash
backward (`csrc/flash_attention.cu`), the attention forwards
(`csrc/attn_fwd_sm90.cuh`, in `flash_attention.cu` and `fused_mha.cu`) and
the fused-MHA backwards past S = 128, recomputing P or from saved P
(`csrc/attn_bwd_sm90.cuh`, in `fused_mha.cu`).

Each library that includes the header exports `mct_sm90_tile_check`: one
warpgroup's C[64, N] = A[64, K] B[K, N] in bf16 with fp32 accumulation,
(N, K) in SHAPES, K / 16 k-steps of wgmma m64nNk16, for one operand layout:
A K-major ([M, K] storage) or MN-major ([K, M]), or A from registers
(N <= 128); B K-major ([N, K]) or MN-major ([K, N], N / 64 panels of 64
columns); the tiles loaded into shared memory by TMA or by the threads' own
swizzled stores. A width of 80 (ViT-H/14's head) is a 64-column panel under
the 128-byte swizzle and a 16-column one under the 32-byte swizzle: at
K = 80 the fifth k-step reads the 16-column panels (K-major), at N = 80
each k-step is an n64 and an n16 product (B MN-major only).
`tile_product` runs it; `LAYOUTS` are the layouts and shapes the kernels
use. `tile_product_plain` is the product it must give, in fp32 from the
same bf16 values. A wrong descriptor or swizzle moves whole rows or
columns, so an error shows at once against the plain product, apart from
any kernel.
"""
import ctypes

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"mct_sm90_tile_check": ([_P, _P, _P] + [_I] * 6 + [_P], _I)}
LIBRARIES = ("fused_ce", "flash_attention", "fused_mha")
# (A MN-major, B MN-major, A from registers, N, K). At N = 128, K = 64:
# the fused CE backward's dlogits (K, K), dX (K, MN) and dW (MN, MN)
# products in their 64-deep ring stages; the flash backward's S^T and dP^T
# (K, K), dV and dK (registers, MN) and dQ (MN, MN); the attention
# forwards' S = Q K^T (K, K) and, at D = 128, O += P V (registers, MN); the
# recompute backward's dQ += dS K at D = 128 (registers, MN) and dV, dK at
# D = 128 (registers, MN). At N = 64, K = 64: the forwards' O += P V at
# D = 64, the recompute backward's dV, dK at D = 64 (registers, MN), and
# its S, dP (part 1 at D = 128) and S^T, dP^T (part 2), 64 wide (K, K). At
# N = 64, K = 128: the recompute backward's dQ += dS K at D = 64 over
# 128-key tiles (registers, MN). At N = 256, K = 64: the fused CE forward's
# logits (K, K) and the backward's three products at their own width. At
# D = 80: the fused forward's S = Q K^T and the recompute backward's S, dP
# over 128-key tiles (N = 128, K = 80; K, K), part 2's S^T, dP^T (N = 64,
# K = 80; K, K), the forward's O += P V and part 1's dQ += dS K (N = 80,
# K = 128; registers, MN), part 2's dV, dK (N = 80, K = 64; registers, MN)
# and the same with A from shared memory (K, MN). The saved-P backward's
# part 2 dV += P^T dO, A the P tile read MN-major (N = D = 64, 80, 128,
# K = 64; MN, MN).
LAYOUTS = tuple((ta, tb, regs, 128, 64) for regs in (0, 1) for ta in (0, 1)
                for tb in (0, 1) if not (regs and ta)) + (
    (0, 1, 1, 64, 64), (0, 0, 0, 64, 64), (0, 1, 1, 64, 128),
    (0, 0, 0, 256, 64), (0, 1, 0, 256, 64), (1, 1, 0, 256, 64),
    (0, 0, 0, 128, 80), (0, 0, 0, 64, 80), (0, 1, 1, 80, 128),
    (0, 1, 1, 80, 64), (0, 1, 0, 80, 64), (1, 1, 0, 64, 64),
    (1, 1, 0, 80, 64))
SHAPES = ((64, 64), (128, 64), (256, 64), (64, 128), (128, 128), (128, 80),
          (64, 80), (80, 128), (80, 64))


def tile_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A [64, K] . B [K, N] in fp32 from bf16 values."""
    return a.float() @ b.float()


def tile_product(library: str, a: torch.Tensor, b: torch.Tensor, *,
                 ta: int, tb: int, a_regs: int, via_tma: int
                 ) -> torch.Tensor:
    """The library's wgmma product of a [64, K] and b [K, N], (N, K) in
    SHAPES (bf16 on the card), in the layout (ta, tb, a_regs), the operands
    staged by TMA or by the threads (via_tma); fp32 [64, N]."""
    k = a.shape[1] if a.dim() == 2 else 0
    n = b.shape[1] if b.dim() == 2 else 0
    if a.shape != (64, k) or b.shape != (k, n) or (n, k) not in SHAPES or \
            a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            a.device.type != "cuda" or b.device != a.device:
        raise ValueError("tile_product: bf16 a [64, K] and b [K, N] with "
                         f"(N, K) in {SHAPES} on one CUDA device expected")
    if a_regs and (ta or n > 128):
        raise ValueError("tile_product: A from registers is K-major, N <= "
                         "128")
    if n == 80 and not tb:
        raise ValueError("tile_product: B at N = 80 is MN-major")
    a_st = (a.t() if ta else a).contiguous()
    b_st = (b if tb else b.t()).contiguous()
    c = torch.empty(64, n, dtype=torch.float32, device=a.device)
    lib = _build.load(library, SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.mct_sm90_tile_check(a_st.data_ptr(), b_st.data_ptr(),
                                     c.data_ptr(), n, k, ta, tb, a_regs,
                                     via_tma, stream)
    if rc != 0:
        raise RuntimeError(f"mct_sm90_tile_check ({library}): launch failed "
                           f"(cudaError {rc})")
    return c
