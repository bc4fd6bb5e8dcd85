"""The wgmma tile check of `csrc/sm90.cuh`, the Hopper building blocks of the
fused CE backward (`csrc/fused_ce.cu`), the fused flash backward
(`csrc/flash_attention.cu`) and the attention forwards
(`csrc/attn_fwd_sm90.cuh`, in `flash_attention.cu` and `fused_mha.cu`).

Each library that includes the header exports `mct_sm90_tile_check`: one
warpgroup's C[64, N] = A[64, 64] B[64, N] in bf16 with fp32 accumulation,
N = 64 or 128, four k-steps of wgmma m64nNk16, for one operand layout: A
K-major ([M, K] storage) or MN-major ([K, M]), or A from registers; B
K-major ([N, K]) or MN-major ([K, N], N / 64 panels of 64 columns); the
tiles loaded into shared memory by TMA or by the threads' own swizzled
stores. `tile_product` runs it; `LAYOUTS` are the layouts the kernels use.
`tile_product_plain` is the product it must give, in fp32 from the same
bf16 values. A wrong descriptor or swizzle moves whole rows or columns, so
an error shows at once against the plain product, apart from any kernel.
"""
import ctypes

import torch

from megatron_clip_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"mct_sm90_tile_check": ([_P, _P, _P, _I, _I, _I, _I, _I, _P],
                                      _I)}
LIBRARIES = ("fused_ce", "flash_attention", "fused_mha")
# (A MN-major, B MN-major, A from registers, N): at N = 128 the fused CE's
# dlogits (K, K), dX (K, MN) and dW (MN, MN) products; the flash backward's
# S^T and dP^T (K, K), dV and dK (registers, MN) and dQ (MN, MN); the
# attention forwards' S = Q K^T (K, K) and, at D = 128, O += P V
# (registers, MN); and the rest. At N = 64: the forwards' O += P V at
# D = 64 (registers, MN).
LAYOUTS = tuple((ta, tb, regs, 128) for regs in (0, 1) for ta in (0, 1)
                for tb in (0, 1) if not (regs and ta)) + ((0, 1, 1, 64),)


def tile_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A [64, 64] . B [64, N] in fp32 from bf16 values."""
    return a.float() @ b.float()


def tile_product(library: str, a: torch.Tensor, b: torch.Tensor, *,
                 ta: int, tb: int, a_regs: int, via_tma: int
                 ) -> torch.Tensor:
    """The library's wgmma product of a [64, 64] and b [64, N], N = 64 or
    128 (bf16 on the card), in the layout (ta, tb, a_regs), the operands
    staged by TMA or by the threads (via_tma); fp32 [64, N]."""
    n = b.shape[1] if b.dim() == 2 else 0
    if a.shape != (64, 64) or b.shape != (64, n) or n not in (64, 128) or \
            a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            a.device.type != "cuda" or b.device != a.device:
        raise ValueError("tile_product: bf16 a [64, 64] and b [64, 64 or "
                         "128] on one CUDA device expected")
    if a_regs and ta:
        raise ValueError("tile_product: A from registers is K-major")
    a_st = (a.t() if ta else a).contiguous()
    b_st = (b if tb else b.t()).contiguous()
    c = torch.empty(64, n, dtype=torch.float32, device=a.device)
    lib = _build.load(library, SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.mct_sm90_tile_check(a_st.data_ptr(), b_st.data_ptr(),
                                     c.data_ptr(), n, ta, tb, a_regs,
                                     via_tma, stream)
    if rc != 0:
        raise RuntimeError(f"mct_sm90_tile_check ({library}): launch failed "
                           f"(cudaError {rc})")
    return c
