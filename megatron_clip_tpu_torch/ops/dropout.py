"""The port's one dropout random stream: Philox4x32-10, and the seeds that
feed it.

Counterpart of the JAX package's dropout randomness: `jax.random` keys for
the hidden and embedding dropout (`nn/transformer.py::dropout`) and the
fused-MHA mask (`ops/pallas/fused_mha.py::_dropout_mask`), and the TPU's
on-core PRNG for flash attention (`ops/pallas/flash_attention.py::
_drop_keep`). None of those streams can be reproduced here, so the port
draws its own, and the tests feed both packages the same mask.

The attention mask. Every attention kernel (`csrc/philox.cuh`) and the
plain versions draw the keep bit of score (row, col) of head `bh` from one
Philox4x32-10 call:

    key     = (seed & 0xffffffff, seed >> 32)
    counter = (col >> 1, row & ~8, bh, offset)
    word    = (col & 1) | ((row >> 3) & 1) << 1
    keep    = philox4x32_10(counter, key)[word] < threshold(rate)

with threshold(rate) = min(floor((1 - rate) 2^32), 2^32 - 1), the
threshold of the TPU kernel's `_drop_keep`. The bits are a function of the
global indices alone, never of a tile, so kernels tiled differently (the
forward and the backward, the fused and the flash route) and the plain
versions, which have no tiles, draw the same mask. One call's four words
are the 2 x 2 block rows {r, r + 8} x columns {c, c + 1} (r with bit 3
clear, c even): the four values a thread holds of an m16n8 tensor-core
accumulator, so a forward kernel spends one call on four scores. `seed`
separates the steps (`fold_in`), `offset` the layers and sites
(`site_offset`).

Over the ranks of a parallel layout every rank draws the bits the one
process draws for its piece of the step: a data-parallel rank holds rows
of the batch, a tensor-parallel rank heads of each row, and its kernels
number their heads bh from 0. `RankSeed` carries the rank's place (its
first row, its first head); the launch's `AttentionDropout` then maps its
bh to the step's, bh_base + (bh / bh_heads) bh_stride + bh % bh_heads
(`Dropout::step_head` in `csrc/philox.cuh`), so that every score keeps the bit
it keeps in one process at the same microbatches.

Hidden and embedding dropout (`dropout`) stay plain PyTorch, as the JAX
package's are jnp ops: a keep mask from `torch.rand` on a generator of the
tensor's device seeded from (seed, offset), then x / (1 - rate) in x's
dtype where kept, 1 - rate rounded to x's dtype first, as the JAX package's
weakly typed divisor is. The generator replays the same bits under activation
recompute, because the seed is an input. The CPU's and the card's
generators draw different streams, so this mask differs between the two
devices (the card-against-CPU checks run at hidden_dropout 0). Drawing it
with the Philox stream above in plain PyTorch would cost some 40 passes
over a [B, S, W] int64 tensor per site, which is fine for tests and too
slow for a train step; a kernel for it is not part of the port (the JAX
package has none). Over a parallel layout (`RankSeed`) the generator's
seed is folded with the rank's data index (its rows), and where the
activation is a rank's own piece (sequence parallelism's rows, the
embedding's slice, the heads of the unfused attention) with its
tensor-parallel index too: masks differ between ranks that hold different
elements and agree where the tensor-parallel ranks hold the same
activation whole. They are not the one process's mask, which a rank could
only cut from a draw of the whole [B, S, W] (ROADMAP, deviations kept on
purpose).
"""
import ctypes
from typing import NamedTuple, Optional, Union

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57    # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85    # Weyl key increments
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for x in [0, 2^32) as int64, in
    16-bit pieces so that nothing overflows int64."""
    a = m * (x & 0xFFFF)
    c = (a >> 16) + m * (x >> 16)
    return c >> 16, ((c & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values: `counter` four
    broadcastable tensors, `key` two ints. Returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """The uint32 threshold below which a draw keeps its element (the TPU
    kernel's `_drop_keep`)."""
    return min(int((1.0 - rate) * 2 ** 32), 2 ** 32 - 1)


def _as_index(x, device) -> torch.Tensor:
    if isinstance(x, range):
        return torch.arange(x.start, x.stop, x.step, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def philox_keep(seed: int, offset: int, bh, rows, cols, rate: float,
                device: Union[str, torch.device, None] = None
                ) -> torch.Tensor:
    """The attention keep mask the kernels draw (see the module's note):
    bool [*bh.shape, len(rows), len(cols)] for heads `bh` (an int or a 1-D
    index tensor of flattened batch * heads), query rows `rows` and key
    columns `cols` (ranges or 1-D index tensors)."""
    rows = _as_index(rows, device)[:, None]
    cols = _as_index(cols, device)[None, :]
    bh = _as_index(bh, device)
    bh = bh.reshape(*bh.shape, 1, 1)
    seed &= _MASK64
    words = philox4x32_10(
        (cols >> 1, rows & ~8, bh, torch.tensor(offset & _MASK32,
                                                device=rows.device)),
        (seed & _MASK32, seed >> 32))
    word = (cols & 1) | (((rows >> 3) & 1) << 1)
    bits = torch.where(word == 0, words[0], words[1])
    bits = torch.where(word == 2, words[2], bits)
    bits = torch.where(word == 3, words[3], bits)
    return bits < keep_threshold(rate)


def step_heads(bh, bh_base: int, bh_heads: int, bh_stride: int):
    """The step's head of a launch's head `bh` (an int or an index
    tensor): bh_base + (bh / bh_heads) bh_stride + bh % bh_heads, or
    bh_base + bh where bh_heads == bh_stride (a whole row's heads, or 0:
    the launch is the whole step). `Dropout::step_head` of csrc/philox.cuh."""
    if bh_heads == bh_stride:
        return bh_base + bh
    return bh_base + bh // bh_heads * bh_stride + bh % bh_heads


class AttentionDropout(NamedTuple):
    """The dropout of one attention call: its rate, the step's seed, the
    site's offset and where the launch's heads lie in the step (see the
    module's note; 0, 0, 0 for a launch of the whole step)."""
    rate: float
    seed: int
    offset: int
    bh_base: int = 0
    bh_heads: int = 0
    bh_stride: int = 0

    def multipliers(self, b: int, h: int, sq: int, sk: int, mult: float,
                    device=None) -> torch.Tensor:
        """fp32 [B, H, Sq, Sk]: `mult` where `philox_keep` keeps, 0
        elsewhere; the explicit mask the attention's plain versions take.
        Drawn a head at a time, so that its int64 temporaries stay at one
        [Sq, Sk] plane."""
        out = torch.empty(b * h, sq, sk, dtype=torch.float32, device=device)
        for i in range(b * h):
            out[i] = philox_keep(self.seed, self.offset, self.head(i),
                                 range(sq), range(sk), self.rate,
                                 device).float() * mult
        return out.reshape(b, h, sq, sk)

    def head(self, bh):
        """The step's head of the launch's head `bh` (`step_heads`)."""
        return step_heads(bh, self.bh_base, self.bh_heads, self.bh_stride)

    def c_args(self, mult: float) -> list:
        """(drop, seed, offset, threshold, mult, bh_base, bh_heads,
        bh_stride), the kernels' C arguments."""
        return [1, self.seed & _MASK64, self.offset & _MASK32,
                keep_threshold(self.rate), float(mult), self.bh_base,
                self.bh_heads, self.bh_stride]


# the C arguments of a launch without dropout
NO_DROPOUT_C_ARGS = [0, 0, 0, 0, 0.0, 0, 0, 0]
# their ctypes: drop, seed, offset, threshold, mult, bh_base, bh_heads,
# bh_stride
C_ARGTYPES = [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint,
              ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]


# mct_dropout_mask's ctypes signature (each kernel library exports it)
MASK_SIGNATURE = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p], ctypes.c_int)


def exported_mask(lib, bh: int, rows: int, cols: int, rate: float,
                  seed: int, offset: int, device,
                  placement=(0, 0, 0)) -> torch.Tensor:
    """The keep bits a kernel library draws, bool [bh, rows, cols], written
    by its `mct_dropout_mask` on `device` (a CUDA device): the card's side
    of the check against `philox_keep`. `placement`: (bh_base, bh_heads,
    bh_stride), where the heads lie in the step (`step_heads`)."""
    keep = torch.empty((bh, rows, cols), dtype=torch.uint8, device=device)
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        rc = lib.mct_dropout_mask(keep.data_ptr(), bh, rows, cols,
                                  seed & _MASK64, offset & _MASK32,
                                  keep_threshold(rate), *placement, stream)
    if rc != 0:
        raise RuntimeError(f"mct_dropout_mask: launch failed (cudaError {rc})")
    return keep.bool()


class RankSeed(int):
    """A step's (or microbatch's) dropout seed on one rank of a parallel
    layout: the int is the seed every rank shares, the attention mask's
    Philox key; the attributes place the rank in the step.
    - `row_base`: the first of the rank's rows in the step's batch (a
      microbatch's, under accumulation; the rows are consecutive);
    - `tp`, `tp_rank`: the tensor-parallel ranks and this rank's, which
      holds heads [tp_rank H/tp, (tp_rank + 1) H/tp) of each row;
    - `replicated`: the hidden-dropout seed of an activation the
      tensor-parallel ranks hold whole, folded with the rank's data index
      `batch_rank` (the same on its tensor-parallel ranks);
    - `sharded`: that of an activation each rank holds a piece of (rows
      of the sequence, heads), folded with `tp_rank` too."""

    def __new__(cls, seed: int, *, row_base: int, tp: int, tp_rank: int,
                batch_rank: int):
        self = super().__new__(cls, seed)
        self.row_base, self.tp, self.tp_rank = row_base, tp, tp_rank
        self.replicated = fold_in(seed, batch_rank)
        self.sharded = (self.replicated if tp == 1
                        else fold_in(self.replicated, tp_rank))
        return self


def hidden_seed(seed, sharded: bool = True) -> int:
    """The generator seed of a hidden-dropout site of `seed`: the seed
    itself in one process, a `RankSeed`'s `sharded` or `replicated` fold
    over a layout."""
    if isinstance(seed, RankSeed):
        return seed.sharded if sharded else seed.replicated
    return seed


def attention_dropout(rate: float, seed: Optional[int], offset: int,
                      heads: int = 0) -> Optional[AttentionDropout]:
    """The dropout of an attention call over `heads` heads a row, or None
    when it drops nothing (rate 0, or no seed: eval). A rate above 0 with
    no seed is eval, as the JAX package's `rng=None`. A `RankSeed` places
    the launch's heads in the step."""
    if rate < 0.0 or rate >= 1.0:
        raise ValueError(f"attention dropout rate {rate} outside [0, 1)")
    if rate == 0.0 or seed is None:
        return None
    if not isinstance(seed, RankSeed):
        return AttentionDropout(float(rate), int(seed), int(offset))
    stride = heads * seed.tp
    return AttentionDropout(float(rate), int(seed), int(offset),
                            seed.row_base * stride + seed.tp_rank * heads,
                            heads, stride)


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from `seed` and `data` on the host, as plain
    ints (`jax.random.fold_in`'s role: one seed per step from a base seed
    and the step index)."""
    return _mix64((_mix64(seed & _MASK64) + (data & _MASK64)
                   + 0x9E3779B97F4A7C15) & _MASK64)


# the sites of one layer: attention probabilities, hidden dropout after the
# attention and after the MLP; offset 0 is the embedding dropout
SITES_PER_LAYER = 3


def site_offset(layer: int, site: int) -> int:
    """The offset of dropout site `site` (0: attention, 1: hidden after
    attention, 2: hidden after the MLP) of layer `layer`."""
    return 1 + SITES_PER_LAYER * layer + site


EMBED_OFFSET = 0


def dropout_keep_with(x: torch.Tensor, keep: torch.Tensor,
                      rate: float) -> torch.Tensor:
    """x / (1 - rate) where `keep`, else 0: the JAX package's `dropout`
    given its keep mask. As there, 1 - rate is first rounded to x's dtype
    (a weakly typed Python float; 0.8984375 in bf16 at rate 0.1), and the
    quotient to x's dtype."""
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def hidden_keep(shape, rate: float, seed: int, offset: int,
                device) -> torch.Tensor:
    """The hidden-dropout keep mask of (seed, offset) on `device`: bool,
    uniform draws of a generator of that device seeded from both."""
    gen = torch.Generator(device=device).manual_seed(
        fold_in(seed, offset) & ((1 << 63) - 1))
    return torch.rand(shape, generator=gen, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, seed, offset: int = 0, *,
            sharded: bool = True) -> torch.Tensor:
    """Inverted dropout of hidden states (`nn/transformer.py::dropout`):
    x unchanged when rate is 0 or seed is None, else `dropout_keep_with`
    the mask of `hidden_keep`. `sharded`: whether x is this rank's own
    piece of the activation, or one the tensor-parallel ranks hold whole
    (`hidden_seed`)."""
    if rate == 0.0 or seed is None:
        return x
    return dropout_keep_with(x, hidden_keep(
        x.shape, rate, hidden_seed(seed, sharded), offset, x.device), rate)
