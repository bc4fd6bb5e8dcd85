"""Corrupt JPEG data that Pillow still decodes, with warnings, through the
port's decoder (`csrc/jpeg_decode.c` via `data/decode.py::decode_image`)
against Pillow on the CPU: every case bit-equal (tolerance 0 uint8 levels)
to Pillow's decode, whole and at each draft scale, or None where Pillow
raises.

Pillow's libjpeg-turbo runs its x86-64 SIMD IDCTs, which saturate where
the C IDCTs wrap, and smooths the blocks of a progressive file whose first
AC coefficients are not all known. The rules `csrc/jpeg_decode.c` follows
were found by probing Pillow with files this test writes (`write_jpeg`, a
baseline encoder of chosen quantized coefficients, with every Huffman
symbol coded and 8- or 16-bit quantisation tables), and each rule has its
case here:

- the IDCTs (`test_idct_rules_match_pillow`, named blocks, and
  `test_extreme_coefficients_match_pillow`, seeded random blocks of
  coefficients up to 15 bits over 8- and 16-bit tables, decoded at scales
  1, 1/2, 1/4 and 1/8, and `test_blocks_at_the_c_idct_bounds_match_pillow`,
  blocks about the bounds past which the decoder leaves the C IDCTs for
  the SIMD ones);
- block smoothing: Pillow's progressive files cut after each scan
  (`test_progressive_files_cut_after_each_scan_match_pillow`), narrow and
  wide, every subsampling;
- a seeded corpus of 300 corrupted files made from the committed fixtures
  of `tests/torch_goldens/jpeg/` (`test_corrupted_fixtures_match_pillow`):
  bytes flipped, markers injected, scan data cut out, an EOI after a
  progressive file's first scans, and files of huge coefficients from the
  writer.
"""
import io
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from megatron_clip_tpu_torch.data.decode import decode_image
from megatron_clip_tpu_torch.tools import jpeg_goldens
from megatron_clip_tpu_torch.tools.jpeg_goldens import photo, scan_ends

GOLDENS = Path(__file__).parent / "torch_goldens" / "jpeg"

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# every DC category and every AC run/size, each symbol a fixed-length code
DC_SYMBOLS = list(range(16))
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 16)]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)  # a stuffed byte
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


def write_jpeg(blocks: np.ndarray, qtable, qbits: int = 8) -> bytes:
    """A baseline JPEG of quantized coefficients `blocks` [components,
    block rows, block columns, 64] (natural order, values and DC
    differences within 15 bits,
    every component 1x1 sampled and quantised by `qtable`, 64 values in
    natural order, written with `qbits` bits), its Huffman tables coding
    every DC category and AC run/size with codes of one length."""
    ncomp, by, bx, _ = blocks.shape
    out = bytearray(b"\xff\xd8")
    q = [int(x) for x in np.asarray(qtable)[ZIGZAG]]
    if qbits == 8:
        out += b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes(q)
    else:
        out += b"\xff\xdb" + struct.pack(">HB", 131, 0x10) + b"".join(
            struct.pack(">H", x) for x in q)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, by * 8,
                                     bx * 8, ncomp)
    for c in range(ncomp):
        out += bytes([c + 1, 0x11, 0])
    codes = []
    for cls, symbols, length in ((0, DC_SYMBOLS, 5), (1, AC_SYMBOLS, 8)):
        counts = [0] * 16
        counts[length - 1] = len(symbols)
        body = bytes([cls << 4]) + bytes(counts) + bytes(symbols)
        out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
        codes.append({s: (i, length) for i, s in enumerate(symbols)})
    dc_codes, ac_codes = codes
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for c in range(ncomp):
        out += bytes([c + 1, 0x00])
    out += bytes([0, 63, 0])
    bits, pred = _Bits(), [0] * ncomp

    def put_value(table, symbol, value, size):
        bits.put(*table[symbol])
        if size:
            bits.put(value if value >= 0 else value + (1 << size) - 1, size)
    for y in range(by):
        for x in range(bx):
            for c in range(ncomp):
                zz = [int(v) for v in blocks[c, y, x][ZIGZAG]]
                diff, pred[c] = zz[0] - pred[c], zz[0]
                put_value(dc_codes, _category(diff), diff, _category(diff))
                last = max([k for k in range(1, 64) if zz[k]] or [0])
                run = 0
                for k in range(1, last + 1):
                    if zz[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_codes[0xF0])
                        run -= 16
                    s = _category(zz[k])
                    put_value(ac_codes, (run << 4) | s, zz[k], s)
                    run = 0
                if last < 63:
                    bits.put(*ac_codes[0x00])
    return bytes(out) + bits.flush() + b"\xff\xd9"


def pil(data: bytes, draft=None):
    """Pillow's decode, or None where Pillow raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return jpeg_goldens.pil_decode(data, draft)
    except Exception:  # noqa: BLE001 — any failure of PIL's is a None
        return None


def assert_as_pil(data: bytes, drafts, what=""):
    for draft in drafts:
        want, got = pil(data, draft), decode_image(data, draft)
        if want is None:
            assert got is None, (what, draft)
            continue
        assert got is not None and got.shape == want.shape, (what, draft)
        diff = int(np.abs(got.astype(np.int16) - want).max())
        assert diff == 0, (what, draft, f"max difference {diff}")


def _drafts(bw: int, bh: int):
    """Draft sizes picking libjpeg's scales 1, 1/2, 1/4 and 1/8 of a file
    of bw x bh blocks."""
    m = 8 * min(bw, bh)
    return [None, m // 2, m // 4, m // 8]


def _one_block(coefficients: dict, q=1, qbits: int = 16):
    blocks = np.zeros((1, 1, 1, 64), np.int64)
    for k, v in coefficients.items():
        blocks[0, 0, 0, k] = v
    qt = np.full(64, q) if np.isscalar(q) else np.asarray(q)
    return write_jpeg(blocks, qt, qbits)


# each a block that reaches one rule of the SIMD IDCTs (coefficient
# positions in natural order, row * 8 + column)
IDCT_RULES = {
    # pmullw: 300 * 300 = 90000 keeps its low 16 bits
    "dequantisation_wraps_at_16_bits": ({0: 5, 1: 300, 9: -300}, 300),
    # only coefficient row 0: pass 1's DC-only shortcut, a 16-bit shift
    "dc_only_rows_shift_in_16_bits": ({0: 3000, 3: -2500, 7: 2100}, 4),
    # row 4 alone beside row 0: the 4x4's shortcut still taken
    "row_4_left_to_the_4x4_shortcut": ({0: 2800, 2: 900, 32: 3000}, 4),
    # pass 1's 16-bit saturation
    "pass_1_saturates": ({0: 20000, 8: 20000, 16: -18000, 56: 15000}, 1),
    # in0 + in4 and the odd part's word sums wrap
    "word_sums_wrap": ({8: 30000, 40: 30000, 24: 25000, 56: 25000,
                        32: 30000, 0: 30000}, 1),
    # pass 2 saturates to [-128, 127] before centring
    "pass_2_saturates_to_8_bits": ({0: 1500, 1: -700}, 16),
    # the 2x2 keeps pass 1's column 0 in 32 bits, shifted there by 15
    "2x2_column_0_in_32_bits": ({0: -1541, 1: -349, 3: 10405, 4: 312,
                                 7: 9451}, 3),
}


@pytest.mark.parametrize("rule", sorted(IDCT_RULES))
def test_idct_rules_match_pillow(rule):
    coefficients, q = IDCT_RULES[rule]
    assert_as_pil(_one_block(coefficients, q), _drafts(1, 1), rule)


@pytest.mark.parametrize("chunk", range(8))
def test_extreme_coefficients_match_pillow(chunk):
    """25 files a chunk of random blocks of up to 11 coefficients of up to
    15 bits (a quarter of them in coefficient row 0 only, another in rows
    0 and 4), 8- or 16-bit tables, one block or 2 x 3 blocks of three
    components, at each scale."""
    rng = np.random.default_rng(1000 + chunk)
    for t in range(25):
        ncomp, by, bx = (3, 2, 3) if t % 5 == 0 else (1, 1, 1)
        blocks = np.zeros((ncomp, by, bx, 64), np.int64)
        for c in range(ncomp):
            for y in range(by):
                for x in range(bx):
                    kind, n = rng.integers(0, 4), rng.integers(1, 12)
                    idx = rng.choice(64, n, replace=False)
                    if kind == 0:
                        idx = rng.choice(8, min(n, 8), replace=False)
                    elif kind == 1:
                        idx = np.concatenate([rng.choice(8, 2, replace=False),
                                              32 + rng.choice(8, 2, replace=False)])
                    blocks[c, y, x, idx] = rng.integers(
                        -32767, 32768, len(idx)) >> rng.integers(0, 12, len(idx))
        blocks[..., 0] = np.clip(blocks[..., 0], -16383, 16383)  # DC diffs
        q = rng.integers(1, 256, 64) if t % 3 else rng.integers(1, 65536, 64)
        data = write_jpeg(blocks, q, 8 if q.max() < 256 else 16)
        assert_as_pil(data, _drafts(bx, by), f"file {t}")


@pytest.mark.parametrize("chunk", range(4))
def test_blocks_at_the_c_idct_bounds_match_pillow(chunk):
    """25 files a chunk of 2 x 3 blocks of three components, quantised by
    ones, whose outputs lie about the edges where `csrc/jpeg_decode.c`
    leaves the C IDCTs for the SIMD path: a DC of 3800-4300 (a pixel near
    +-512 before the +128) with up to three small AC coefficients, or one
    AC coefficient of 2500-4200 (a pass-1 output near +-16384) with up to
    two more, at each scale."""
    rng = np.random.default_rng(2000 + chunk)
    for t in range(25):
        blocks = np.zeros((3, 2, 3, 64), np.int64)
        for c in range(3):
            for y in range(2):
                for x in range(3):
                    b = blocks[c, y, x]
                    sign = rng.choice([-1, 1])
                    if rng.integers(0, 2):
                        b[0] = sign * rng.integers(3800, 4301)
                        n, top = rng.integers(0, 4), 64
                    else:
                        b[rng.integers(1, 64)] = sign * rng.integers(2500, 4201)
                        n, top = rng.integers(0, 3), 512
                    for k in rng.choice(np.arange(1, 64), n, replace=False):
                        b[k] += rng.integers(-top, top + 1)
        data = write_jpeg(blocks, np.ones(64, np.int64))
        assert_as_pil(data, _drafts(3, 2), f"file {t}")


def _progressive(w: int, h: int, mode: str, seed: int, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(photo(h, w, seed)).convert(mode).save(
        buf, "JPEG", progressive=True, quality=85, **options)
    return buf.getvalue()


@pytest.mark.parametrize("w,h,mode,options", [
    (227, 141, "RGB", {}), (227, 141, "RGB", {"subsampling": 0}),
    (227, 141, "RGB", {"subsampling": 1}), (227, 141, "L", {}),
    (227, 141, "CMYK", {}), (16, 24, "RGB", {}), (9, 40, "RGB", {}),
    (40, 9, "L", {}), (17, 33, "RGB", {"subsampling": 0}),
    (64, 64, "RGB", {"restart_marker_rows": 1}),
], ids=lambda v: str(v) if not isinstance(v, dict) else
   "-".join(f"{k}{x}" for k, x in v.items()) or "default")
def test_progressive_files_cut_after_each_scan_match_pillow(w, h, mode,
                                                            options):
    """Block smoothing: the file's first k scans and an EOI, for every k
    short of all (all scans: no smoothing, the file itself), whole and at
    each scale."""
    data = _progressive(w, h, mode, w + h, **options)
    ends = scan_ends(data)
    assert len(ends) > 2
    drafts = [None] + [max(1, min(w, h) // s) for s in (2, 4, 8)]
    for k in range(1, len(ends) + 1):
        cut = jpeg_goldens.corrupt(data, ("eoi_after_scan", k))
        assert_as_pil(cut, drafts, f"{k} of {len(ends)} scans")


NAMES = sorted(n for n in jpeg_goldens.manifest(GOLDENS)["fixtures"]
               if not n.startswith("photo"))
MARKERS = [0xD0, 0xD3, 0xD7, 0xC4, 0xDA, 0xD9, 0xE1, 0xFE, 0x01]


def corrupted(i: int, rng) -> tuple:
    """The i-th file of the corpus and its draft sizes: a fixture with one
    of five corruptions, or a file of huge coefficients."""
    name = NAMES[i % len(NAMES)]
    data = jpeg_goldens.fixture_bytes(GOLDENS, name)
    w, h = jpeg_goldens.manifest(GOLDENS)["fixtures"][name]["size"]
    drafts = [None] + jpeg_goldens.draft_sizes(w, h)
    ends = scan_ends(data)
    sos = data.find(b"\xff\xda")
    lo, hi = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big"), ends[-1]
    kind = i % 5
    if kind == 0:
        return jpeg_goldens.corrupt(data, ("flip", int(rng.integers(lo, hi)),
                                           int(rng.integers(1, 256)))), drafts
    if kind == 1:
        return jpeg_goldens.corrupt(data, (
            "marker", int(rng.integers(lo, hi)),
            int(rng.choice(MARKERS)))), drafts
    if kind == 2:  # a run of scan data cut out
        pos, n = int(rng.integers(lo, hi)), int(rng.integers(1, 200))
        return data[:pos] + data[pos + n:], drafts
    if kind == 3 and len(ends) > 1:
        return jpeg_goldens.corrupt(data, (
            "eoi_after_scan", int(rng.integers(1, len(ends))))), drafts
    by, bx = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    blocks = rng.integers(-32767, 32768, (3, by, bx, 64)) >> rng.integers(
        0, 12, (3, by, bx, 64))
    blocks[..., 40:] = 0
    blocks[..., 0] = np.clip(blocks[..., 0], -16383, 16383)  # DC diffs
    q = rng.integers(1, 65536, 64)
    return write_jpeg(blocks, q, 16), _drafts(bx, by)


@pytest.mark.parametrize("chunk", range(60))
def test_corrupted_fixtures_match_pillow(chunk):
    """Five files a chunk, 300 in all, each whole and at each draft size
    its fixture records (the writer's at each scale)."""
    rng = np.random.default_rng(chunk)
    for j in range(5):
        i = chunk * 5 + j
        data, drafts = corrupted(i, rng)
        assert_as_pil(data, drafts, f"file {i}")
