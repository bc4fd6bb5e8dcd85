"""Image decoding in numpy and the standard library.

Stands for PIL's `Image.open(b).convert("RGB")` in the port's data pipeline
(`data/webdataset.py::decode_sample`, `data/loaders.py::CsvData`,
`data/image_folder.py`): the card's machine has no PIL. `decode_image`
turns an encoded image into uint8 [H, W, 3], equal to
`np.asarray(PIL.Image.open(b).convert("RGB"))` for

- PNG: 8-bit grey, grey+alpha, RGB, RGBA and palette, with any of the five
  row filters, not interlaced;
- PPM (P6) and PGM (P5), binary, maxval 255;
- BMP: 24 and 32 bits a pixel, uncompressed or with byte-aligned bit
  fields, bottom-up or top-down.

Grey is replicated to three channels, alpha is dropped (not blended) and a
palette index is looked up, as PIL's "RGB" conversion does. A palette index
past the palette's end reads black.

Bad input has two outcomes:
- corrupt bytes (truncated, an inconsistent header, a broken zlib stream,
  an unknown filter or signature) give None: the JAX pipeline drops a
  sample PIL cannot open (`megatron_clip_tpu/data/webdataset.py:133-137`);
- a format this module does not decode yet (JPEG, WebP, GIF, TIFF, 16-bit
  or low-bit-depth PNG, Adam7 interlacing, ASCII PNM, RLE or palette BMP)
  raises NotImplementedError naming ROADMAP Queue A item 3, so that a
  shard of such images fails loudly instead of training on nothing.

PNG rows are unfiltered along the anti-diagonals of the pixel grid: a
pixel's filter reads its left, upper and upper-left neighbours only, so
every pixel of a diagonal depends on earlier diagonals alone and each of
the H + W - 1 diagonals is one vectorised numpy step, whatever filter each
row uses (Average and Paeth run left to right within a row).
"""
import functools
import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_QUEUE = "(ROADMAP Queue A item 3)"


class _Corrupt(Exception):
    """Bytes that claim a format but do not hold a valid image of it."""


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"decoding {what} is not ported yet {_QUEUE}")


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> uint8 [H, W, 3], or None for corrupt bytes.
    Raises NotImplementedError for a format not ported yet."""
    data = bytes(data)
    try:
        if data.startswith(_PNG_SIG):
            return _decode_png(data)
        if data[:2] in (b"P5", b"P6"):
            return _decode_pnm(data)
        if data[:2] == b"BM":
            return _decode_bmp(data)
    except (_Corrupt, zlib.error, struct.error, ValueError):
        return None
    if data[:3] == b"\xff\xd8\xff":
        raise _unsupported("JPEG")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise _unsupported("WebP")
    if data[:6] in (b"GIF87a", b"GIF89a"):
        raise _unsupported("GIF")
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        raise _unsupported("TIFF")
    if data[:2] in (b"P1", b"P2", b"P3", b"P4", b"P7"):
        raise _unsupported(f"PNM {data[:2].decode()} (only binary P5 / P6)")
    return None


def _to_rgb(pix: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] with C in 1..4 -> [H, W, 3]: grey replicated, alpha
    dropped."""
    c = pix.shape[2]
    if c <= 2:
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


# --- PNG --------------------------------------------------------------------

def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise _Corrupt("truncated chunk")
        yield kind, data[pos + 8:end]
        if kind == b"IEND":
            return
        pos = end + 4


def _decode_png(data: bytes) -> np.ndarray:
    header = palette = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise _Corrupt("no IHDR or IDAT")
    w, h, depth, ctype, method, filt, interlace = header
    if ctype not in _PNG_CHANNELS or method or filt or w == 0 or h == 0:
        raise _Corrupt("bad IHDR")
    if depth != 8:
        raise _unsupported(f"{depth}-bit PNG")
    if interlace:
        raise _unsupported("interlaced (Adam7) PNG")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompressobj().decompress(b"".join(idat), h * (stride + 1))
    if len(raw) < h * (stride + 1):
        raise _Corrupt("short image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, -1)
    pix = _unfilter(rows[:, 1:], rows[:, 0], bpp).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise _Corrupt("palette image without PLTE")
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8,
                                len(palette) // 3 * 3).reshape(-1, 3)
        table[:len(entries)] = entries[:256]
        return table[pix[:, :, 0]]
    return _to_rgb(pix)


@functools.lru_cache(maxsize=None)
def _predictors() -> np.ndarray:
    """Every filter's prediction from its neighbours, by
    (filter << 24) | (left << 16) | (up << 8) | up-left: 80 MB of uint8,
    built once a process."""
    a = np.arange(256, dtype=np.int16)[:, None, None]
    b = a.reshape(1, 256, 1)
    c = a.reshape(1, 1, 256)
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    table = np.empty((5, 256, 256, 256), np.uint8)
    table[0] = 0
    table[1] = a
    table[2] = b
    table[3] = (a + b) >> 1
    table[4] = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return table.reshape(-1)


def _unfilter(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) on
    uint8 rows [H, W * bpp], one anti-diagonal of pixels at a time.

    The pixels are held skewed, diagonal-major: pixel (r, i) at
    skew[r + i + 1, r + 1], behind a zero first row and column. A diagonal
    d is then one contiguous run of rows, skew[d + 1, r0 + 1 : r1 + 1];
    each pixel's left and upper neighbours lie in diagonal d - 1, one slot
    apart, and its upper-left one in diagonal d - 2. The slots left of
    each row's first pixel are never written, so they read 0 as the
    filters' edges require. Each pixel's prediction is one lookup in
    `_predictors()`."""
    if (ftype > 4).any():
        raise _Corrupt("unknown row filter")
    table = _predictors()
    h, stride = rows.shape
    w = stride // bpp
    r, i = np.divmod(np.arange(h * w), w)
    raw = np.zeros((h + w - 1, h, bpp), np.int32)
    raw[r + i, r] = rows.reshape(h * w, bpp)
    skew = np.zeros((h + w, h + 1, bpp), np.int32)
    fshift = ftype.astype(np.int32)[:, None] << 24
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        key = skew[d, r0 + 1:r1 + 1] << 16          # left
        key |= skew[d, r0:r1] << 8                   # up
        key |= skew[d - 1, r0:r1] if d else 0        # up-left
        key |= fshift[r0:r1]
        out = skew[d + 1, r0 + 1:r1 + 1]
        np.add(raw[d, r0:r1], table[key], out=out)
        out &= 255
    return skew[r + i + 1, r + 1].astype(np.uint8).reshape(h, stride)


# --- PPM / PGM --------------------------------------------------------------

def _decode_pnm(data: bytes) -> np.ndarray:
    """Binary P6 (RGB) and P5 (grey): the magic, width, height and maxval as
    whitespace-separated decimals ('#' comments to the end of a line), one
    whitespace byte, then the samples."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace()
                                   or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise _Corrupt("bad PNM header")
        fields.append(int(data[start:pos]))
    if not data[pos:pos + 1].isspace():
        raise _Corrupt("bad PNM header")
    w, h, maxval = fields
    if maxval != 255:
        raise _unsupported(f"PNM with maxval {maxval}")
    channels = 3 if data[:2] == b"P6" else 1
    n = w * h * channels
    if w == 0 or h == 0 or len(data) < pos + 1 + n:
        raise _Corrupt("truncated PNM")
    pix = np.frombuffer(data, np.uint8, n, pos + 1).reshape(h, w, channels)
    return _to_rgb(pix)


# --- BMP --------------------------------------------------------------------

def _decode_bmp(data: bytes) -> np.ndarray:
    offset = struct.unpack_from("<I", data, 10)[0]
    dib = struct.unpack_from("<I", data, 14)[0]
    if dib < 40:
        raise _unsupported("OS/2 BMP")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    if bits not in (24, 32) or compression not in (0, 3):
        raise _unsupported(f"{bits}-bit BMP with compression {compression}")
    if bits == 24 and compression == 3:
        raise _unsupported("24-bit BMP with bit fields")
    # the byte of a little-endian pixel that holds R, G and B
    order = [2, 1, 0]
    if compression == 3:
        masks = struct.unpack_from("<III", data, 14 + 40)
        if masks != (0, 0, 0):
            shifts = {0xFF << (8 * k): k for k in range(4)}
            if any(m not in shifts for m in masks):
                raise _unsupported(f"BMP bit fields {masks}")
            order = [shifts[m] for m in masks]
    if w <= 0 or h == 0:
        raise _Corrupt("bad BMP size")
    rows, step = abs(h), bits // 8
    stride = (bits * w + 31) // 32 * 4
    if len(data) < offset + rows * stride:
        raise _Corrupt("truncated BMP")
    pix = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(
        rows, stride)[:, :w * step].reshape(rows, w, step)
    if h > 0:  # stored bottom-up
        pix = pix[::-1]
    return np.ascontiguousarray(pix[:, :, order])
