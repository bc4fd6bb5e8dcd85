"""The port's JPEG decoder (`csrc/jpeg_decode.c` through
`data/decode.py::decode_image`) against Pillow, on the CPU.

Every case is bit-equal (tolerance 0 uint8 levels) to
`np.asarray(PIL.Image.open(b).convert("RGB"))`, or with a draft size to
`Image.open(b)`, `draft("RGB", (d, d))`, `load()`, `convert("RGB")`, at
Pillow's own output size, on JPEGs this test writes with Pillow from seeded
photo-like images (gradients, discs of flat colour, mild noise):

- each chroma subsampling (4:4:4, 4:2:2, 4:2:0), baseline, progressive and
  optimised Huffman tables, quality 50 and 95, at 1x1, 8x8, 17x33, 227x141
  and 640x480 (partial MCUs at the right and bottom edges);
- grey, RGB kept as RGB (Adobe transform 0) and CMYK (Pillow's inverted
  Adobe CMYK), baseline and progressive;
- restart markers every few MCUs and every MCU row, APP, COM and EXIF
  segments, 16-bit quantisation tables, and a file without DHT (libjpeg's
  standard tables);
- draft sizes that pick each of libjpeg's scales 1, 2, 4 and 8 on each
  subsampling and on progressive files;
- truncated files: None wherever Pillow's load raises, the same array
  wherever it succeeds;
- an SOF whose size is past Pillow's decompression-bomb limit gives None
  from the header; arithmetic-coded, lossless and 12-bit frames raise
  NotImplementedError naming ROADMAP Queue A item 3;
- the committed fixtures of `tests/torch_goldens/jpeg/` (the only bytes the
  card's smoke run checks the decoder with, there being no Pillow there):
  the port and Pillow each reproduce every recorded digest, full and at
  each draft size, so that fixtures and digests cannot drift apart.

The library is built with the host's C compiler on first use; a second
load reuses the hashed library, builds at once in several threads each
rename a whole library into place, and with no compiler the build raises.
"""
import io
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from megatron_clip_tpu_torch.data import decode
from megatron_clip_tpu_torch.data.decode import decode_image
from megatron_clip_tpu_torch.ops.kernels import _build
from megatron_clip_tpu_torch.tools import jpeg_goldens
from megatron_clip_tpu_torch.tools.jpeg_goldens import photo

SIZES = [(1, 1), (8, 8), (17, 33), (227, 141), (640, 480)]
CODINGS = {"baseline": {}, "progressive": {"progressive": True},
           "optimize": {"optimize": True}}


def encode(pix: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pix).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil(data: bytes, draft=None):
    """Pillow's decode, or None where Pillow raises."""
    try:
        img = Image.open(io.BytesIO(data))
        if draft:
            img.draft("RGB", (draft, draft))
        img.load()
        return np.asarray(img.convert("RGB"))
    except Exception:  # noqa: BLE001 — any failure of PIL's is a None
        return None


def assert_as_pil(data: bytes, draft=None):
    want = pil(data, draft)
    got = decode_image(data, draft)
    assert want is not None
    assert got is not None and got.shape == want.shape, (
        None if got is None else got.shape, want.shape)
    diff = np.abs(got.astype(np.int16) - want).max()
    assert diff == 0, f"max difference {diff}"


def pil_scale(data: bytes, draft: int) -> int:
    img = Image.open(io.BytesIO(data))
    w = img.size[0]
    img.draft("RGB", (draft, draft))
    return -(-w // img.size[0])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_rgb_jpegs_decode_as_pil(subsampling, coding, quality, size):
    w, h = size
    data = encode(photo(h, w, seed=w * 7 + h), subsampling=subsampling,
                  quality=quality, **CODINGS[coding])
    assert_as_pil(data)


@pytest.mark.parametrize("size", [(17, 33), (227, 141)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", ["L", "RGB-kept", "CMYK"])
def test_grey_rgb_and_cmyk_decode_as_pil(mode, progressive, size):
    w, h = size
    pix = photo(h, w, seed=3)
    kw = {"keep_rgb": True} if mode == "RGB-kept" else {}
    data = encode(pix, mode.split("-")[0], quality=85,
                  progressive=progressive, **kw)
    assert_as_pil(data)
    for draft in (w // 2, w // 4):
        assert_as_pil(data, draft)


def _strip_dht(data: bytes) -> bytes:
    out, i = bytearray(data[:2]), 2
    while True:
        marker, length = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if marker != 0xC4:
            out += data[i:i + 2 + length]
        if marker == 0xDA:
            return bytes(out + data[i + 2 + length:])
        i += 2 + length


@pytest.mark.parametrize("segments,progressive", [
    (kind, progressive) for kind in ("restart_blocks", "restart_rows",
                                     "app_com_exif", "16-bit_tables")
    for progressive in (False, True)] + [("no_dht", False)])
def test_segments_decode_as_pil(segments, progressive):
    pix = photo(141, 227, seed=11)
    exif = Image.Exif()
    exif[0x010E] = "a description " * 8
    exif[0x0112] = 6
    kw = {"restart_blocks": {"restart_marker_blocks": 3},
          "restart_rows": {"restart_marker_rows": 1},
          "app_com_exif": {"exif": exif.tobytes(), "icc_profile": b"\0" * 900,
                           "comment": b"a comment " * 20},
          "16-bit_tables": {"qtables": [list(range(300, 364))] * 2},
          "no_dht": {}}[segments]
    data = encode(pix, progressive=progressive, **kw)
    if segments == "no_dht":  # a baseline file's tables are the standard
        data = _strip_dht(data)
    if segments == "16-bit_tables":
        assert b"\xff\xdb\x00\x83\x10" in data  # a 16-bit DQT
    assert_as_pil(data)
    assert_as_pil(data, 56)


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("coding", ["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_draft_scales_decode_as_pil(subsampling, coding, scale):
    # 227 x 141 and 640 x 480: odd sizes, and MCUs cut at both edges
    for w, h in ((227, 141), (640, 480)):
        data = encode(photo(h, w, seed=scale + 5 * subsampling),
                      subsampling=subsampling, quality=90,
                      **CODINGS[coding])
        for draft in {h // scale, h // scale - 1 if scale > 1 else h}:
            assert pil_scale(data, draft) == scale
            assert_as_pil(data, draft)


@pytest.mark.parametrize("kind", ["baseline", "progressive", "grey",
                                  "restarts"])
def test_truncated_files_fail_where_pil_fails(kind):
    pix = photo(64, 96, seed=21)
    data = {"baseline": lambda: encode(pix, quality=80),
            "progressive": lambda: encode(pix, progressive=True),
            "grey": lambda: encode(pix, "L", quality=90),
            "restarts": lambda: encode(pix, restart_marker_blocks=2)}[kind]()
    n = len(data)
    cuts = sorted({2, 3, 20, 100, n // 3, n // 2, n - 200, *range(n - 12, n)})
    decoded = 0
    for cut in cuts:
        for draft in (None, 24):
            want, got = pil(data[:cut], draft), decode_image(data[:cut], draft)
            if want is None:
                assert got is None, (cut, draft)
            else:
                decoded += 1
                assert got is not None and np.array_equal(got, want), \
                    (cut, draft)
    assert decoded < len(cuts) * 2  # Pillow refused some cut


def test_size_past_pil_limit_gives_none():
    data = bytearray(encode(photo(16, 16, seed=1)))
    sof = data.index(b"\xff\xc0")
    # 16384 x 10923 = 178,962,432 pixels > 2 * Image.MAX_IMAGE_PIXELS
    data[sof + 5:sof + 9] = (10923).to_bytes(2, "big") + \
        (16384).to_bytes(2, "big")
    assert 16384 * 10923 > decode.MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    assert pil(bytes(data)) is None
    assert decode_image(bytes(data)) is None


@pytest.mark.parametrize("patch", ["arithmetic", "lossless", "12-bit"])
def test_unsupported_frames_raise_naming_the_queue_item(patch):
    data = bytearray(encode(photo(16, 16, seed=2)))
    sof = data.index(b"\xff\xc0")
    if patch == "12-bit":
        data[sof + 4] = 12
    else:
        data[sof + 1] = 0xC9 if patch == "arithmetic" else 0xC3
    with pytest.raises(NotImplementedError, match=r"Queue A item 3\)"):
        decode_image(bytes(data))


def test_second_load_reuses_the_hashed_library(monkeypatch):
    lib = _build.load("jpeg_decode")
    target = _build._target("jpeg_decode")
    assert target.is_file() and target.parent == _build.BUILD_DIR
    assert target.name.startswith("libjpeg_decode-")
    stamp = target.stat().st_mtime_ns
    assert _build.build(["jpeg_decode"]) == {"jpeg_decode": 0.0}
    assert _build.load("jpeg_decode") is lib
    assert target.stat().st_mtime_ns == stamp


def test_concurrent_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    errors, barrier = [], threading.Barrier(4)

    def build():
        try:
            barrier.wait()
            _build.build(["jpeg_decode"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    built = sorted(p.name for p in tmp_path.iterdir())
    target = _build._target("jpeg_decode")
    assert built == [target.with_suffix(".log").name, target.name]
    lib = _build.ctypes.CDLL(str(target))
    assert hasattr(lib, "jpeg_decode")


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.build(["jpeg_decode"])
    assert list(tmp_path.iterdir()) == []


GOLDENS = Path(__file__).parent / "torch_goldens" / "jpeg"
FIXTURES = sorted(jpeg_goldens.manifest(GOLDENS)["fixtures"])


@pytest.mark.parametrize("decoder", ["port", "pil"])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_reproduce_their_digests(name, decoder):
    entry = jpeg_goldens.manifest(GOLDENS)["fixtures"][name]
    data = jpeg_goldens.fixture_bytes(GOLDENS, name)
    decode_fn = decode_image if decoder == "port" else jpeg_goldens.pil_decode
    assert set(entry["decodes"]) == {"0"} | {
        str(d) for d in jpeg_goldens.draft_sizes(*entry["size"])}
    for draft, want in entry["decodes"].items():
        assert jpeg_goldens.digest(decode_fn(data, int(draft) or None)) \
            == want, draft


def test_fixtures_fit_their_budget():
    sizes = [p.stat().st_size for p in GOLDENS.iterdir()]
    assert sum(sizes) <= 400 * 1024
    assert jpeg_goldens.check(decode_image, GOLDENS)["wrong"] == []
