"""JPEG fixtures and Pillow's digests of them, for checking the decoder
where there is no Pillow.

    python -m megatron_clip_tpu_torch.tools.jpeg_goldens tests/torch_goldens/jpeg

writes every fixture of FIXTURES into the given directory with Pillow's
encoder, from seeded photo-like images (`photo`), then the corrupt fixtures
of CORRUPT, each one of those files with a recipe applied, and
`digests.json` beside them: for each file and each draft size (0 for the full decode) the
shape and the SHA-256 of Pillow's `np.asarray(img.convert("RGB"))` after
`Image.open`, `draft("RGB", (d, d))` and `load()`. Run it where Pillow is
installed (it imports PIL inside `main` only); the files it wrote are the
fixtures, and `tests/test_torch_jpeg.py` holds both the port's
decoder and Pillow to their digests.

`check(decode_image, directory)` decodes every fixture of a directory at
every recorded size with the given decoder and compares digests, with numpy and the standard library
only: `chip_smoke.py` runs it on the card's host, which has no Pillow. The
640 x 480 fixtures (PHOTOS) are also the images of its webdataset shards.
"""
import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

MANIFEST = "digests.json"
# the trainer's image size: the draft size of its webdataset decode
TRAIN_DRAFT = 224

# name -> (width, height, PIL mode, JPEG save options)
PHOTOS = {
    "photo_420_q90_a": (640, 480, "RGB", {"quality": 90}),
    "photo_420_q90_b": (640, 480, "RGB", {"quality": 90}),
    "photo_420_q90_c": (640, 480, "RGB", {"quality": 90}),
    "photo_422_q80": (640, 480, "RGB", {"quality": 80, "subsampling": 1}),
    "photo_444_q80": (640, 480, "RGB", {"quality": 80, "subsampling": 0}),
    "photo_progressive_q80": (640, 480, "RGB",
                              {"quality": 80, "progressive": True}),
    "photo_grey_q80": (640, 480, "L", {"quality": 80}),
}
FIXTURES = {
    **PHOTOS,
    "edge_1x1": (1, 1, "RGB", {"quality": 95}),
    "edge_8x8_q50": (8, 8, "RGB", {"quality": 50}),
    "edge_17x33_420_q95": (17, 33, "RGB", {"quality": 95}),
    "edge_17x33_422_progressive": (17, 33, "RGB",
                                   {"subsampling": 1, "progressive": True}),
    "edge_227x141_444_q50": (227, 141, "RGB",
                             {"subsampling": 0, "quality": 50}),
    "edge_227x141_420_optimize": (227, 141, "RGB", {"optimize": True}),
    "edge_227x141_422_q95": (227, 141, "RGB",
                             {"subsampling": 1, "quality": 95}),
    "progressive_227x141_444": (227, 141, "RGB",
                                {"subsampling": 0, "progressive": True}),
    "grey_227x141_progressive": (227, 141, "L", {"progressive": True}),
    "rgb_kept_227x141": (227, 141, "RGB", {"keep_rgb": True}),
    "cmyk_227x141": (227, 141, "CMYK", {"quality": 85}),
    "cmyk_227x141_progressive": (227, 141, "CMYK", {"progressive": True}),
    "restart_blocks_227x141": (227, 141, "RGB",
                               {"restart_marker_blocks": 3}),
    "restart_rows_227x141_progressive": (227, 141, "RGB",
                                         {"restart_marker_rows": 1,
                                          "progressive": True}),
    "segments_227x141": (227, 141, "RGB", {"comment": b"a comment " * 20}),
    "qtables16_227x141": (227, 141, "RGB",
                          {"qtables": [list(range(300, 364))] * 2}),
}


# corrupt data Pillow decodes with warnings: name -> (the fixture it is
# made from, recipe): ("flip", offset, xor mask) flips bits of one byte,
# ("marker", offset, code) inserts the marker 0xFF code before that byte,
# ("eoi_after_scan", k) keeps k scans and ends the file with EOI. The
# first two reach coefficients the SIMD IDCT saturates; the rest leave a
# progressive file's AC coefficients partly unknown, so libjpeg smooths
# its blocks (with the DC re-estimated where no AC scan came, and, where a
# scan stops at a marker, the rows past it on the previous scan's bits).
CORRUPT = {
    "corrupt_qtables16_flip": ("qtables16_227x141", ("flip", 1068, 69)),
    "corrupt_restart_marker": ("restart_blocks_227x141",
                               ("marker", 2885, 0xD3)),
    "corrupt_progressive_dc_only": ("progressive_227x141_444",
                                    ("eoi_after_scan", 1)),
    "corrupt_progressive_4_scans": ("progressive_227x141_444",
                                    ("eoi_after_scan", 4)),
    "corrupt_progressive_eoi_in_scan": ("restart_rows_227x141_progressive",
                                        ("marker", 1794, 0xD9)),
}


def scan_ends(data: bytes) -> list:
    """The offset where each scan's entropy data ends: the first marker
    after it that is neither a stuffed byte nor a restart marker."""
    i, ends = 2, []
    while i < len(data) - 1:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xD9:
            break
        if m == 0xFF:
            i += 1
            continue
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if m != 0xDA:
            i += 2 + length
            continue
        j = i + 2 + length
        while j < len(data) - 1 and not (
                data[j] == 0xFF and data[j + 1] != 0
                and not 0xD0 <= data[j + 1] <= 0xD7):
            j += 1
        ends.append(j)
        i = j
    return ends


def corrupt(data: bytes, recipe: tuple) -> bytes:
    """`data` with a CORRUPT recipe applied."""
    kind, *args = recipe
    out = bytearray(data)
    if kind == "flip":
        out[args[0]] ^= args[1]
    elif kind == "marker":
        out[args[0]:args[0]] = bytes([0xFF, args[1]])
    elif kind == "eoi_after_scan":
        out = out[:scan_ends(data)[args[0] - 1]] + b"\xff\xd9"
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    return bytes(out)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded photo-like uint8 [h, w, 3] image: smooth gradients, a few
    discs of flat colour and mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        fx, fy = 7 + 3 * c + 9 * rng.random(), 11 + c + 5 * rng.random()
        img[..., c] = 128 + 100 * np.sin(x / fx + 6 * rng.random()) \
            * np.cos(y / fy)
    for _ in range(6):
        cy, cx = h * rng.random(), w * rng.random()
        r = max(h, w) / 3 * rng.random() + 1
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def draft_sizes(w: int, h: int) -> list:
    """The draft sizes recorded for a w x h fixture: the trainer's, and one
    that picks each of libjpeg's scales 2, 4 and 8 where the image is big
    enough."""
    return sorted({TRAIN_DRAFT} | {min(w, h) // s for s in (2, 4, 8)
                                    if min(w, h) // s >= 1})


def digest(img: np.ndarray) -> dict:
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img)).hexdigest()}


def fixture_bytes(directory: Path, name: str) -> bytes:
    return (Path(directory) / f"{name}.jpg").read_bytes()


def manifest(directory: Path) -> dict:
    return json.loads((Path(directory) / MANIFEST).read_text())


def check(decode_image, directory: Path) -> dict:
    """Every fixture of `directory` at every recorded draft size through
    `decode_image` (as `data/decode.py`'s: bytes, draft size or None ->
    uint8 array): the count of decodes checked and those whose digest
    differs."""
    checked, wrong = 0, []
    for name, entry in manifest(directory)["fixtures"].items():
        data = fixture_bytes(directory, name)
        for draft, want in entry["decodes"].items():
            img = decode_image(data, int(draft) or None)
            got = None if img is None else digest(img)
            checked += 1
            if got != want:
                wrong.append({"fixture": name, "draft": int(draft),
                              "got": got, "want": want})
    return {"checked": checked, "wrong": wrong}


def pil_decode(data: bytes, draft=None) -> np.ndarray:
    """Pillow's decode: Image.open, draft("RGB", (d, d)), load, "RGB"."""
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(data))
    if draft:
        img.draft("RGB", (draft, draft))
    img.load()
    return np.asarray(img.convert("RGB"))


def main(argv=None) -> None:
    import io

    import PIL
    from PIL import Image, features
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("directory", type=Path,
                        help="where to write the fixtures and digests.json")
    out = parser.parse_args(argv).directory
    out.mkdir(parents=True, exist_ok=True)
    entries, written = {}, {}
    for i, (name, (w, h, mode, options)) in enumerate(FIXTURES.items()):
        options = dict(options)
        if name == "segments_227x141":
            exif = Image.Exif()
            exif[0x010E] = "a description " * 8
            exif[0x0112] = 6
            options.update(exif=exif.tobytes(), icc_profile=b"\0" * 900)
        buf = io.BytesIO()
        Image.fromarray(photo(h, w, seed=1000 + i)).convert(mode).save(
            buf, "JPEG", **options)
        written[name] = (buf.getvalue(), w, h, mode)
    for name, (base, recipe) in CORRUPT.items():
        data, w, h, mode = written[base]
        written[name] = (corrupt(data, recipe), w, h, mode)
    for name, (data, w, h, mode) in written.items():
        (out / f"{name}.jpg").write_bytes(data)
        decodes = {"0": digest(pil_decode(data))}
        for d in draft_sizes(w, h):
            decodes[str(d)] = digest(pil_decode(data, d))
        entries[name] = {"size": [w, h], "mode": mode, "bytes": len(data),
                         "decodes": decodes}
    (out / MANIFEST).write_text(json.dumps({
        "pillow": PIL.__version__,
        "libjpeg_turbo": features.version("libjpeg_turbo"),
        "fixtures": entries}, indent=1) + "\n")
    total = sum(e["bytes"] for e in entries.values())
    print(f"{len(entries)} fixtures, {total} bytes, in {out}")


if __name__ == "__main__":
    main()
