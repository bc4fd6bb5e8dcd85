"""The port's data pipeline against PIL and the JAX package's, on the CPU.

- Decode (`data/decode.py`): bit-equal to
  `np.asarray(PIL.Image.open(b).convert("RGB"))` on PNGs the test writes in
  every colour type with every row filter, and on PNG, PPM, PGM and BMP
  files PIL writes (BMP also top-down); JPEG, GIF, 16-bit and interlaced
  PNGs raise NotImplementedError naming ROADMAP Queue A item 3; corrupt
  bytes give None.
- Transforms (`data/transforms.py`): `resize_bicubic` bit-equal to PIL's
  bicubic `resize` with and without a box; the eval and train transforms
  with the same `random.Random` seed equal to the JAX `image_transform`'s
  output. Tolerance: 0 uint8 levels (the count of pixels a level apart is
  printed, and is 0).
- Loaders: the port's `WdsData` (one worker, a thread; two workers,
  processes) and `CsvData` give the JAX loaders' batches on shards and
  files the test writes: texts exactly, images within the transform
  tolerance (the eval transform, which draws nothing); the URL expansion
  equal; a resumed webdataset epoch equal to the uninterrupted one's tail;
  a worker's NotImplementedError raised in the consumer.
"""
import io
import random
import struct
import tarfile
import zlib

import numpy as np
import pytest
from PIL import Image

from megatron_clip_tpu.data import image_folder as jax_folder
from megatron_clip_tpu.data import loaders as jax_loaders
from megatron_clip_tpu.data import transforms as jax_tf
from megatron_clip_tpu.data import webdataset as jax_wds
from megatron_clip_tpu.tokenizer import get_tokenizer as jax_tokenizer
from megatron_clip_tpu_torch.data import image_folder, loaders, transforms
from megatron_clip_tpu_torch.data import webdataset as wds
from megatron_clip_tpu_torch.data.decode import decode_image
from megatron_clip_tpu_torch.tokenizer import get_tokenizer

# colour type -> channels
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(pix: np.ndarray, ctype: int, filters, palette=None,
               depth=8, interlace=0) -> bytes:
    """uint8 [H, W, C] as a PNG whose row r uses filters[r % len]."""
    h, w, c = pix.shape
    x = pix.reshape(h, w * c).astype(np.int16)
    rows = []
    for r in range(h):
        f = filters[r % len(filters)]
        up = x[r - 1] if r else np.zeros_like(x[r])
        left = np.concatenate([np.zeros(c, np.int16), x[r, :-c]])
        ul = np.concatenate([np.zeros(c, np.int16), up[:-c]])
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up
                                                                 - 2 * ul)
        pred = [0, left, up, (left + up) >> 1,
                np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))][f]
        rows.append(bytes([f]) + ((x[r] - pred) & 255).astype(
            np.uint8).tobytes())
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + \
        _chunk(b"IEND", b"")


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("ctype", sorted(CHANNELS))
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4], [4, 3, 3, 1, 2]])
def test_png_decodes_as_pil(ctype, filters):
    rng = np.random.default_rng(ctype * 10 + len(filters))
    palette = None
    if ctype == 3:
        pix = rng.integers(0, 40, (23, 19, 1), dtype=np.uint8)
        palette = rng.integers(0, 256, 3 * 32, dtype=np.uint8).tobytes()
    else:
        pix = rng.integers(0, 256, (23, 19, CHANNELS[ctype]), dtype=np.uint8)
    data = encode_png(pix, ctype, filters, palette)
    np.testing.assert_array_equal(decode_image(data), pil_rgb(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("fmt", ["PNG", "PPM", "BMP"])
def test_pil_written_files_decode_as_pil(mode, fmt):
    if fmt == "PPM" and mode in ("LA", "P"):
        mode = "L" if mode == "LA" else "RGB"
    if fmt == "BMP" and mode in ("L", "LA", "P"):
        mode = "RGB"
    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (17, 29, 4), dtype=np.uint8),
                          "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_image(data), pil_rgb(data))


def test_top_down_bmp_decodes_as_pil():
    rng = np.random.default_rng(8)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)).save(
        buf, "BMP")
    data = bytearray(buf.getvalue())
    h = struct.unpack_from("<i", data, 22)[0]
    stride = (13 * 3 + 3) // 4 * 4
    off = struct.unpack_from("<I", data, 10)[0]
    rows = [bytes(data[off + i * stride:off + (i + 1) * stride])
            for i in range(h)]
    # the same rows stored top-down: negative height, rows reversed
    data[off:off + stride * h] = b"".join(reversed(rows))
    struct.pack_into("<i", data, 22, -h)
    np.testing.assert_array_equal(decode_image(bytes(data)),
                                  pil_rgb(bytes(data)))


@pytest.mark.parametrize("fmt", ["JPEG", "GIF", "16-bit", "interlaced"])
def test_unported_formats_raise_naming_the_queue_item(fmt):
    pix = np.zeros((8, 8, 3), np.uint8)
    if fmt in ("JPEG", "GIF"):
        buf = io.BytesIO()
        Image.fromarray(pix).save(buf, fmt)
        data = buf.getvalue()
    elif fmt == "16-bit":
        data = encode_png(pix, 2, [0], depth=16)
    else:
        data = encode_png(pix, 2, [0], interlace=1)
    with pytest.raises(NotImplementedError, match=r"Queue A item 3\)"):
        decode_image(data)


def test_corrupt_bytes_give_none():
    data = encode_png(np.full((16, 16, 3), 7, np.uint8), 2, [4])
    broken = bytearray(data)
    broken[41] ^= 0xFF  # the zlib stream's header
    header = _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
    bad_filter = (data[:8] + header
                  + _chunk(b"IDAT", zlib.compress(b"\x07\0\0\0"))
                  + _chunk(b"IEND", b""))
    for bad in (data[:40], data[:len(data) - 30], bytes(broken), bad_filter,
                b"hello", b"", b"BM" + b"\0" * 10, b"P6\n2 2\n255\n\0"):
        assert decode_image(bad) is None, bad[:12]


def test_resize_matches_pil():
    rng = np.random.default_rng(9)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(3, 200, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        size = tuple(int(v) for v in rng.integers(1, 240, 2))
        box = None
        if rng.random() < 0.7:
            x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
            box = (x0, y0, int(rng.integers(x0 + 1, w + 1)),
                   int(rng.integers(y0 + 1, h + 1)))
        want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC,
                                                      box=box))
        np.testing.assert_array_equal(
            transforms.resize_bicubic(img, size, box), want,
            err_msg=f"{(h, w)} -> {size} box {box}")


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("shape", [(256, 256), (300, 180), (97, 411),
                                   (224, 224)])
def test_transforms_match_jax(is_train, shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    aug = {"scale": (0.3, 1.0), "gray_scale_prob": 0.5}
    for seed in range(4):
        want = jax_tf.image_transform(224, is_train, rng=random.Random(seed),
                                      aug_cfg=aug)(Image.fromarray(img))
        got = transforms.image_transform(224, is_train,
                                         rng=random.Random(seed),
                                         aug_cfg=aug)(img)
        std = np.asarray(transforms.OPENAI_DATASET_STD, np.float32)
        levels = np.round(np.abs(got - want) * std * 255)
        print(f"pixels a level apart: {int((levels == 1).sum())}")
        assert levels.max() == 0
        np.testing.assert_array_equal(got, want)
    # a seed of the sample's own draws as a Random of that seed does
    t = transforms.image_transform(224, is_train)
    np.testing.assert_array_equal(
        t(img, 11), transforms.image_transform(
            224, is_train, rng=random.Random(11))(img))


def test_unported_augmentations_raise():
    for kw in ({"aug_cfg": {"color_jitter": 0.4}}, {"autoaugment": True}):
        with pytest.raises(NotImplementedError, match=r"Queue A item 3\)"):
            transforms.image_transform(224, True, **kw)


def test_url_expansion_matches_jax():
    for spec in ("a-{000..012}.tar", "{x,y}/s-{0..3}.tar::b.tar",
                 "plain.tar"):
        assert wds.expand_urls(spec) == jax_wds.expand_urls(spec)
        assert wds.brace_expand(spec) == jax_wds.brace_expand(spec)
    assert wds.expand_urls_with_weights("a-{0..2}.tar::b-{0..1}.tar",
                                        "1::3") == \
        jax_wds.expand_urls_with_weights("a-{0..2}.tar::b-{0..1}.tar", "1::3")
    assert wds.split_by_node(list("abcdefg"), 1, 3) == \
        jax_wds.split_by_node(list("abcdefg"), 1, 3)
    assert wds.split_by_worker(list("abcdefg"), 1, 2) == \
        jax_wds.split_by_worker(list("abcdefg"), 1, 2)


def _shards(tmp_path, n_shards=3, per_shard=14, image=None):
    """Tars of PNG (some PPM) samples with txt or json captions."""
    rng = np.random.RandomState(0)
    for s in range(n_shards):
        with tarfile.open(tmp_path / f"shard-{s:02d}.tar", "w") as tf:
            for i in range(per_shard):
                pix = rng.randint(0, 255, (30 + i, 41 - i, 3), np.uint8)
                buf = io.BytesIO()
                fmt = "PPM" if i % 5 == 4 else "PNG"
                Image.fromarray(pix).save(buf, fmt)
                img = image or buf.getvalue()
                cap = f"a photo of item {s} {i}"
                parts = [(fmt.lower(), img)]
                parts.append(("json", ('{"caption": "%s"}' % cap).encode())
                             if i % 3 == 0 else ("txt", cap.encode()))
                for ext, data in parts:
                    info = tarfile.TarInfo(f"{s:02d}{i:04d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(tmp_path / ("shard-{00..%02d}.tar" % (n_shards - 1)))


@pytest.mark.parametrize("workers", [1, 2])
def test_webdataset_batches_match_jax(tmp_path, workers):
    urls = _shards(tmp_path)
    kw = dict(num_samples=40, seed=5, context_length=16, workers=workers,
              shuffle_buffer=10)
    want = list(jax_wds.WdsData(urls, 4, jax_tf.image_transform(32, False),
                                jax_tokenizer(), **kw))
    got = list(wds.WdsData(urls, 4, transforms.image_transform(32, False),
                           get_tokenizer(), **kw))
    assert len(got) == len(want) == 10
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gi, wi)


def test_webdataset_skip_gives_the_uninterrupted_tail(tmp_path):
    urls = _shards(tmp_path)
    ds = wds.WdsData(urls, 4, transforms.image_transform(32, True),
                     get_tokenizer(), num_samples=40, seed=2,
                     context_length=16, workers=2, shuffle_buffer=6)
    full = list(ds)
    ds.set_epoch(0)
    ds.skip_batches(3)
    tail = list(ds)
    assert len(tail) == len(full) - 3
    for (gi, gt), (wi, wt) in zip(tail, full[3:]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gi, wi)


def _children(pid):
    """Live processes whose parent is `pid`, from /proc."""
    import os
    kids = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(entry))
    return kids


def test_stop_workers_leaves_no_process(tmp_path):
    """`stop_workers` ends a decode worker still alive, the forkserver the
    workers came from and the resource tracker; the next epoch starts them
    again."""
    import os
    import time
    from multiprocessing import forkserver, resource_tracker
    urls = _shards(tmp_path)
    ds = wds.WdsData(urls, 4, transforms.image_transform(32, False),
                     get_tokenizer(), num_samples=40, seed=5,
                     context_length=16, workers=2, shuffle_buffer=10)
    it = iter(ds)
    first = next(it)
    workers = list(wds._workers)
    assert len(workers) == 2 and all(p.is_alive() for p in workers)
    it.close()  # the epoch's own clean-up ends its workers
    assert not any(p.is_alive() for p in workers)
    stray = wds.worker_context().Process(target=time.sleep, args=(600,),
                                         daemon=True)
    stray.start()
    wds._workers.add(stray)
    wds.stop_workers()
    assert not stray.is_alive()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    assert _children(os.getpid()) == []
    ds.set_epoch(0)
    again = list(ds)
    assert len(again) == 10
    np.testing.assert_array_equal(again[0][0], first[0])
    wds.stop_workers()
    assert _children(os.getpid()) == []


@pytest.mark.parametrize("workers", [1, 2])
def test_worker_errors_reach_the_consumer(tmp_path, workers):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    urls = _shards(tmp_path, n_shards=2, per_shard=4, image=buf.getvalue())
    ds = wds.WdsData(urls, 2, transforms.image_transform(32, False),
                     get_tokenizer(), num_samples=8, workers=workers)
    with pytest.raises(NotImplementedError, match=r"Queue A item 3\)"):
        list(ds)


def test_sample_decode_matches_jax(tmp_path):
    urls = _shards(tmp_path, n_shards=1, per_shard=6)
    for raw in wds.iterate_tar_samples(wds.expand_urls(urls)[0]):
        image, cap = wds.sample_parts(raw)
        want_img, want_cap = jax_wds.decode_sample(raw)
        assert cap == want_cap
        np.testing.assert_array_equal(decode_image(image),
                                      np.asarray(want_img.convert("RGB")))
    assert wds.sample_parts({"__key__": "x", "txt": b"no image"}) is None
    assert wds.sample_parts({"__key__": "x", "png": b"", "json": b"[1]"}) \
        is None


def test_csv_batches_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    lines = ["filepath\ttitle"]
    for i in range(10):
        Image.fromarray(rng.randint(0, 255, (20 + i, 33, 3), np.uint8)).save(
            tmp_path / f"{i}.png")
        lines.append(f"{i}.png\ta caption number {i}")
    (tmp_path / "d.csv").write_text("\n".join(lines) + "\n")
    kw = dict(seed=4, context_length=16)
    want = jax_loaders.CsvData(str(tmp_path / "d.csv"), 3,
                               jax_tf.image_transform(32, False),
                               jax_tokenizer(), **kw)
    got = loaders.CsvData(str(tmp_path / "d.csv"), 3,
                          transforms.image_transform(32, False),
                          get_tokenizer(), **kw)
    for epoch in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == 3
        for (gi, gt), (wi, wt) in pairs:
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gi, wi)
    got.set_epoch(1)
    got.skip_batches(1)
    want.set_epoch(1)
    want.skip_batches(1)
    for (gi, _), (wi, _) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)


def test_synthetic_batches_match_jax():
    tok = get_tokenizer()
    got = loaders.SyntheticData(4, 12, 32, context_length=16, seed=3,
                                tokenizer=tok)
    want = jax_loaders.SyntheticData(4, 12, 32, context_length=16, seed=3,
                                     tokenizer=jax_tokenizer())
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_image_folder_batches_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (40, 26, 3), np.uint8)).save(
                tmp_path / c / f"{i}.png")
    got = list(image_folder.image_folder_batches(str(tmp_path), 2, 32,
                                                 is_train=False, epochs=1))
    want = list(jax_folder.image_folder_batches(str(tmp_path), 2, 32,
                                                is_train=False, epochs=1))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
