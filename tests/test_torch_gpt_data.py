"""The port's GPT data layer against the JAX package's, on the CPU.

- `.bin` / `.idx` written by either package's builder are byte-equal and
  each package reads the other's (the MMapIndexedDataset format).
- The host C `build_sample_idx` (`csrc/dataset_helpers.c`) against the JAX
  package's helper and the port's numpy version, over several (sizes,
  seq_length, epochs); `build_blending_indices` the same.
- `GPTDataset` over doc splits and more than one epoch: the doc, sample and
  shuffle indices, every sample, and the cache files under
  `--data-cache-path` (each package reads the other's).
- `BlendableDataset`, both sampler laws at several (total, micro, dp,
  consumed) with both permutation impls, and `gpt_batch_iterator`'s O(1)
  seek, bit-equal to JAX's.

`--sampler-rng torch` seeds each epoch's torch.Generator with seed +
epoch, so it is megatron's order only at seed 0, although the JAX help
calls it bit-exact (a reference defect, `training/workload.py:392`, which
the port keeps): the torch cases below run at seeds 0 and 3 and hold the
port to the JAX package, not to megatron.
"""
import os

import numpy as np
import pytest

from megatron_clip_tpu.data import gpt_dataset as jax_gd
from megatron_clip_tpu.data import indexed_dataset as jax_ix
from megatron_clip_tpu.data import native as jax_native
from megatron_clip_tpu.data import samplers as jax_samplers
from megatron_clip_tpu_torch.data import gpt_dataset as gd
from megatron_clip_tpu_torch.data import helpers
from megatron_clip_tpu_torch.data import indexed_dataset as ix
from megatron_clip_tpu_torch.data import samplers


def _docs(seed: int, n: int, lo: int = 1, hi: int = 90, vocab: int = 500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(lo, hi)) for _ in range(n)]


def _write(module, prefix, docs, dtype=np.int32):
    b = module.MMapIndexedDatasetBuilder(prefix, dtype=dtype)
    for d in docs:
        b.add_item(d)
        b.end_document()
    b.finalize()
    return str(prefix)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus of 60 documents written by the port's builder."""
    root = tmp_path_factory.mktemp("corpus")
    return _write(ix, root / "c", _docs(0, 60))


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_each_package_writes_the_same_bytes_and_reads_the_other(tmp_path,
                                                                dtype):
    docs = _docs(1, 25, lo=0)
    mine = _write(ix, tmp_path / "port", docs, dtype)
    theirs = _write(jax_ix, tmp_path / "jax", docs, dtype)
    for ext in (".bin", ".idx"):
        assert open(mine + ext, "rb").read() == open(theirs + ext,
                                                     "rb").read()
    for reader, prefix in ((ix, theirs), (jax_ix, mine)):
        ds = reader.MMapIndexedDataset(prefix)
        assert ds.dtype == np.dtype(dtype) and len(ds) == len(docs)
        np.testing.assert_array_equal(ds.doc_idx, np.arange(len(docs) + 1))
        for i, d in enumerate(docs):
            np.testing.assert_array_equal(ds[i], d.astype(dtype))
        np.testing.assert_array_equal(ds.get(3, offset=1, length=2),
                                      docs[3].astype(dtype)[1:3])


def test_merge_file_equals_the_jax_builders(tmp_path):
    a = _write(ix, tmp_path / "a", _docs(2, 7))
    b = _write(ix, tmp_path / "b", _docs(3, 5))
    out = {}
    for name, module in (("port", ix), ("jax", jax_ix)):
        builder = module.MMapIndexedDatasetBuilder(tmp_path / name)
        builder.merge_file(a)
        builder.merge_file(b)
        builder.finalize()
        out[name] = [open(str(tmp_path / name) + ext, "rb").read()
                     for ext in (".bin", ".idx")]
    assert out["port"] == out["jax"]


def test_a_bad_index_raises(tmp_path):
    prefix = _write(ix, tmp_path / "c", _docs(4, 3))
    with open(prefix + ".idx", "r+b") as f:
        f.write(b"NOTMAGIC!")
    with pytest.raises(ValueError, match="magic"):
        ix.MMapIndexedDataset(prefix)


@pytest.mark.parametrize("n_docs,seq,epochs,seed", [
    (1, 7, 1, 0), (5, 16, 1, 1), (40, 32, 3, 2), (40, 1, 1, 3),
    (200, 128, 2, 4), (13, 300, 5, 5)])
def test_build_sample_idx_equals_the_jax_helper(n_docs, seq, epochs, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 150, n_docs).astype(np.int32)
    doc_idx = np.concatenate([np.arange(n_docs, dtype=np.int32)] * epochs)
    rng.shuffle(doc_idx)
    tokens = int(sizes.sum())
    if tokens <= seq:
        pytest.skip("corpus shorter than a sample")
    got = helpers.build_sample_idx(sizes, doc_idx, seq, epochs, tokens)
    want = jax_native.build_sample_idx(sizes, doc_idx, seq, epochs, tokens)
    plain = helpers.build_sample_idx_numpy(sizes, doc_idx, seq, epochs,
                                           tokens)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("weights,size", [
    ([1.0], 5), ([0.3, 0.7], 100), ([5, 1, 1, 3], 997), ([1, 1], 0)])
def test_blending_indices_equal_the_jax_helper(weights, size):
    got = helpers.build_blending_indices(np.asarray(weights, float), size)
    want = jax_native.build_blending_indices(np.asarray(weights, float),
                                             size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("splits", ["969,30,1", "1,1,0", "8,2", "1,1,1"])
def test_split_ranges_equal_the_jax_ones(splits):
    for n in (1, 7, 60, 1000):
        assert gd.train_valid_test_split(splits, n) == \
            jax_gd.train_valid_test_split(splits, n)


def _assert_same_dataset(got, want):
    for k in ("doc_idx", "sample_idx", "shuffle_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert len(got) == len(want)
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("seq,num_samples,documents", [
    (16, 0, None), (32, 200, None), (24, 150, (10, 40))])
def test_gpt_dataset_equals_the_jax_one(corpus, tmp_path, seq, num_samples,
                                        documents):
    """More than one epoch where num_samples asks for it, a doc range, and
    the index cache under --data-cache-path: the same files, each package
    reading the other's."""
    docs = None if documents is None else np.arange(*documents)
    kw = dict(seed=5, num_samples=num_samples, documents=docs,
              split_tag="train" if docs is not None else "")
    got = gd.GPTDataset(corpus, seq, cache_dir=str(tmp_path / "port"), **kw)
    want = jax_gd.GPTDataset(corpus, seq, cache_dir=str(tmp_path / "jax"),
                             **kw)
    _assert_same_dataset(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    # each reads the other's cache
    _assert_same_dataset(
        gd.GPTDataset(corpus, seq, cache_dir=str(tmp_path / "jax"), **kw),
        want)
    _assert_same_dataset(
        jax_gd.GPTDataset(corpus, seq, cache_dir=str(tmp_path / "port"),
                          **kw), got)


def test_a_split_shorter_than_a_sample_raises(corpus):
    with pytest.raises(ValueError, match="smaller than one sample"):
        gd.GPTDataset(corpus, 10 ** 6, cache=False)


def test_blendable_dataset_equals_the_jax_one(corpus):
    a = gd.GPTDataset(corpus, 16, seed=1, cache=False)
    b = gd.GPTDataset(corpus, 16, seed=2, cache=False)
    ja = jax_gd.GPTDataset(corpus, 16, seed=1, cache=False)
    jb = jax_gd.GPTDataset(corpus, 16, seed=2, cache=False)
    got = gd.BlendableDataset([a, b], [0.25, 0.75], 120)
    want = jax_gd.BlendableDataset([ja, jb], [0.25, 0.75], 120)
    np.testing.assert_array_equal(got.ds_index, want.ds_index)
    np.testing.assert_array_equal(got.ds_sample_index, want.ds_sample_index)
    assert len(got) == len(want) == 120
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i], want[i])


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("impl", ["numpy", "torch"])
@pytest.mark.parametrize("total,micro,dp,consumed,sharding,seed", [
    (100, 4, 1, 0, False, 0), (100, 4, 2, 24, False, 0),
    (103, 5, 2, 90, True, 3), (64, 8, 1, 120, True, 0),
    (37, 3, 3, 9, False, 3)])
def test_random_sampler_equals_the_jax_one(impl, total, micro, dp,
                                           consumed, sharding, seed):
    kw = dict(consumed_samples=consumed, data_sharding=sharding, seed=seed,
              perm_impl=impl)
    got = _take(samplers.random_batch_indices(total, micro, dp, **kw), 30)
    want = _take(jax_samplers.random_batch_indices(total, micro, dp, **kw),
                 30)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("total,micro,dp,consumed", [
    (100, 4, 1, 0), (100, 4, 2, 96), (10, 3, 1, 7), (50, 5, 2, 1000)])
def test_sequential_sampler_equals_the_jax_one(total, micro, dp, consumed):
    got = _take(samplers.sequential_batch_indices(
        total, micro, dp, consumed_samples=consumed), 25)
    want = _take(jax_samplers.sequential_batch_indices(
        total, micro, dp, consumed_samples=consumed), 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_the_process_default_permutation(monkeypatch):
    monkeypatch.setattr(samplers, "_default_perm_impl", "numpy")
    samplers.set_default_perm_impl("torch")
    got = _take(samplers.random_batch_indices(50, 5, seed=0), 3)
    want = _take(jax_samplers.random_batch_indices(50, 5, seed=0,
                                                   perm_impl="torch"), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="perm_impl"):
        samplers.set_default_perm_impl("philox")


@pytest.mark.parametrize("kind", ["single", "cyclic"])
def test_gpt_batch_iterator_seeks_as_the_jax_one(corpus, tmp_path, kind):
    """The O(1) seek: the stream from consumed sample k * B is the
    uninterrupted stream's batch k on, bit-equal to the JAX iterator's,
    over the train split and past an epoch."""
    kw = dict(seed=2, split="8,2,0", split_index=0,
              cache_dir=str(tmp_path), dataloader_type=kind)
    whole = _take(gd.gpt_batch_iterator(corpus, 4, 16, **kw), 30)
    want = _take(jax_gd.gpt_batch_iterator(corpus, 4, 16, **kw), 30)
    for g, w in zip(whole, want):
        assert g.dtype == np.int32 and g.shape == (4, 17)
        np.testing.assert_array_equal(g, w)
    for k in (1, 7, 25):
        got = _take(gd.gpt_batch_iterator(corpus, 4, 16, start_sample=4 * k,
                                          **kw), 5)
        jwant = _take(jax_gd.gpt_batch_iterator(
            corpus, 4, 16, start_sample=4 * k, **kw), 5)
        for i, (g, w) in enumerate(zip(got, jwant)):
            np.testing.assert_array_equal(g, whole[k + i])
            np.testing.assert_array_equal(g, w)


def test_an_empty_split_raises(corpus):
    with pytest.raises(ValueError, match="empty range"):
        next(gd.gpt_batch_iterator(corpus, 4, 16, split="1,0,0",
                                   split_index=1))
