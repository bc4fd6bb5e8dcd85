"""The data-parallel trainer's data and its cut runs, on the CPU.

- Rank-sharded batches: `get_data` for rank r of 2 against the JAX
  loaders. Synthetic and CSV data (`--batch-size` global): rank r yields
  exactly the rows `parallel.mesh.rank_rows` names of the JAX one-process
  loader's global batch, with --accum-freq 1 and 2 (its share of each
  block), and the same batch count. Webdataset shards: rank r's batches of
  B/2 exactly those of the JAX `WdsData` built with the same `rank` and
  `world_size` (split by node, each host's count num_samples // B).
  Images under the eval transform, which draws nothing; tolerance 0.
- A rank whose shards run out first (3 shards over 2 ranks) ends the
  epoch on both ranks at its last batch, where a collective would
  otherwise wait for it.
- Rank 0 alone evaluates: two ranks on CSV data with --val-data give
  rank 0 the val metrics of its final weights on the whole val set,
  equal to `contrastive_eval_metrics` of those weights in this process
  (rank 1 none); --exit-duration-in-mins 0 (rank 0's clock) stops both
  ranks after the first step, rank 0 saving there.
- SIGTERM on one rank of a two-rank run (`torch_dp_util.resume_rank`):
  every rank stops after the same step, rank 0 saves there, and the run
  resumed with --resume latest gives the uninterrupted run's last steps
  and final parameters bit for bit, on both ranks.
"""
import io
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from megatron_clip_tpu.data import loaders as jax_loaders
from megatron_clip_tpu.data import transforms as jax_tf
from megatron_clip_tpu.data import webdataset as jax_wds
from megatron_clip_tpu.tokenizer import get_tokenizer as jax_tokenizer
from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
from megatron_clip_tpu_torch.data.loaders import get_data
from megatron_clip_tpu_torch.data.transforms import image_transform
from megatron_clip_tpu_torch.parallel.mesh import rank_rows
from megatron_clip_tpu_torch.tokenizer import get_tokenizer
from megatron_clip_tpu_torch.training.params import parse_args
from torch_dp_util import resume_rank, spawn, trainer_rank

SIZE, CTX, WORLD = 32, 16, 2


def _images(n):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 255, (20 + i % 9, 30 + i % 5, 3), np.uint8)
            for i in range(n)]


def _rank_batches(argv, rank):
    args = parse_args(argv)
    pp = image_transform(SIZE, is_train=False)
    data = get_data(args, pp, pp, get_tokenizer(), context_length=CTX,
                    image_size=SIZE, rank=rank, world_size=WORLD,
                    microbatches=max(1, args.accum_freq))
    return data["train"], list(data["train"])


@pytest.mark.parametrize("accum", [1, 2])
def test_synthetic_rank_rows_are_the_jax_global_batch_rows(accum):
    argv = ["--dataset-type", "synthetic", "--batch-size", "8",
            "--train-num-samples", "24", "--seed", "3", "--accum-freq",
            str(accum)]
    want = list(jax_loaders.SyntheticData(8, 24, SIZE, context_length=CTX,
                                          seed=3, tokenizer=jax_tokenizer()))
    for rank in range(WORLD):
        info, got = _rank_batches(argv, rank)
        rows = rank_rows(8, accum, rank, WORLD)
        assert info.num_batches == len(got) == len(want) == 3
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi[rows])
            np.testing.assert_array_equal(gt, wt[rows])


@pytest.mark.parametrize("accum", [1, 2])
def test_csv_rank_rows_are_the_jax_global_batch_rows(tmp_path, accum):
    lines = ["filepath\ttitle"]
    for i, pix in enumerate(_images(20)):
        Image.fromarray(pix).save(tmp_path / f"{i}.png")
        lines.append(f"{i}.png\tcaption number {i}")
    (tmp_path / "d.csv").write_text("\n".join(lines) + "\n")
    argv = ["--dataset-type", "csv", "--train-data", str(tmp_path / "d.csv"),
            "--batch-size", "8", "--seed", "4", "--accum-freq", str(accum)]
    want = list(jax_loaders.CsvData(str(tmp_path / "d.csv"), 8,
                                    jax_tf.image_transform(SIZE, False),
                                    jax_tokenizer(), seed=4,
                                    context_length=CTX))
    for rank in range(WORLD):
        info, got = _rank_batches(argv, rank)
        rows = rank_rows(8, accum, rank, WORLD)
        assert info.num_batches == len(got) == len(want) == 2
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gt, wt[rows])
            np.testing.assert_array_equal(gi, wi[rows])


def _write_shards(tmp_path, shards):
    images = _images(8 * shards)
    for s in range(shards):
        with tarfile.open(tmp_path / f"shard-{s}.tar", "w") as tf:
            for i in range(8):
                buf = io.BytesIO()
                Image.fromarray(images[s * 8 + i]).save(buf, "PNG")
                for ext, data in (("png", buf.getvalue()),
                                  ("txt", f"item {s} {i}".encode())):
                    info = tarfile.TarInfo(f"{s}{i:03d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(tmp_path / ("shard-{0..%d}.tar" % (shards - 1)))


def test_webdataset_rank_batches_are_the_jax_host_batches(tmp_path):
    urls = _write_shards(tmp_path, 4)
    argv = ["--dataset-type", "webdataset", "--train-data", urls,
            "--batch-size", "8", "--train-num-samples", "32", "--seed", "5",
            "--workers", "1"]
    for rank in range(WORLD):
        info, got = _rank_batches(argv, rank)
        jax_data = jax_wds.WdsData(urls, 4, jax_tf.image_transform(SIZE,
                                                                   False),
                                   jax_tokenizer(), num_samples=32, seed=5,
                                   context_length=CTX, workers=1,
                                   rank=rank, world_size=WORLD)
        want = list(jax_data)
        assert info.num_batches == jax_data.num_batches == 4
        assert len(got) == len(want) == 4
        for (gi, gt), (wi, wt) in zip(got, want):
            assert gi.shape[0] == 4
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gi, wi)


def test_a_rank_whose_shards_run_out_ends_every_rank_s_epoch(tmp_path):
    urls = _write_shards(tmp_path, 3)
    argv = ["--dataset-type", "webdataset", "--train-data", urls,
            "--batch-size", "8", "--train-num-samples", "24", "--workers",
            "1", "--model", "test-tiny", "--precision", "fp32",
            "--warmup", "1", "--log-interval", "1", "--device", "cpu"]
    ranks = spawn(trainer_rank, WORLD, tmp_path, [(argv, None, None)])
    # 24 // 8 = 3 batches a rank; rank 1's one shard holds 2 of 4 rows
    assert [len(r[0]["steps"]) for r in ranks] == [2, 2]
    assert ranks[0][0]["steps"] == ranks[1][0]["steps"]


def test_rank_zero_evaluates_and_decides_the_wall_clock_exit(tmp_path):
    from megatron_clip_tpu_torch import create_model
    from megatron_clip_tpu_torch.evaluation import contrastive_eval_metrics
    lines = ["filepath\ttitle"]
    for i, pix in enumerate(_images(24)):
        Image.fromarray(pix).save(tmp_path / f"{i}.png")
        lines.append(f"{i}.png\tcaption number {i}")
    (tmp_path / "train.csv").write_text("\n".join(lines[:17]) + "\n")
    (tmp_path / "val.csv").write_text("\n".join(lines[:1] + lines[17:])
                                      + "\n")
    tiny = ["--model", "test-tiny", "--precision", "fp32", "--warmup", "1",
            "--log-interval", "1", "--device", "cpu", "--batch-size", "8"]
    csv = tiny + ["--dataset-type", "csv", "--train-data",
                  str(tmp_path / "train.csv"), "--val-data",
                  str(tmp_path / "val.csv")]
    timed = tiny + ["--dataset-type", "synthetic", "--train-num-samples",
                    "32", "--exit-duration-in-mins", "0", "--save",
                    str(tmp_path / "ck"), "--name", "t"]
    ranks = spawn(trainer_rank, WORLD, tmp_path,
                  [(csv, None, None), (timed, None, None)])
    (run0, stop0), (run1, stop1) = ranks
    assert len(run0["steps"]) == len(run1["steps"]) == 2
    assert not any(k.startswith("val_") for k in run1["final"])
    model = create_model("test-tiny", precision="fp32", device="cpu")
    model.load_state_dict(run0["params"], strict=False)
    pp = image_transform(SIZE, is_train=False)
    val = get_data(parse_args(csv), pp, pp, get_tokenizer(),
                   context_length=model.context_length,
                   image_size=SIZE)["val"]
    want = contrastive_eval_metrics(model.eval(), val)
    got = {k[4:]: v for k, v in run0["final"].items()
           if k.startswith("val_")}
    assert got and got == {k: v for k, v in want.items() if k in got}
    assert len(stop0["steps"]) == len(stop1["steps"]) == 1
    assert ckpt_io.latest_checkpoint_step(str(tmp_path / "ck" / "t")) == 1


def test_sigterm_on_one_rank_stops_every_rank_and_resumes_bit_equal(
        tmp_path):
    argv = ["--dataset-type", "synthetic", "--batch-size", "16", "--epochs",
            "1", "--warmup", "2", "--log-interval", "1", "--precision",
            "fp32", "--model", "test-tiny", "--train-num-samples", "64",
            "--seed", "3", "--device", "cpu"]
    ranks = spawn(resume_rank, WORLD, tmp_path, argv, 1, 2)
    root = str(tmp_path / "ck" / "t")
    tree, meta, step = ckpt_io.load_checkpoint(root)
    for got in ranks:
        whole, cut, resumed = got["whole"], got["cut"], got["resumed"]
        assert len(whole["steps"]) == 4
        assert len(cut["steps"]) == 2  # rank 0 stopped with rank 1
        assert cut["steps"] == whole["steps"][:2]
        assert resumed["steps"] == whole["steps"][2:]
        assert resumed["final"]["loss"] == whole["final"]["loss"]
        for n, p in whole["params"].items():
            assert torch.equal(resumed["params"][n], p), n
    # rank 0 saved the cut at step 2, then the resumed run's end
    assert ckpt_io.load_checkpoint_metadata(root, 2) == {
        "consumed_samples": 32}
    assert step == 4 and meta == {"consumed_samples": 64}
    for n, p in ranks[0]["whole"]["params"].items():
        assert torch.equal(ranks[1]["whole"]["params"][n], p), n
        assert torch.equal(tree["params"][n], p), n
