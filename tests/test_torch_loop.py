"""The port's CLIP trainer (`training/loop.py`, `pretrain_clip.py`) against
the JAX package's, at `test-tiny` size on the CPU.

- Loop against loop: both `run_training`s on the same synthetic batches
  (the same RandomState draws and token ids) in fp32 for 4 steps, the JAX
  initial parameters carried into the port through `bridge.py`; each
  step's metrics recorded by wrapping each runner's `step`. Loss and
  logit_scale within 1e-6 relative at step 1 and 1e-5 after, grad_norm
  within 1e-5 (the JAX run shards the batch over 8 virtual devices and sums
  in another order); the learning-rate schedules exactly, but the cosine
  within 1e-6 relative (its fp32 cos).
- Resume: a run saved at step 2 and resumed gives steps 3-4 bit-equal to
  the uninterrupted run, on synthetic data and on webdataset shards read by
  two decode workers.
- Loop semantics ported from tests/test_training_e2e.py, the refusals,
  the parser, the checkpoint tracker, the val metrics and the background
  save's on_commit.
"""
import io
import json
import os
import signal
import tarfile
import threading

import numpy as np
import pytest
import torch

from megatron_clip_tpu import factory as jax_factory
from megatron_clip_tpu.evaluation import retrieval as jax_retrieval
from megatron_clip_tpu.training import loop as jax_loop
from megatron_clip_tpu.training import params as jax_params
from megatron_clip_tpu_torch import pretrain_clip
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
from megatron_clip_tpu_torch.data.loaders import DataInfo, SyntheticData
from megatron_clip_tpu_torch.evaluation import retrieval
from megatron_clip_tpu_torch.training import loop
from megatron_clip_tpu_torch.training.params import parse_args

TINY_ARGS = [
    "--dataset-type", "synthetic", "--batch-size", "16", "--epochs", "1",
    "--warmup", "2", "--log-interval", "2", "--precision", "fp32",
    "--model", "test-tiny", "--train-num-samples", "64",
]
BASE = TINY_ARGS[:-2]  # without --train-num-samples


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """test-tiny steps run fastest on one thread, and the suite's workers
    share the machine's cores: PyTorch's default of a thread per core in
    each worker made this file ten times slower in the whole suite."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(argv, **kw):
    return loop.run_training(parse_args(argv), device="cpu", **kw)


@pytest.fixture
def record(monkeypatch):
    """Each port step's metrics as floats, and the step's runner."""
    steps = []
    step = loop._JointRunner.step

    def wrapped(self, images, texts):
        m = step(self, images, texts)
        steps.append({k: float(v) for k, v in m.items()})
        return m
    monkeypatch.setattr(loop._JointRunner, "step", wrapped)
    return steps


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX loop's 4 steps on TINY_ARGS: each step's metrics, and the
    run dir of the same run with --save."""
    steps = []
    step = jax_loop._JointRunner.step

    def wrapped(self, images, texts):
        m = step(self, images, texts)
        steps.append({k: float(v) for k, v in m.items()})
        return m
    jax_loop._JointRunner.step = wrapped
    save = str(tmp_path_factory.mktemp("jax_run"))
    try:
        final = jax_loop.run_training(jax_params.parse_args(
            TINY_ARGS + ["--save", save, "--name", "jax"]))
    finally:
        jax_loop._JointRunner.step = step
    return steps, final, os.path.join(save, "jax")


def _bridged(monkeypatch):
    """Make the port loop's model start from the JAX loop's parameters
    (`create_model("test-tiny", fp32, seed 0)` on both sides)."""
    jmodel, jparams = jax_factory.create_model("test-tiny", precision="fp32",
                                               seed=0)
    create = loop.factory.create_model

    def bridged(*args, **kw):
        model = create(*args, **kw)
        model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
        return model
    monkeypatch.setattr(loop.factory, "create_model", bridged)


def test_loop_matches_the_jax_loop(jax_run, record, monkeypatch):
    _bridged(monkeypatch)
    want, jax_final, _ = jax_run
    final = _run(TINY_ARGS)
    assert len(record) == len(want) == 4
    for i, (got, exp) in enumerate(zip(record, want)):
        rtol = 1e-6 if i == 0 else 1e-5
        for key in ("loss", "logit_scale"):
            np.testing.assert_allclose(got[key], exp[key], rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=1e-5, err_msg=f"step {i + 1}")
    assert final["step"] == jax_final["step"] == 4
    np.testing.assert_allclose(final["loss"], jax_final["loss"], rtol=1e-5)


@pytest.mark.parametrize("extra", [
    [], ["--lr-scheduler", "const"],
    ["--lr-scheduler", "const-cooldown", "--epochs-cooldown", "1"],
    ["--lr-scheduler", "const-cooldown", "--lr-cooldown-power", "2.0",
     "--lr-cooldown-end", "1e-5", "--epochs", "3"],
    ["--skip-scheduler"]])
def test_schedule_matches_the_jax_loop(extra):
    """Exactly, but the cosine: numpy's fp32 cos and XLA's differ by an ulp
    at some steps (numpy's is the correctly rounded one there), which 1 +
    cos amplifies near the schedule's end; held within 1e-6 relative plus
    1e-12 absolute, as tests/test_torch_train.py holds `cosine_lr`."""
    argv = BASE + ["--lr", "3e-4", "--warmup", "5"] + extra
    total = 40
    got = loop._make_schedule(parse_args(argv), total)
    want = jax_loop._make_schedule(jax_params.parse_args(argv), total)
    got = np.array([got(s) for s in range(total + 2)], np.float32)
    want = np.array([float(want(s)) for s in range(total + 2)], np.float32)
    if not extra:  # cosine
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def test_parser_is_the_jax_parser_plus_device(monkeypatch):
    import argparse
    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kw):
        parsers.append(self)
        return parse(self, *args, **kw)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)

    def strings(parse_fn):
        ns = parse_fn([])
        return ({s for a in parsers.pop()._actions for s in a.option_strings},
                vars(ns))
    port, port_ns = strings(parse_args)
    jax, jax_ns = strings(jax_params.parse_args)
    assert port == jax | {"--device"}
    assert port_ns.pop("device") == "cuda"
    assert port_ns == jax_ns
    for argv in (["--fp16"], ["--grad-checkpointing"],
                 ["--train-data", "x.csv"], ["--train-data", "a.tar"]):
        assert vars(parse_args(argv)) | {"device": None} == \
            vars(jax_params.parse_args(argv)) | {"device": None}


@pytest.mark.parametrize("source", ["synthetic", "webdataset"])
def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path, record,
                                                      source):
    argv = BASE + ["--train-num-samples", "64", "--seed", "3",
                   "--log-interval", "1"]
    if source == "webdataset":
        argv = ["--dataset-type", "webdataset"] + argv[2:] + [
            "--train-data", _tiny_shards(tmp_path), "--workers", "2"]
    full = _run(argv)
    straight = list(record)
    record.clear()
    root = str(tmp_path / "ck")
    _run(argv + ["--save", root, "--name", "t", "--exit-interval", "2",
                 "--save-interval", "2"])
    assert ckpt_io.latest_checkpoint_step(os.path.join(root, "t")) == 2
    record.clear()
    resumed = _run(argv + ["--resume", os.path.join(root, "t")])
    assert resumed["step"] == full["step"] == 4
    assert record == straight[2:]
    assert resumed["loss"] == full["loss"]


def _tiny_shards(tmp_path, n_shards=2, per_shard=40, size=40):
    """Two tars of PNGs (the port's encoder-free path: PIL writes them)
    with captions."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for s in range(n_shards):
        with tarfile.open(tmp_path / f"shard-{s}.tar", "w") as tf:
            for i in range(per_shard):
                buf = io.BytesIO()
                Image.fromarray(rng.randint(0, 255, (size, size + 7, 3),
                                            np.uint8)).save(buf, "PNG")
                for ext, data in (("png", buf.getvalue()),
                                  ("txt", f"a photo number {s} {i}".encode())):
                    info = tarfile.TarInfo(f"{s:03d}{i:04d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(tmp_path / "shard-{0..1}.tar")


def test_exit_interval_ends_the_run_not_the_epoch(tmp_path):
    save = str(tmp_path / "ck")
    m = _run(BASE + ["--train-num-samples", "32", "--epochs", "10",
                     "--exit-interval", "2", "--save", save,
                     "--save-frequency", "1"])
    assert m["step"] == 2
    iters = sorted(d for d in os.listdir(os.path.join(save, "default"))
                   if d.startswith("iter_"))
    assert iters == ["iter_0000002"], iters


def test_steps_per_epoch_bounds_each_epoch(tmp_path):
    save = str(tmp_path / "ck")
    m = _run(TINY_ARGS + ["--steps-per-epoch", "2", "--epochs", "2",
                          "--save", save, "--save-frequency", "1"])
    assert m["step"] == 4
    iters = sorted(d for d in os.listdir(os.path.join(save, "default"))
                   if d.startswith("iter_"))
    assert iters == ["iter_0000002", "iter_0000004"], iters


def test_save_most_recent_and_delete_previous_keep_the_newest(tmp_path):
    save = str(tmp_path / "ckroot")
    _run(BASE + ["--train-num-samples", "32", "--epochs", "2", "--save",
                 save, "--save-frequency", "5", "--save-most-recent",
                 "--delete-previous-checkpoint", "--save-interval", "1"])
    root = os.path.join(save, "default")
    iters = sorted(d for d in os.listdir(root) if d.startswith("iter_"))
    assert iters == ["iter_0000004"], iters
    assert ckpt_io.latest_checkpoint_step(root) == 4
    assert ckpt_io.load_checkpoint_metadata(root) == {
        "consumed_samples": 64}


def test_sigterm_mid_run_saves_and_exits(tmp_path, monkeypatch):
    step = loop._JointRunner.step
    calls = []

    def step_then_term(self, images, texts):
        m = step(self, images, texts)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return m
    monkeypatch.setattr(loop._JointRunner, "step", step_then_term)
    save = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    _run(TINY_ARGS + ["--save", save, "--log-interval", "1"])
    assert len(calls) == 2
    assert ckpt_io.latest_checkpoint_step(os.path.join(save, "default")) == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_datainfo_delegates_loader_controls():
    ds = SyntheticData(4, 16, 32, context_length=16)
    di = DataInfo(ds, ds.num_batches, 16)
    assert hasattr(di, "skip_batches")
    di.skip_batches(3)
    assert len(list(di)) == ds.num_batches - 3
    assert not hasattr(di, "set_epoch")

    class _Epochal(SyntheticData):
        def set_epoch(self, e):
            self.epoch = e

    ds2 = _Epochal(4, 16, 32, context_length=16)
    di2 = DataInfo(ds2, ds2.num_batches, 16)
    di2.set_epoch(5)
    assert ds2.epoch == 5


def test_resume_from_an_explicit_root_and_a_bogus_one(tmp_path):
    argv = BASE + ["--train-num-samples", "64", "--seed", "3"]
    root = str(tmp_path / "ck")
    _run(argv + ["--save", root, "--name", "t", "--exit-interval", "2",
                 "--save-interval", "2"])
    m = _run(argv + ["--resume", os.path.join(root, "t")])
    assert m["step"] == 4
    with pytest.raises(FileNotFoundError):
        _run(argv + ["--resume", str(tmp_path / "nope")])


@pytest.mark.parametrize("flag,item", [
    (["--model", "coca_test-tiny"], 2),
    (["--precision", "fp16"], 2),
    (["--pretrained", "openai"], 3),
    (["--pretrained-image", "openai"], 3),
    (["--distill-model", "test-tiny"], 3),
    (["--aug-cfg", "color_jitter=0.4"], 3),
    (["--aug-cfg", "auto_augment=rand-m9-mstd0.5"], 3),
    (["--extra-world-size", "4"], 5),
    (["--tensor-model-parallel-size", "2"], 5),
    (["--pipeline-model-parallel-size", "2"], 5),
    (["--virtual-pipeline-parallel-size", "2"], 5),
    # FSDP is ported (test_torch_fsdp_clip.py); CLIP's tensor parallelism
    # beside it is not
    (["--fsdp-parallel-size", "2", "--tensor-model-parallel-size", "2"], 5),
    (["--dcn-data-parallel-size", "2"], 5),
    (["--sequence-parallel"], 5),
    (["--remote-sync", "/tmp/elsewhere"], 7),
])
def test_refused_flags_name_their_queue_item(flag, item, monkeypatch):
    def never(*a, **k):
        raise AssertionError("built a model before refusing")
    monkeypatch.setattr(loop.factory, "create_model", never)
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}\\)"):
        _run(TINY_ARGS + flag)


def test_the_card_is_the_default_and_its_absence_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trains on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        loop.run_training(parse_args(TINY_ARGS))
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain_clip.main(TINY_ARGS)


def test_main_prints_final_metrics(capsys):
    m = pretrain_clip.main(TINY_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"final: {m}" in out
    assert "step 4/4 | epoch 0 | loss " in out


def test_tracker_of_a_jax_run_dir_is_read(jax_run):
    _, _, root = jax_run
    assert ckpt_io.latest_checkpoint_step(root) == 4
    assert ckpt_io.load_checkpoint_metadata(root) == {"consumed_samples": 64}


def test_background_save_swallows_an_on_commit_error(tmp_path):
    """The JAX package's finalize thread swallows an exception of the
    save's `on_commit` (`megatron_clip_tpu/checkpoints/io.py:93`, a
    reference defect on record in ADVICE.md): the port matches it. The
    checkpoint and its tracker are committed all the same; a blocking save
    raises it."""
    def boom():
        raise ValueError("on_commit failed")
    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(a.exc_type)
    try:
        ckpt_io.save_checkpoint(str(tmp_path), 3, {"w": torch.ones(2)},
                                {"consumed_samples": 6}, block=False,
                                on_commit=boom)
        ckpt_io.global_saver().wait()
    finally:
        threading.excepthook = hook
    assert errors == [ValueError]
    state, meta, step = ckpt_io.load_checkpoint(str(tmp_path))
    assert step == 3 and meta == {"consumed_samples": 6}
    assert torch.equal(state["w"], torch.ones(2))
    with pytest.raises(ValueError):
        ckpt_io.save_checkpoint(str(tmp_path), 4, {}, on_commit=boom)


def test_save_takes_its_copy_before_returning(tmp_path):
    w = torch.zeros(1000)
    ckpt_io.save_checkpoint(str(tmp_path), 1, {"w": w}, block=False)
    w += 1
    state, _, _ = ckpt_io.load_checkpoint(str(tmp_path))
    assert torch.equal(state["w"], torch.zeros(1000))


def test_val_metrics_match_jax(tmp_path):
    jmodel, jparams = jax_factory.create_model("test-tiny", precision="fp32",
                                               seed=0)
    port_model = loop.factory.create_model("test-tiny", precision="fp32",
                                           device="cpu")
    port_model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((12, 32, 32, 3)).astype(np.float32),
                rng.integers(1, 49405, (12, 32)).astype(np.int32))
               for _ in range(3)]
    want = jax_retrieval.contrastive_eval_metrics(jmodel, jparams, batches)
    got = retrieval.contrastive_eval_metrics(port_model, batches)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_device_ranks_match_the_host_and_the_jax_device_ranks():
    """Without ties the chunked device ranks are the host's argsort ranks;
    with ties (the host's argsort is not stable) they are the JAX device
    path's: earlier indices first."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((40, 8)).astype(np.float32)
    txt = rng.standard_normal((40, 8)).astype(np.float32)
    got = retrieval.recall_at_k_device(torch.from_numpy(img),
                                       torch.from_numpy(txt), 2.0, chunk=7)
    assert got == retrieval.recall_at_k(2.0 * img @ txt.T)
    txt[::3] = img[0]
    got = retrieval.recall_at_k_device(torch.from_numpy(img),
                                       torch.from_numpy(txt), 2.0, chunk=7)
    assert got == jax_retrieval.recall_at_k_device(img, txt, 2.0, chunk=7)
    flat = np.ones((10, 4), np.float32)  # collapsed: every logit tied
    got = retrieval.recall_at_k_device(torch.from_numpy(flat),
                                       torch.from_numpy(flat), 1.0)
    assert got["image_to_text_R@1"] == 0.1


def test_csv_run_reports_val_metrics(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(1)
    lines = ["filepath\ttitle"]
    for i in range(32):
        Image.fromarray(rng.randint(0, 255, (36, 30, 3), np.uint8)).save(
            tmp_path / f"{i}.png")
        lines.append(f"{i}.png\ta picture of thing {i}")
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(lines) + "\n")
    save = str(tmp_path / "ck")
    m = _run(BASE[2:] + ["--train-data", str(csv), "--val-data", str(csv),
                         "--save", save])
    assert m["step"] == 2 and m["val_num_samples"] == 32
    assert 0 <= m["val_image_to_text_R@1"] <= 1
    assert np.isfinite(m["val_clip_val_loss"])
    with open(os.path.join(save, "default", "results.jsonl")) as f:
        assert json.loads(f.readline())["epoch"] == 0


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_recompute_granularity_gives_the_same_steps(remat, record):
    """`--recompute-granularity` reaches both towers' blocks (the JAX
    loop's dataclasses.replace(model, remat=...)): the same losses and
    gradient norms as without recompute."""
    _run(TINY_ARGS + ["--log-interval", "1"])
    plain = list(record)
    record.clear()
    _run(TINY_ARGS + ["--log-interval", "1", "--recompute-granularity", remat])
    for got, want in zip(record, plain):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)


@pytest.mark.parametrize("flags", [
    [], ["--v-num-layers", "3", "--v-hidden-size", "96"],
    ["--v-patch-size", "16", "--v-image-size", "64"],
    ["--force-image-size", "48"], ["--force-quick-gelu"]])
def test_model_overrides_match_jax(flags):
    argv = TINY_ARGS + flags
    want = jax_loop._model_overrides(jax_params.parse_args(argv))
    if "--force-quick-gelu" in flags:
        want["quick_gelu"] = True  # the JAX factory's force_quick_gelu=
    assert loop._model_overrides(parse_args(argv)) == want
    model = loop.factory.create_model("test-tiny", precision="fp32",
                                      device="cpu", **want)
    vision = want.get("vision_cfg", {})
    for key in ("layers", "width", "patch_size", "image_size"):
        if key in vision:
            assert getattr(model.cfg.vision, key) == vision[key]
    assert model.cfg.quick_gelu == ("--force-quick-gelu" in flags)


def test_zero_shot_eval_at_the_epoch_end(tmp_path, monkeypatch):
    """--imagenet-val / --imagenet-v2 at the epoch's end, on a class-dir
    folder of PNGs and a 2-class metadata file ($MCT_IMAGENET_METADATA)."""
    from PIL import Image
    rng = np.random.RandomState(2)
    for c in ("cat", "dog"):
        (tmp_path / "val" / c).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.randint(0, 255, (40, 36, 3), np.uint8)).save(
                tmp_path / "val" / c / f"{i}.png")
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"classnames": ["cat", "dog"],
                                "templates": ["a photo of a {}."]}))
    monkeypatch.setenv("MCT_IMAGENET_METADATA", str(meta))
    val = str(tmp_path / "val")
    m = _run(TINY_ARGS + ["--imagenet-val", val, "--imagenet-v2", val,
                          "--zeroshot-frequency", "1"])
    for key in ("imagenet-zeroshot-val-top1", "v2_imagenet-zeroshot-val-top5"):
        assert 0.0 <= m[key] <= 1.0
    assert m["v2_imagenet-zeroshot-val-top5"] == 1.0  # 2 classes
