"""The port's GPT runtime (`training/workload.py`, `pretrain_gpt.py`,
`training/optim.py`'s megatron branches, `training/microbatches.py`)
against the JAX package's, and its run semantics, on the CPU.

- The parser: the JAX entry's options plus --device, and the same
  namespace and `runtime_cfg_from_args` fields for the megatron aliases,
  remaps and no-op flags.
- `megatron_lr` / `megatron_wd` at every step of each style against the
  JAX schedules: exactly the eager schedule's value, op by op (but the
  cosines: numpy's fp32 cos and XLA's differ by an ulp at some steps),
  and within 1e-6 relative plus two fp32 ulps of the peak rate of the
  jitted one's, where XLA contracts products into FMAs (near the cosine's
  end 1 + cos cancels, which turns an ulp of cos into more of the rate).
- SGD (with and without a decay schedule), AdamW with a decay schedule
  and the bf16-nu AdamW against optax for 3 steps on a GPT tree, fp32 and
  bf16 parameters. XLA fuses the lowbits update into FMAs, so an fp32 value
  can differ in its last bit and round a bf16 moment the other way: those
  parameters are held to a bf16 ulp of a moment's share of the updates.
- The microbatch calculators and `_BatchDrawer` against the JAX ones.
- A resume after a save bit-equal to the uninterrupted run (synthetic;
  indexed with accumulation and rampup); --load, --finetune,
  --no-load-optim / --no-save-optim, --exit-duration-in-mins, SIGTERM,
  --skip-train, --use-checkpoint-args and --sequence-parallel at tp 1.
- Every refusal names its ROADMAP Queue A item before a model is built;
  without a CUDA device and --device cpu the entry raises.
"""
import argparse
import dataclasses
import json
import os
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megatron_clip_tpu.models import gpt as jax_gpt
from megatron_clip_tpu.training import microbatches as jax_mb
from megatron_clip_tpu.training import optim as jax_optim
from megatron_clip_tpu.training import workload as jax_workload
from megatron_clip_tpu_torch import pretrain_gpt
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
from megatron_clip_tpu_torch.config import FP32, PURE_BF16
from megatron_clip_tpu_torch.models.gpt import GPTCfg, GPTModel
from megatron_clip_tpu_torch.training import microbatches as mb
from megatron_clip_tpu_torch.training import optim, workload
from torch_gpt_util import TINY, jax_pretrain_gpt, port_run, write_corpus

BASE = TINY + ["--batch-size", "8"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny GPT steps fastest on one thread, and the suite's workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_parser(argv):
    """The JAX entry's parser and its namespace for argv."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return parse(self, args, namespace)
    argparse.ArgumentParser.parse_args = capture
    try:
        ns = jax_pretrain_gpt.parse_args(argv)
    finally:
        argparse.ArgumentParser.parse_args = parse
    return seen["parser"], ns


def _options(parser):
    return {opt: (a.dest, a.default, a.nargs, a.choices, type(a).__name__)
            for a in parser._actions for opt in a.option_strings}


ARGVS = [
    [],
    ["--global-batch-size", "64", "--train-iters", "9", "--lr-warmup-iters",
     "3", "--clip-grad", "0.5", "--num-attention-heads", "8",
     "--num-query-groups", "2"],
    ["--bf16", "--recompute-activations", "--micro-batch-size", "4",
     "--rampup-batch-size", "8", "8", "100", "--use-flash-attn",
     "--distributed-backend", "nccl", "--no-data-sharding",
     "--dataloader-type", "cyclic", "--sampler-rng", "numpy"],
    ["--fp16", "--checkpoint-activations", "--train-samples", "100",
     "--lr-warmup-fraction", "0.25", "--lr-decay-iters", "40",
     "--nu-dtype", "bf16", "--optimizer", "sgd", "--adam-beta2", "0.9",
     "--weight-decay-incr-style", "cosine", "--start-weight-decay", "0.0",
     "--end-weight-decay", "0.2", "--tensor-model-parallel-size", "2"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_the_parser_is_the_jax_one_plus_device(argv):
    _, want = _jax_parser(argv)
    got = pretrain_gpt.parse_args(argv)
    assert vars(got).pop("device") is None
    assert vars(got) == vars(want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = workload.runtime_cfg_from_args(got, "gpt")
        jrc = jax_workload.runtime_cfg_from_args(want, "gpt")
    assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
    assert vars(got) == vars(want)  # the remaps, applied alike


def test_noop_flags_warn_and_fp16_maps_to_bf16():
    ns = pretrain_gpt.parse_args(["--fp16", "--use-flash-attn",
                                  "--loss-scale", "128"])
    with pytest.warns(UserWarning) as seen:
        workload.runtime_cfg_from_args(ns, "gpt")
    text = " ".join(str(w.message) for w in seen)
    assert "--use-flash-attn" in text and "--loss-scale" in text
    assert ns.precision == "bf16"


def test_the_parsers_options_are_the_jax_ones_plus_device():
    jparser, _ = _jax_parser([])
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return parse(self, args, namespace)
    argparse.ArgumentParser.parse_args = capture
    try:
        pretrain_gpt.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = parse
    mine, theirs = _options(seen["parser"]), _options(jparser)
    assert mine.pop("--device")[0] == "device"
    assert mine == theirs


STYLES = ["constant", "linear", "cosine", "inverse-square-root"]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("warmup,total,decay,min_lr", [
    (0, 20, None, 0.0), (5, 40, None, 1e-5), (10, 50, 30, 3e-5),
    (1, 7, 100, 0.0)])
def test_megatron_lr_equals_the_jax_schedule(style, warmup, total, decay,
                                             min_lr):
    kw = dict(decay_style=style, min_lr=min_lr, decay_steps=decay)
    got = optim.megatron_lr(3e-4, warmup, total, **kw)
    eager = jax_optim.megatron_lr(3e-4, warmup, total, **kw)
    jitted = jax.jit(eager)
    for step in range(total + 3):
        w = float(eager(step))
        if style == "cosine":
            np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=1e-12)
        else:
            assert got(step) == w, (step, got(step), w)
        np.testing.assert_allclose(got(step), float(jitted(step)),
                                   rtol=1e-6, atol=2 * 2 ** -35)


@pytest.mark.parametrize("style", ["constant", "linear", "cosine"])
def test_megatron_wd_equals_the_jax_schedule(style):
    got = optim.megatron_wd(0.01, 0.1, 25, style)
    eager = jax_optim.megatron_wd(0.01, 0.1, 25, style)
    jitted = jax.jit(eager)
    for step in range(28):
        w = float(eager(step))
        if style == "cosine":
            np.testing.assert_allclose(got(step), w, rtol=1e-6)
        else:
            assert got(step) == w, (step, got(step), w)
        np.testing.assert_allclose(got(step), float(jitted(step)),
                                   rtol=1e-6)


def test_unknown_styles_raise():
    with pytest.raises(ValueError, match="lr decay style"):
        optim.megatron_lr(1e-3, 1, 5, decay_style="exponential")
    with pytest.raises(ValueError, match="wd incr style"):
        optim.megatron_wd(0.0, 0.1, 5, "step")
    with pytest.raises(ValueError, match="does not compose"):
        optim.make_optimizer(torch.nn.Linear(2, 2), optim.constant_lr(1.0),
                             weight_decay=optim.megatron_wd(0, 1, 5,
                                                            "linear"),
                             nu_dtype=torch.bfloat16)


def _jax_tree(flat: dict, layers: int) -> dict:
    """A port state dict as the JAX GPT tree (the blocks stacked)."""
    tree, blocks = {}, {}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            d = tree
            for k in parts[:-1]:
                d = d.setdefault(k, {})
            d[parts[-1]] = t
        elif parts[1] == "0":
            d = blocks
            for k in parts[2:-1]:
                d = d.setdefault(k, {})
            d[parts[-1]] = np.stack([flat[".".join(["blocks", str(i)]
                                                   + parts[2:])]
                                     for i in range(layers)])
    tree["blocks"] = blocks
    return tree


OPT_CASES = {
    "sgd": dict(optimizer="sgd", sgd_momentum=0.9),
    "sgd-wd-schedule": dict(optimizer="sgd", sgd_momentum=0.8,
                            wd=("linear", 0.01, 0.1)),
    "adam-wd-schedule": dict(wd=("cosine", 0.0, 0.2)),
    "adam-nu-bf16": dict(nu_dtype=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizers_equal_optax(case, dtype):
    """3 steps of the JAX `make_optimizer` branch against the port's on a
    GPT tree and the same seeded gradients. XLA fuses each update into
    FMAs, so an fp32 parameter can differ by ulps of its values and of the
    rates' scale, and a bf16 one round the other way (one bf16 ulp); in the
    lowbits update a fused fp32 value can also round a bf16 moment the
    other way, which moves an element by a bf16 ulp of that moment's share
    of the updates: under 2^-7 of the sum of the learning rates."""
    spec = OPT_CASES[case]
    kw = dict(num_layers=2, hidden_size=32, num_heads=2, vocab_size=64,
              seq_length=16)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), jax_gpt.GPTCfg(**kw),
                              dtype=jd)
    model = GPTModel(GPTCfg(**kw), FP32 if td == torch.float32
                     else PURE_BF16).to(td)
    model.load_state_dict(gpt_params_from_jax(params, GPTCfg(**kw),
                                              dtype=td))
    init = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    lr, jlr = (optim.megatron_lr(1e-2, 1, 5, min_lr=1e-3),
               jax_optim.megatron_lr(1e-2, 1, 5, min_lr=1e-3))
    wd, jwd = 0.1, None
    if "wd" in spec:
        style, a, b = spec["wd"]
        wd, jwd = (optim.megatron_wd(a, b, 5, style),
                   jax_optim.megatron_wd(a, b, 5, style))
    common = dict(beta1=0.9, beta2=0.95, eps=1e-8, grad_clip_norm=1.0,
                  optimizer=spec.get("optimizer", "adam"),
                  sgd_momentum=spec.get("sgd_momentum", 0.9))
    tx = jax_optim.make_optimizer(
        params, jlr, weight_decay=0.1, weight_decay_schedule=jwd,
        nu_dtype=jnp.bfloat16 if spec.get("nu_dtype") else None, **common)
    opt = optim.make_optimizer(
        model, lr, weight_decay=wd,
        nu_dtype=torch.bfloat16 if spec.get("nu_dtype") else None, **common)
    jstate, state = tx.init(params), opt.init()

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
            np.float32) * 0.3).to(td) for n, p in model.named_parameters()}
        jg = jax.tree.map(lambda x: jnp.asarray(x, jd), _jax_tree(
            {n: t.float().numpy() for n, t in g.items()}, 2))
        params, jstate = jstep(params, jstate, jg)
        state, norm = opt.update(state, g)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(jg)), rtol=1e-6)
    want = gpt_params_from_jax(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), params), GPTCfg(**kw))
    lowbits = bool(spec.get("nu_dtype"))
    bound = 2 ** -7 * sum(lr(s) for s in range(3)) if lowbits else 0.0
    for name, p in model.named_parameters():
        assert p.dtype == td
        got, w = p.detach().float(), want[name]
        if td == torch.bfloat16:  # a parameter rounded the other way
            ulp = w.abs() * 2 ** -7
        else:  # XLA's FMAs: fp32 ulps of the values and of the rates
            ulp = ((w.abs() + init[name].abs()) * 2 ** -22
                   + 2 ** -20 * sum(lr(s) for s in range(3)))
        err = (got - w).abs()
        assert bool((err <= bound + ulp).all()), (name, float(err.max()))
    assert state.count == 3 and state.schedule_count == 3


def test_adam_nu_bf16_stores_bf16_moments():
    model = torch.nn.Linear(4, 3)
    opt = optim.make_optimizer(model, optim.constant_lr(1e-3),
                               nu_dtype=torch.bfloat16)
    st = opt.init()
    assert {t.dtype for t in st.mu.values()} == {torch.bfloat16}
    assert {t.dtype for t in st.nu.values()} == {torch.bfloat16}
    st, _ = opt.update(st, {n: torch.ones_like(p)
                            for n, p in model.named_parameters()})
    assert {t.dtype for t in st.nu.values()} == {torch.bfloat16}


@pytest.mark.parametrize("rampup", [None, (8, 8, 100), (16, 16, 48),
                                    (4, 4, 7)])
def test_microbatch_calculators_equal_the_jax_ones(rampup):
    args = (32, 4, 1, rampup)
    got = mb.build_num_microbatches_calculator(*args)
    want = jax_mb.build_num_microbatches_calculator(*args)
    for consumed in range(0, 300, 7):
        got.update(consumed)
        want.update(consumed)
        assert got.get() == want.get()
        assert got.current_global_batch_size() == \
            want.current_global_batch_size()
    with pytest.raises(ValueError):
        mb.build_num_microbatches_calculator(30, 4, 1, None)


def test_batch_drawer_equals_the_jax_one():
    def stream():
        for i in range(100):
            yield {"tokens": np.arange(8 * i, 8 * i + 8).reshape(8, 1)
                   * np.ones((1, 3), np.int64), "step": np.int64(i)}
    got = workload._BatchDrawer(stream(), 8)
    want = jax_workload._BatchDrawer(stream(), 8)
    got.skip_rows(3)
    want.skip_rows(3)
    for n in (5, 8, 13, 1, 16, 24, 3):
        g, w = got.draw(n), want.draw(n)
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        assert int(g["step"]) == int(w["step"])
    arrays = workload._BatchDrawer(iter([np.arange(4), np.arange(4, 8)]), 4)
    np.testing.assert_array_equal(arrays.draw(3), [0, 1, 2])
    np.testing.assert_array_equal(arrays.draw(3), [3, 4, 5])


def _losses(out):
    return [v for _, v in out["history"]]


def _set_tracker(root: str, step: int) -> None:
    """The run as if cut before its later saves committed."""
    with open(os.path.join(root, ckpt_io.TRACKER_FILENAME), "w") as f:
        f.write(str(step))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus") / "c")


@pytest.mark.parametrize("extra", [
    ["--train-steps", "4"],
    ["--train-steps", "5", "--data-path", "{corpus}", "--split", "8,2,0",
     "--micro-batch-size", "2", "--rampup-batch-size", "2", "2", "24",
     "--batch-size", "8", "--dataloader-type", "cyclic", "--nu-dtype",
     "bf16", "--hidden-dropout", "0.1"]])
def test_a_resume_is_bit_equal_to_the_whole_run(extra, corpus, tmp_path):
    """Saved at step 2 (in the background) and resumed there: the later
    steps' losses bit for bit, with the rampup's consumed samples (a
    source batch's rows carried) and the dropout seeds of the steps."""
    extra = [a.format(corpus=corpus) for a in extra]
    whole = port_run(BASE + extra)
    root = str(tmp_path / "ck")
    port_run(BASE + extra + ["--save", root, "--save-interval", "2"])
    meta = json.load(open(os.path.join(root, "iter_0000002",
                                       "metadata.json")))
    assert meta["args"]["num_layers"] == 2 and "device" in meta["args"]
    _set_tracker(root, 2)
    resumed = port_run(BASE + extra + ["--save", root, "--resume"])
    assert [i for i, _ in resumed["history"]] == list(
        range(3, whole["last_step"] + 1))
    assert _losses(resumed) == _losses(whole)[2:]


def test_load_and_finetune(tmp_path):
    """--load continues another root's run (optimizer and iteration);
    --finetune takes its parameters only, from step 1 with a fresh
    optimizer; the parameters really are the checkpoint's."""
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    whole = port_run(BASE + ["--train-steps", "4"])
    port_run(BASE + ["--train-steps", "2", "--save", src])
    cont = port_run(BASE + ["--train-steps", "4", "--load", src, "--save",
                            dst])
    assert _losses(cont) == _losses(whole)[2:]
    assert ckpt_io.latest_checkpoint_step(dst) == 4
    ft = port_run(BASE + ["--train-steps", "2", "--load", src,
                          "--finetune"])
    assert [i for i, _ in ft["history"]] == [1, 2]
    scratch = port_run(BASE + ["--train-steps", "2"])
    assert abs(ft["history"][0][1] - scratch["history"][0][1]) > 1e-4


def test_no_save_optim_and_no_load_optim(tmp_path):
    root = str(tmp_path / "ck")
    port_run(BASE + ["--train-steps", "3", "--save", root,
                     "--no-save-optim"])
    state = torch.load(os.path.join(root, "iter_0000003", "state.pt"),
                       weights_only=True)
    assert set(state) == {"params"}
    with pytest.raises(ValueError, match="--no-load-optim"):
        port_run(BASE + ["--train-steps", "5", "--save", root, "--resume"])
    out = port_run(BASE + ["--train-steps", "5", "--save", root, "--resume",
                           "--no-load-optim"])
    assert out["history"][0][0] == 4 and np.isfinite(out["loss"])


def test_exit_duration_saves_and_stops(tmp_path):
    root = str(tmp_path / "ck")
    out = port_run(BASE + ["--train-steps", "50", "--save", root,
                           "--exit-duration-in-mins", "0"])
    assert ckpt_io.latest_checkpoint_step(root) == 1
    assert len(out["history"]) == 1


def test_sigterm_saves_and_stops(tmp_path, monkeypatch):
    """A SIGTERM during step 2: the loop saves step 2 and exits; the
    handler before the run is restored after it."""
    step = workload._Runner.step

    def signalled(self, batch, i):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, batch, i)
    monkeypatch.setattr(workload._Runner, "step", signalled)
    before = signal.getsignal(signal.SIGTERM)
    root = str(tmp_path / "ck")
    out = port_run(BASE + ["--train-steps", "6", "--save", root])
    assert out["last_step"] == 2 and ckpt_io.latest_checkpoint_step(root) \
        == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_skip_train_evaluates_the_loaded_model(tmp_path):
    root = str(tmp_path / "ck")
    trained = port_run(BASE + ["--train-steps", "2", "--save", root,
                               "--eval-interval", "2", "--eval-iters", "2"])
    out = port_run(BASE + ["--train-steps", "2", "--load", root,
                           "--skip-train", "--eval-iters", "2"])
    assert out["history"] == [] and out["val_loss"] == trained["val_loss"]


def test_use_checkpoint_args_restores_the_architecture(tmp_path):
    arch = ["--num-layers", "2", "--hidden-size", "48", "--num-heads", "4"]
    common = ["--seq-length", "32", "--vocab-size", "256", "--batch-size",
              "8", "--log-interval", "1", "--precision", "fp32", "--seed",
              "3"]
    root = str(tmp_path / "ck")
    whole = port_run(arch + common + ["--train-steps", "4"])
    port_run(arch + common + ["--train-steps", "2", "--save", root])
    resumed = port_run(common + ["--train-steps", "4", "--save", root,
                                 "--resume", "--use-checkpoint-args"])
    assert _losses(resumed) == _losses(whole)[2:]
    with pytest.raises(SystemExit):
        port_run(common + ["--train-steps", "1", "--use-checkpoint-args"])


def test_sequence_parallel_at_tp_1_changes_nothing():
    """As in the JAX package, whose sequence sharding is over the tensor
    axis (of size 1 here)."""
    argv = BASE + ["--train-steps", "2"]
    assert _losses(port_run(argv + ["--sequence-parallel"])) == \
        _losses(port_run(argv))


def test_params_norm_and_zeros_in_grad_are_logged(capsys):
    port_run(BASE + ["--train-steps", "1", "--log-params-norm",
                     "--log-num-zeros-in-grad"])
    out = capsys.readouterr().out
    assert "| params norm " in out and "| num zeros " in out


@pytest.mark.parametrize("flag,item", [
    (["--tensor-model-parallel-size", "2"], 5),
    (["--fsdp-parallel-size", "2"], 5),
    (["--pipeline-model-parallel-size", "2"], 5),
    (["--virtual-pipeline-parallel-size", "2"], 5),
    (["--context-parallel-size", "2"], 5),
    (["--dcn-data-parallel-size", "2"], 5),
    (["--tensorboard-dir", "tb"], 7),
    (["--profile"], 7),
    (["--eod-mask-loss", "--eod-token", "0"], 4),
    (["--reset-position-ids", "--eod-token", "0"], 4),
    (["--reset-attention-mask", "--eod-token", "0"], 4),
    (["--quantize-matmuls", "int8"], 4),
    (["--kv-channels", "8"], 4),
    (["--squared-relu"], 4),
    (["--num-experts", "4"], 4),
    (["--tokenizer-model", "sp.model"], 4),
    (["--vocab-file", "vocab.txt"], 7),
])
def test_refused_flags_name_their_queue_item(flag, item, monkeypatch):
    def never(*a, **k):
        raise AssertionError("built a model before refusing")
    monkeypatch.setattr(pretrain_gpt, "create_gpt", never)
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        port_run(BASE + ["--train-steps", "1"] + flag)


def test_a_torchrun_launch_of_two_processes_is_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(pretrain_gpt, "create_gpt", None)
    with pytest.raises(NotImplementedError, match="Queue A item 5\\)"):
        port_run(BASE + ["--train-steps", "1"])


def test_the_card_is_the_default_and_its_absence_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trains on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain_gpt.main(BASE + ["--train-steps", "1"])
    out = pretrain_gpt.main(BASE + ["--train-steps", "1", "--device",
                                    "cpu"])
    assert f"final: {out}" in capsys.readouterr().out
