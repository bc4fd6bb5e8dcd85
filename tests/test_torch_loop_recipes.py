"""The port's CLIP trainer with the recipe flags (`--siglip`,
`--accum-freq`, `--force-patch-dropout`, `--lock-image`, `--lock-text`)
against the JAX package's, at `test-tiny` size on the CPU, as
`test_torch_loop.py::test_loop_matches_the_jax_loop` holds the plain run.

- Loop against loop: both `run_training`s on the same synthetic batches in
  fp32 for 4 steps, the JAX initial parameters carried into the port
  through `bridge.py`, each step's metrics recorded by wrapping each
  runner's `step`. Loss and logit_scale within 1e-6 relative at step 1 and
  1e-5 after, grad_norm within 1e-5 (the JAX run shards the batch over 8
  virtual devices and sums in another order). Patch dropout: `jax.random`
  streams cannot be reproduced in torch, so the port's step is given the
  indices the JAX step's keys draw (`jax_patch_ids`).
- The locked towers: every locked parameter bit-equal to its start after
  the run, every unlocked one moved. `--lock-image-freeze-bn-stats` and
  `--lock-text-freeze-layer-norm` are accepted and change nothing, as in
  the JAX loop.
- Resume with `--accum-freq 2 --lock-text` (and the SigLIP recipe with
  patch dropout and LiT on a `test-tiny` given a logit bias): a run saved
  at step 2 and resumed gives steps 3-4 bit-equal to the uninterrupted
  run.
"""
import os

import numpy as np
import pytest
import torch

from megatron_clip_tpu import factory as jax_factory
from megatron_clip_tpu.training import loop as jax_loop
from megatron_clip_tpu.training import params as jax_params
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
from megatron_clip_tpu_torch.training import loop
from megatron_clip_tpu_torch.training import train_step
from megatron_clip_tpu_torch.training.optim import tower_lock_mask
from megatron_clip_tpu_torch.training.params import parse_args
from torch_recipe_util import jax_patch_ids, one_thread  # noqa: F401

TINY_ARGS = [
    "--dataset-type", "synthetic", "--batch-size", "16", "--epochs", "1",
    "--warmup", "2", "--log-interval", "2", "--precision", "fp32",
    "--model", "test-tiny", "--train-num-samples", "64",
]

RECIPES = {
    "siglip-accum-patch-dropout": ["--siglip", "--accum-freq", "2",
                                   "--force-patch-dropout", "0.5"],
    "lit-accum-4": ["--lock-image", "--lock-image-unlocked-groups", "1",
                    "--lock-image-freeze-bn-stats", "--lock-text",
                    "--lock-text-unlocked-layers", "2",
                    "--lock-text-freeze-layer-norm", "--accum-freq", "4"],
}


def _recorded(monkeypatch, runner):
    """Each step's metrics as floats, recorded by wrapping `runner.step`."""
    steps = []
    step = runner.step

    def wrapped(self, images, texts):
        m = step(self, images, texts)
        steps.append({k: float(v) for k, v in m.items()})
        return m
    monkeypatch.setattr(runner, "step", wrapped)
    return steps


def _bridged(monkeypatch):
    """Make the port loop's model start from the JAX loop's parameters;
    returns the list the built model lands in."""
    _, jparams = jax_factory.create_model("test-tiny", precision="fp32",
                                          seed=0)
    create = loop.factory.create_model
    built = []

    def bridged(*args, **kw):
        model = create(*args, **kw)
        model.load_state_dict(params_from_jax(jparams, model.cfg))
        built.append(model)
        return model
    monkeypatch.setattr(loop.factory, "create_model", bridged)
    return built


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_loop_matches_the_jax_loop(name, monkeypatch):
    flags = RECIPES[name]
    want = _recorded(monkeypatch, jax_loop._JointRunner)
    jax_final = jax_loop.run_training(jax_params.parse_args(TINY_ARGS
                                                            + flags))
    got = _recorded(monkeypatch, loop._JointRunner)
    built = _bridged(monkeypatch)
    monkeypatch.setattr(train_step, "patch_keep_ids", jax_patch_ids)
    start = None

    def snapshot(*args, **kw):
        nonlocal start
        start = {n: p.detach().clone()
                 for n, p in built[0].named_parameters()}
        return make_optimizer(*args, **kw)
    make_optimizer = loop.make_optimizer
    monkeypatch.setattr(loop, "make_optimizer", snapshot)
    final = loop.run_training(parse_args(TINY_ARGS + flags), device="cpu")
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = 1e-6 if i == 0 else 1e-5
        for key in ("loss", "logit_scale"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5, err_msg=f"step {i + 1}")
    assert final["step"] == jax_final["step"] == 4
    np.testing.assert_allclose(final["loss"], jax_final["loss"], rtol=1e-5)
    model = built[0]
    args = parse_args(TINY_ARGS + flags)
    mask = tower_lock_mask(
        dict(model.named_parameters()), lock_image=args.lock_image,
        image_unlocked_groups=args.lock_image_unlocked_groups,
        lock_text=args.lock_text,
        text_unlocked_layers=args.lock_text_unlocked_layers)
    locked = [n for n, m in mask.items() if m == 0.0]
    assert bool(locked) == (name != "siglip-accum-patch-dropout")
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), start[n])
        assert same == (n in locked), n


@pytest.mark.parametrize("flags", [
    ["--accum-freq", "2", "--lock-text"],
    ["--siglip", "--accum-freq", "2", "--force-patch-dropout", "0.5",
     "--lock-image", "--lock-image-unlocked-groups", "2"]])
def test_recipe_resume_is_bit_equal_to_the_uninterrupted_run(
        tmp_path, monkeypatch, flags):
    record = _recorded(monkeypatch, loop._JointRunner)
    if "--siglip" in flags:
        monkeypatch.setitem(loop.factory._BUILTIN, "test-tiny", dict(
            loop.factory._BUILTIN["test-tiny"], init_logit_bias=-10.0))
    argv = TINY_ARGS[:-2] + ["--train-num-samples", "64", "--seed", "3",
                             "--log-interval", "1"] + flags

    def run(extra):
        return loop.run_training(parse_args(argv + extra), device="cpu")
    full = run([])
    straight = list(record)
    record.clear()
    root = str(tmp_path / "ck")
    run(["--save", root, "--name", "t", "--exit-interval", "2",
         "--save-interval", "2"])
    assert ckpt_io.latest_checkpoint_step(os.path.join(root, "t")) == 2
    record.clear()
    resumed = run(["--resume", os.path.join(root, "t")])
    assert resumed["step"] == full["step"] == 4
    assert record == straight[2:]
    assert resumed["loss"] == full["loss"]
    tree, _, _ = ckpt_io.load_checkpoint(os.path.join(root, "t"))
    assert ("logit_bias" in tree["params"]) == ("--siglip" in flags)


@pytest.mark.parametrize("rate", [None, "0", "0.5"])
def test_force_patch_dropout_override_matches_jax(rate):
    argv = TINY_ARGS + ([] if rate is None else
                        ["--force-patch-dropout", rate])
    want = jax_loop._model_overrides(jax_params.parse_args(argv))
    assert loop._model_overrides(parse_args(argv)) == want
    model = loop.factory.create_model("test-tiny", precision="fp32",
                                      device="cpu", **want)
    assert model.cfg.vision.patch_dropout == (0.0 if rate is None
                                              else float(rate))
