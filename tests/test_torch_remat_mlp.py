"""remat="mlp" (megatron --recompute-granularity mlp) in the port, on the
CPU.

- The GPT loss and gradients under remat="mlp" against the JAX package's
  (`_dots_except_mlp_up_policy`), fp32, gelu and swiglu blocks, at the
  bounds of test_torch_gpt.py; and bit-equal to the port's remat="none"
  (and "selective"), with hidden dropout on, whose seeds replay.
- What is recomputed: in the backward, remat="mlp" runs one matrix
  product a block more than "selective", and it is the MLP up-projection
  (weight [W, mlp_in]); "selective" runs none again.
- The CLIP trainer with --recompute-granularity mlp against the JAX loop
  with the same flag, 4 fp32 steps of test-tiny from the same weights
  (loss and logit_scale within 1e-6 relative at step 1 and 1e-5 after, as
  test_torch_loop.py holds the trainer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from megatron_clip_tpu import factory as jax_factory
from megatron_clip_tpu.models import gpt as jax_gpt
from megatron_clip_tpu.training import loop as jax_loop
from megatron_clip_tpu.training import params as jax_params
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax, params_from_jax
from megatron_clip_tpu_torch.config import FP32
from megatron_clip_tpu_torch.models.gpt import GPTCfg, GPTModel, gpt_loss
from megatron_clip_tpu_torch.training import loop
from megatron_clip_tpu_torch.training.params import parse_args

CONFIGS = {
    "gelu": dict(num_layers=2, hidden_size=64, num_heads=2, vocab_size=256,
                 seq_length=64),
    "swiglu": dict(num_layers=3, hidden_size=64, num_heads=4, vocab_size=256,
                   seq_length=64, swiglu=True, normalization="rmsnorm",
                   use_bias=False),
}


def _setup(kw, seed=0, **extra):
    jcfg, pcfg = jax_gpt.GPTCfg(**kw), GPTCfg(**kw, **extra)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(seed), jcfg)
    model = GPTModel(pcfg, FP32)
    model.load_state_dict(gpt_params_from_jax(params, pcfg))
    tokens = np.random.default_rng(seed + 1).integers(
        0, kw["vocab_size"], (2, kw["seq_length"] + 1))
    return jcfg, pcfg, params, model, tokens


@pytest.mark.parametrize("config", list(CONFIGS))
def test_mlp_remat_matches_the_jax_one(config):
    jcfg, pcfg, params, model, tokens = _setup(CONFIGS[config])
    tcfg = jcfg.transformer(remat="mlp", train=True)
    want, want_g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
        p, jnp.asarray(tokens, jnp.int32), jcfg, tcfg=tcfg,
        compute_dtype=jnp.float32))(params)
    got = gpt_loss(model, torch.from_numpy(tokens), remat="mlp")
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = gpt_params_from_jax(jax.tree.map(np.asarray, want_g), pcfg)
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_mlp_remat_is_bit_equal_to_no_remat(config):
    *_, model, tokens = _setup(CONFIGS[config], seed=2, hidden_dropout=0.1)
    t = torch.from_numpy(tokens)
    runs = {}
    for remat in ("none", "selective", "mlp"):
        model.zero_grad(set_to_none=True)
        loss = gpt_loss(model, t, loss_seq_chunk=32, seed=7, remat=remat)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad.clone()
                                       for n, p in model.named_parameters()})
    loss, grads = runs["none"]
    for remat in ("selective", "mlp"):
        assert torch.equal(runs[remat][0], loss), remat
        for name, g in grads.items():
            assert torch.equal(runs[remat][1][name], g), (remat, name)


class _Products(TorchDispatchMode):
    """The weight shapes of the matrix products run inside the mode."""

    def __init__(self):
        super().__init__()
        self.weights = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.weights.append(tuple(args[-1].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_only_the_up_projection_is_recomputed(config):
    kw = CONFIGS[config]
    *_, model, tokens = _setup(kw)
    w, layers = kw["hidden_size"], kw["num_layers"]
    up = (w, 4 * w * (2 if kw.get("swiglu") else 1))
    seen = {}
    for remat in ("none", "selective", "mlp"):
        loss = gpt_loss(model, torch.from_numpy(tokens), remat=remat)
        with _Products() as mode:
            loss.backward()
        seen[remat] = sorted(mode.weights)
    assert seen["selective"] == seen["none"]
    extra = list(seen["mlp"])
    for shape in seen["selective"]:
        extra.remove(shape)
    assert extra == [up] * layers


TINY_ARGS = [
    "--dataset-type", "synthetic", "--batch-size", "16", "--epochs", "1",
    "--warmup", "2", "--log-interval", "2", "--precision", "fp32",
    "--model", "test-tiny", "--train-num-samples", "64",
    "--recompute-granularity", "mlp",
]


def _recorded(runner_cls, steps):
    step = runner_cls.step

    def wrapped(self, images, texts):
        m = step(self, images, texts)
        steps.append({k: float(v) for k, v in m.items()})
        return m
    return step, wrapped


def test_the_clip_trainer_with_mlp_remat_matches_the_jax_loop(monkeypatch):
    want = []
    step, wrapped = _recorded(jax_loop._JointRunner, want)
    jax_loop._JointRunner.step = wrapped
    try:
        jax_loop.run_training(jax_params.parse_args(TINY_ARGS))
    finally:
        jax_loop._JointRunner.step = step
    jmodel, jparams = jax_factory.create_model("test-tiny", precision="fp32",
                                               seed=0)
    create = loop.factory.create_model

    def bridged(*args, **kw):
        model = create(*args, **kw)
        model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
        return model
    monkeypatch.setattr(loop.factory, "create_model", bridged)
    got = []
    _, wrapped = _recorded(loop._JointRunner, got)
    monkeypatch.setattr(loop._JointRunner, "step", wrapped)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loop.run_training(parse_args(TINY_ARGS), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "logit_scale"):
            np.testing.assert_allclose(g[key], w[key],
                                       rtol=1e-6 if i == 0 else 1e-5,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5)
