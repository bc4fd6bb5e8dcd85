"""Helpers shared by the recipe tests of the port (`test_torch_recipes.py`,
`test_torch_patch_dropout.py`, `test_torch_accum.py`,
`test_torch_accum_patch_dropout.py`, `test_torch_loop_recipes.py`): the
small model both packages build, its seeded batch, JAX's patch-dropout
indices, and the accumulated-step check against the JAX step. The files
stay apart so that each runs within 60 s on one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_clip_tpu as mct
from megatron_clip_tpu import losses as jax_losses
from megatron_clip_tpu.training import optim as jax_optim
from megatron_clip_tpu.training import train_step as jax_ts
import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch import losses
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.models.vit import patch_keep_count
from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                              make_optimizer, make_train_step)

SMALL = dict(
    embed_dim=64,
    vision_cfg={"image_size": 32, "layers": 2, "width": 64, "head_width": 32,
                "patch_size": 8},
    text_cfg={"context_length": 16, "vocab_size": 512, "width": 64,
              "heads": 2, "layers": 2})
BATCH = 8
LR = dict(base_lr=5e-3, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The small steps run fastest on one thread, and the suite's workers
    share the machine's cores. Autouse in every module that imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def jax_patch_ids(seed, step, microbatch, rows, patches, rate):
    """The kept patch indices of the JAX step's forward: the key of
    `make_train_step`'s `_pd_kw` and `apply_vit`'s draw from it."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 1013), step)
    if microbatch is not None:
        key = jax.random.fold_in(key, microbatch)
    noise = jax.random.uniform(key, (rows, patches))
    ids = jnp.argsort(noise, axis=1)[:, :patch_keep_count(patches, rate)]
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


def jax_model(overrides=SMALL, seed=0, **extra):
    """The JAX ViT-B-32 at `overrides`, its zero biases and unit gains
    perturbed so that every parameter path carries signal."""
    jmodel, params = mct.create_model("ViT-B-32", precision="fp32",
                                      seed=seed, **overrides, **extra)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(np.asarray(v, np.float32) + 0.05 * rng.standard_normal(
        np.shape(v)).astype(np.float32)) for v in leaves]
    params = jax.tree.unflatten(treedef, leaves)
    if "logit_bias" in params:
        params["logit_bias"] = jnp.asarray(extra["init_logit_bias"],
                                           jnp.float32)
    return jmodel, params


def port_model(jmodel, jparams, overrides=SMALL, **extra):
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **overrides, **extra)
    model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
    return model.train()


def batch(seed=1, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 512 - 2, (n, 16)).astype(np.int32)
    return images, texts


def assert_params(model, jparams, cfg, atol, loose, frac):
    """Every parameter within `loose` of JAX's, and `frac` of all elements
    within `atol`."""
    want = params_from_jax(jparams, cfg)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    tight = total = 0
    for name, w in want.items():
        g, w = got[name].detach().numpy(), w.numpy()
        close(g, w, 0, loose, name)
        tight += int((np.abs(g - w) <= atol).sum())
        total += g.size
    assert tight >= frac * total, (tight, total)


def check_accumulated_steps(microbatches, loss, patch_dropout=0.0):
    """Three fp32 steps of the port's `make_train_step(microbatches=M)`
    against JAX's on the same weights and batch, at the tolerances of
    `test_train_step_matches_jax_three_fp32_steps`. With patch dropout the
    caller makes the port's step draw `jax_patch_ids`. Under SigLIP the
    bias stays at its init on both sides (the reference defect kept for
    parity: the JAX step never gives the loss the bias)."""
    over = dict(SMALL, vision_cfg=dict(SMALL["vision_cfg"],
                                       patch_dropout=patch_dropout))
    extra = {"init_logit_bias": -10.0} if loss == "siglip" else {}
    jmodel, jparams = jax_model(over, **extra)
    model = port_model(jmodel, jparams, over, **extra)
    images, texts = batch()
    jloss = jax_losses.SigLipLoss() if loss == "siglip" \
        else jax_losses.ClipLoss()
    ploss = losses.SigLipLoss() if loss == "siglip" else losses.ClipLoss()
    tx = jax_optim.make_optimizer(
        jparams, jax_optim.cosine_lr(*LR.values()), grad_clip_norm=1.0)
    jstate = jax_ts.TrainState.create(jparams, tx)
    jstep = jax_ts.make_train_step(jmodel, tx, loss_obj=jloss,
                                   microbatches=microbatches, seed=11)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_obj=ploss,
                           microbatches=microbatches, seed=11)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
        state, m = step(state, images, texts)
        tol = 1e-6 if i == 0 else 1e-5
        close(float(m["loss"]), float(jm["loss"]), tol, what=f"loss {i}")
        close(float(m["logit_scale"]), float(jm["logit_scale"]), tol,
              what=f"logit_scale {i}")
        close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-5,
              what=f"grad_norm {i}")
    assert state.step == 3
    assert_params(model, jstate.params, jmodel.cfg, atol=1e-6,
                  loose=3 * 2 * LR["base_lr"], frac=0.99)
    if loss == "siglip":  # the matched defect: the bias never moves
        assert float(model.logit_bias.detach()) == -10.0
        assert float(jstate.params["logit_bias"]) == -10.0
