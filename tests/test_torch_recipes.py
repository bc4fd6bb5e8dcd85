"""The CLIP trainer's recipe modules in the port against the JAX package, at
a small size on the CPU, in fp32: SigLIP's loss, model and config, the text
tower's pooling and causal switch, the top-level config keys, and the LiT
tower lock. Patch dropout is in `test_torch_patch_dropout.py`, the
accumulated step in `test_torch_accum.py`.

- `SigLipLoss` within `test_clip_loss_and_gradients_match_jax`'s
  tolerances (loss 1e-6 relative; gradients 1e-5 relative, 1e-6 absolute).
- Features within 2e-5 (the CLIP features' tolerance of ROADMAP's parity
  rules); `tower_lock_mask` exactly, leaf for leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_clip_tpu as mct
from megatron_clip_tpu import losses as jax_losses
from megatron_clip_tpu.factory import create_loss as jax_create_loss
from megatron_clip_tpu.models.clip import apply_clip
from megatron_clip_tpu.models.text import apply_text
from megatron_clip_tpu.training import optim as jax_optim
import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch import factory, losses
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.training import cosine_lr, make_optimizer
from megatron_clip_tpu_torch.training.optim import tower_lock_mask
from torch_recipe_util import (SMALL, batch, close, jax_model, one_thread,
                               port_model)  # noqa: F401


def _features(seed, n=6, d=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        f = rng.standard_normal((n, d)).astype(np.float32)
        out.append(f / np.linalg.norm(f, axis=-1, keepdims=True))
    return out


# ---------------------------------------------------------------- SigLIP


@pytest.mark.parametrize("bias", [None, -10.0, 2.5])
def test_siglip_loss_and_gradients_match_jax(bias):
    img, txt = _features(2)
    scale = np.float32(10.0)
    args = (img, txt, scale) + (() if bias is None else (np.float32(bias),))

    def jloss(*a):
        return jax_losses.SigLipLoss()(*a)
    want, want_g = jax.value_and_grad(jloss, argnums=tuple(
        range(len(args))))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = losses.SigLipLoss()(*ts)
    got.backward()
    close(float(got.detach()), float(want), 1e-6)
    for t, w in zip(ts, want_g):
        close(t.grad.numpy(), np.asarray(w), 1e-5, 1e-6)


@pytest.mark.parametrize("flags,kind", [
    ({}, "ClipLoss"), ({"siglip": True}, "SigLipLoss"),
    ({"local_loss": True, "gather_with_grad": True}, "ClipLoss"),
    ({"siglip": True, "model": "ViT-B-16-SigLIP"}, "SigLipLoss")])
def test_create_loss_dispatches_as_the_jax_factory(flags, kind):
    class Args:
        pass
    args = Args()
    for k, v in flags.items():
        setattr(args, k, v)
    assert type(jax_create_loss(args)).__name__ == kind
    assert type(factory.create_loss(args)).__name__ == kind


@pytest.mark.parametrize("flags,item", [({"model": "coca_ViT-B-32"}, 2),
                                        ({"distill_model": "ViT-B-32"}, 3)])
def test_create_loss_still_refuses_coca_and_distillation(flags, item):
    class Args:
        pass
    args = Args()
    for k, v in flags.items():
        setattr(args, k, v)
    with pytest.raises(NotImplementedError,
                       match=rf"Queue A item {item}\)"):
        factory.create_loss(args)


SIGLIP_TWO_LAYERS = dict(
    vision_cfg={"image_size": 224, "layers": 2, "width": 768,
                "patch_size": 16},
    text_cfg={"context_length": 64, "vocab_size": 49408, "width": 768,
              "heads": 12, "layers": 2, "no_causal_mask": True,
              "pool_type": "last"})


def test_siglip_model_matches_jax_at_two_layers_a_tower():
    """ViT-B-16-SigLIP at its full widths with two layers a tower: the
    features, the temperature and the logit bias against JAX's
    `create_model("ViT-B-16-SigLIP")` given the same weights, and the
    config the port builds."""
    jmodel, jparams = mct.create_model("ViT-B-16-SigLIP", precision="fp32",
                                       seed=0, **SIGLIP_TWO_LAYERS)
    model = port.create_model("ViT-B-16-SigLIP", precision="fp32",
                              device="cpu", **SIGLIP_TWO_LAYERS)
    assert model.cfg.text.no_causal_mask and model.cfg.text.pool_type == \
        "last" and model.cfg.init_logit_bias == -10.0
    model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    ids = rng.integers(1, 49406, (2, 64)).astype(np.int32)
    want = apply_clip(jparams, jnp.asarray(images), jnp.asarray(ids),
                      jmodel.cfg, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = model(images, ids)
    for key in ("image_features", "text_features"):
        close(got[key].numpy(), np.asarray(want[key]), 0, 2e-5, key)
    close(float(got["logit_scale"]), float(want["logit_scale"]), 1e-7)
    assert float(got["logit_bias"].detach()) == float(want["logit_bias"]) \
        == -10.0


TEXT = {"context_length": 16, "vocab_size": 512, "width": 64, "heads": 2,
        "layers": 2}


@pytest.mark.parametrize("pool", ["argmax", "first", "last", "none"])
@pytest.mark.parametrize("causal", [True, False])
def test_text_pool_types_match_jax(pool, causal):
    text_cfg = dict(TEXT, pool_type=pool, no_causal_mask=not causal)
    over = dict(SMALL, text_cfg=text_cfg)
    jmodel, jparams = jax_model(over)
    model = port_model(jmodel, jparams, over)
    _, ids = batch(4, 3)
    want = apply_text(jparams["text"], jnp.asarray(ids), jmodel.cfg.text,
                      jmodel.cfg.embed_dim, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = model.text(torch.from_numpy(ids).long(), torch.float32)
    assert got.shape == want.shape
    close(got.numpy(), np.asarray(want), 0, 2e-5)


def test_unknown_text_pool_type_is_a_value_error():
    with pytest.raises(ValueError, match="pool_type"):
        port.create_model("ViT-B-32", precision="fp32", device="cpu",
                          text_cfg=dict(TEXT, pool_type="mean"))


# ------------------------------------------------------ top-level config


@pytest.mark.parametrize("precision", ["fp32", "pure_bf16"])
def test_init_logit_bias_matches_jax(precision):
    """`init_logit_bias`, which the port's factory once dropped in silence,
    builds a `logit_bias` equal to JAX's, fp32 under every precision as
    logit_scale is, which the bridge carries and `forward` returns."""
    jmodel, jparams = mct.create_model("ViT-B-32", precision=precision,
                                       init_logit_bias=-10.0, **SMALL)
    model = port.create_model("ViT-B-32", precision=precision, device="cpu",
                              init_logit_bias=-10.0, **SMALL)
    assert model.logit_bias.dtype == torch.float32
    assert float(model.logit_bias.detach()) == \
        float(jparams["logit_bias"]) == -10.0
    state = params_from_jax(jparams, jmodel.cfg)
    assert float(state["logit_bias"]) == -10.0
    model.load_state_dict(state)
    images, ids = batch(7, 2)
    with torch.no_grad():
        out = model(images, ids)
    assert float(out["logit_bias"]) == -10.0
    plain = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **SMALL)
    assert not hasattr(plain, "logit_bias")
    assert "logit_bias" not in plain(images, ids)


def test_top_level_keys_the_jax_factory_reads_are_taken_or_refused():
    """Every top-level key the JAX factory's `parse_model_cfg` reads is
    taken by the port or refused naming its ROADMAP Queue A item; a key
    the JAX factory ignores is ignored by both."""
    read = {"embed_dim", "vision_cfg", "text_cfg", "multimodal_cfg",
            "quick_gelu", "init_logit_bias"}
    taken = {"embed_dim", "vision_cfg", "text_cfg", "quick_gelu",
             "init_logit_bias"}
    assert read - taken == {"multimodal_cfg"}
    with pytest.raises(NotImplementedError,
                       match=r"multimodal_cfg.*ROADMAP Queue A item 7\)"):
        port.create_model("ViT-B-32", precision="fp32", device="cpu",
                          multimodal_cfg={"width": 64})
    mct.create_model("ViT-B-32", precision="fp32", custom_text=True,
                     **SMALL)
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              custom_text=True, **SMALL)
    assert model.cfg.embed_dim == 64


# ----------------------------------------------------------------- LiT


@pytest.mark.parametrize("lock", [
    dict(lock_image=True),
    dict(lock_image=True, image_unlocked_groups=1),
    dict(lock_image=True, image_unlocked_groups=2),
    dict(lock_image=True, image_unlocked_groups=3),
    dict(lock_image=True, image_unlocked_groups=5),
    dict(lock_text=True),
    dict(lock_text=True, text_unlocked_layers=1),
    dict(lock_text=True, text_unlocked_layers=4),
    dict(lock_image=True, image_unlocked_groups=2, lock_text=True,
         text_unlocked_layers=3),
    dict()])
def test_tower_lock_mask_matches_jax(lock):
    over = dict(SMALL, vision_cfg=dict(SMALL["vision_cfg"], layers=3))
    jmodel, jparams = mct.create_model("ViT-B-32", precision="fp32",
                                       init_logit_bias=-10.0, **over)
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              init_logit_bias=-10.0, **over)
    want = jax_optim.tower_lock_mask(jparams, **lock)
    got = tower_lock_mask(dict(model.named_parameters()), **lock)
    assert got.keys() == params_from_jax(jparams, jmodel.cfg).keys()
    for name, m in got.items():
        # the JAX leaf: a stacked block leaf's multiplier is [L, 1, ...]
        parts, layer = name.split("."), None
        if "blocks" in parts:
            layer = int(parts.pop(parts.index("blocks") + 1))
        w = want
        for part in parts:
            w = w[part]
        w = np.asarray(w)
        if layer is not None and w.ndim:
            w = w[layer]
        assert w.size == 1 and m == float(w.flat[0]), name


def test_tower_lock_mask_needs_blocks_for_unlocked_groups():
    with pytest.raises(ValueError, match="blocks"):
        tower_lock_mask({"visual.proj": torch.zeros(2, 2)},
                        lock_image=True, image_unlocked_groups=1)


def test_locked_update_is_zero_but_moments_and_norm_see_the_gradient():
    """The mask is the chain's last step: a locked parameter keeps its
    value, its moments move, and its gradient counts in the global norm."""
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **SMALL)
    params = dict(model.named_parameters())
    mask = tower_lock_mask(params, lock_image=True)
    opt = make_optimizer(model, cosine_lr(1e-3, 1, 10), grad_clip_norm=1.0,
                         lock_mask=mask)
    free = make_optimizer(model, cosine_lr(1e-3, 1, 10), grad_clip_norm=1.0)
    gen = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in params.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    state, norm = opt.update(opt.init(), grads)
    assert float(norm) == float(free.global_norm(grads))
    for n, p in params.items():
        if mask[n] == 0.0:
            assert n.startswith("visual.")
            assert torch.equal(p.detach(), before[n]), n
            assert float(state.mu[n].abs().max()) > 0, n
        else:
            assert not torch.equal(p.detach(), before[n]), n


