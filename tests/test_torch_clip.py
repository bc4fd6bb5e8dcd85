"""The port's serving slice vs the JAX package, at a small size.

The same shrunken ViT-B-32 (2 layers per tower, width 128) is built on both
sides, the JAX weights are carried into the port through
`bridge.params_from_jax`, and the same numpy images and token ids go through
both: image and text features, logit_scale, and the zero-shot classifier and
logits over a few ImageNet classes x the 7 simple templates. fp32 on the CPU;
features held to 2e-5. Under the bf16 policy both packages round at the
same points except the biased linears (the port rounds product plus bias
once, the JAX package rounds the product and adds the bias in bf16): the
normalised bf16 features agree within 5e-3 and at cosine >= 0.9999.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_clip_tpu as mct
from megatron_clip_tpu.evaluation import zero_shot as jax_zs
from megatron_clip_tpu.models.clip import apply_clip
import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.evaluation import zero_shot as port_zs

OVERRIDES = dict(
    embed_dim=128,
    vision_cfg={"image_size": 64, "layers": 2, "width": 128,
                "head_width": 64, "patch_size": 16},
    text_cfg={"width": 128, "heads": 2, "layers": 2})
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    jmodel, jparams = mct.create_model("ViT-B-32", precision="fp32", seed=3,
                                       **OVERRIDES)
    # perturb the zero-initialised biases and unit LN scales so every
    # parameter path is exercised
    leaves, treedef = jax.tree.flatten(jparams)
    rng = np.random.default_rng(0)
    leaves = [jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(
        np.shape(v)).astype(np.float32)) for v in leaves]
    jparams = jax.tree.unflatten(treedef, leaves)
    tmodel = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                               **OVERRIDES)
    tmodel.load_state_dict(params_from_jax(jparams, tmodel.cfg))
    return jmodel, jparams, tmodel


def _inputs():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    ids = mct.tokenize(["a photo of a cat", "a diagram",
                        "an origami goldfish in a video game."])
    return images, ids


def test_encoders_and_logit_scale_match(pair):
    jmodel, jparams, tmodel = pair
    images, ids = _inputs()
    want = apply_clip(jparams, jnp.asarray(images), jnp.asarray(ids),
                      jmodel.cfg, compute_dtype=jnp.float32)
    got = tmodel(images, ids)
    np.testing.assert_allclose(got["image_features"].detach().numpy(),
                               np.asarray(want["image_features"]), **TOL)
    np.testing.assert_allclose(got["text_features"].detach().numpy(),
                               np.asarray(want["text_features"]), **TOL)
    np.testing.assert_allclose(float(got["logit_scale"]),
                               float(want["logit_scale"]), rtol=1e-6)
    np.testing.assert_allclose(tmodel.encode_image(images).numpy(),
                               np.asarray(jmodel.encode_image(
                                   jparams, jnp.asarray(images))), **TOL)


def test_zero_shot_classifier_and_logits_match(pair):
    jmodel, jparams, tmodel = pair
    classnames, _ = port_zs.load_imagenet_metadata()
    classnames = classnames[:5]
    want_cls = jax_zs.build_zero_shot_classifier(
        jmodel, jparams, classnames, jax_zs.SIMPLE_IMAGENET_TEMPLATES,
        mct.get_tokenizer(), batch_size=2)
    got_cls = port_zs.build_zero_shot_classifier(
        tmodel, classnames, port_zs.SIMPLE_IMAGENET_TEMPLATES,
        port.get_tokenizer(), batch_size=2)
    assert got_cls.shape == (128, 5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), **TOL)

    images, _ = _inputs()
    want = jax_zs.zero_shot_classification(jmodel, jparams, want_cls,
                                           jnp.asarray(images))
    got = port_zs.zero_shot_classification(tmodel, got_cls, images)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)  # logits are 100x the cosines
    labels = np.asarray(want).argmax(-1)
    acc = port_zs.zero_shot_eval(tmodel, got_cls, [(images, labels)])
    assert acc["imagenet-zeroshot-val-top1"] == 1.0


def test_bf16_compute_keeps_fp32_params_and_features(pair):
    _, _, tmodel = pair
    images, ids = _inputs()
    bf = port.create_model("ViT-B-32", precision="bf16", device="cpu",
                           **OVERRIDES)
    bf.load_state_dict(tmodel.state_dict())
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    feats = bf.encode_image(images)
    assert feats.dtype == torch.float32
    cos = (feats * tmodel.encode_image(images)).sum(-1)
    assert float(cos.min()) > 0.99


def test_bf16_features_match_jax_bf16(pair):
    jmodel, jparams, tmodel = pair
    images, ids = _inputs()
    want = apply_clip(jparams, jnp.asarray(images), jnp.asarray(ids),
                      jmodel.cfg, compute_dtype=jnp.bfloat16)
    bf = port.create_model("ViT-B-32", precision="bf16", device="cpu",
                           **OVERRIDES)
    bf.load_state_dict(tmodel.state_dict())
    got = bf(images, ids)
    for key in ("image_features", "text_features"):
        g, w = got[key].detach().numpy(), np.asarray(want[key], np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3)
        assert float((g * w).sum(-1).min()) >= 0.9999


@pytest.mark.parametrize("overrides", [
    {"vision_cfg": {"ls_init_value": 0.1}},
    {"vision_cfg": {"pool_type": "avg"}},
    {"vision_cfg": {"no_ln_pre": True}},
    {"text_cfg": {"proj_bias": True}},
])
def test_options_outside_the_slice_are_refused(overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.create_model("ViT-B-32", precision="fp32", device="cpu",
                          **overrides)


# Each refusal of the factory names its ROADMAP Queue A item by number:
# fp16 (the JAX factory builds it) is item 2, the towers and models outside
# the ViT CLIP slice item 7; a name that is no precision stays a ValueError.
@pytest.mark.parametrize("kw,item", [
    ({"precision": "fp16"}, 2),
    ({"precision": "float16"}, 2),
    ({"vision_cfg": {"layers": [3, 4, 6, 3], "width": 64}}, 7),
    ({"multimodal_cfg": {"width": 128}}, 7),
    ({"vision_cfg": {"timm_model_name": "vit_base_patch16_224"}}, 7),
])
def test_refusals_name_their_queue_a_item(kw, item):
    kw = {"precision": "fp32", **kw}
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue A item {item}\)"):
        port.create_model("ViT-B-32", device="cpu", **kw)


def test_a_name_that_is_no_precision_is_a_value_error():
    with pytest.raises(ValueError, match="unknown or unsupported precision"):
        port.create_model("ViT-B-32", precision="fp8", device="cpu")
