"""Patch dropout (open_CLIP's PatchDropout, FLIP) in the port against the
JAX package, at a small size on the CPU in fp32. `jax.random` streams
cannot be reproduced in torch, so the port's forward is fed the indices
JAX's own calls draw for the same key (`jax_patch_ids`), and its train
step draws them through the same function where it is held against the
JAX step.

- The vision forward within 2e-5 (the CLIP features' tolerance) and its
  gradients within 1e-5 relative, 1e-5 of the largest absolute.
- The port's own draw (`patch_keep_ids`) keyed by the seed, the step and
  the block; eval forwards keep every patch.
- The accumulated train step with patch dropout against the JAX step:
  `test_torch_accum_patch_dropout.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.models.vit import apply_vit
import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch.bridge import _flatten
from megatron_clip_tpu_torch.models.vit import patch_keep_ids
from torch_recipe_util import (SMALL, batch, close, jax_model, jax_patch_ids,
                               one_thread, port_model)  # noqa: F401


# --------------------------------------------------------- patch dropout


@pytest.mark.parametrize("rate", [0.5, 0.9, 0.999])
def test_patch_dropout_forward_fed_jax_indices(rate):
    """The vision tower's forward with JAX's kept indices against
    `apply_vit` with the key that drew them, and its gradient against
    JAX's."""
    over = dict(SMALL, vision_cfg=dict(SMALL["vision_cfg"],
                                       patch_dropout=rate))
    jmodel, jparams = jax_model(over)
    model = port_model(jmodel, jparams, over)
    images, _ = batch(5, 4)
    key = jax.random.fold_in(jax.random.PRNGKey(7 + 1013), 3)
    vcfg = jmodel.cfg.vision

    @jax.jit
    def jfeat(p):
        return apply_vit(p, jnp.asarray(images), vcfg, jmodel.cfg.embed_dim,
                         compute_dtype=jnp.float32, patch_dropout_rng=key)
    want = jfeat(jparams["visual"])
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jfeat(p) ** 2)))(
        jparams["visual"])
    ids = jax_patch_ids(7, 3, None, 4, vcfg.grid ** 2, rate)
    assert ids.shape == (4, max(1, int(16 * (1 - rate))))
    got = model.visual(torch.from_numpy(images), torch.float32,
                       patch_keep=ids)
    close(got.detach().numpy(), np.asarray(want), 0, 2e-5)
    (got ** 2).sum().backward()
    wg = {}
    _flatten(jgrads, "", wg)
    for name, p in model.visual.named_parameters():
        w = wg[name]
        close(p.grad.numpy(), w, 1e-5, 1e-5 * float(np.abs(w).max()), name)


def test_patch_keep_ids_draw_from_the_step_and_the_block():
    a = patch_keep_ids(0, 5, None, 8, 196, 0.5)
    assert a.shape == (8, 98) and a.dtype == torch.int64
    assert torch.equal(a, patch_keep_ids(0, 5, None, 8, 196, 0.5))
    for row in a:
        assert len(set(row.tolist())) == 98 and int(row.max()) < 196
    others = [patch_keep_ids(0, 6, None, 8, 196, 0.5),
              patch_keep_ids(1, 5, None, 8, 196, 0.5),
              patch_keep_ids(0, 5, 0, 8, 196, 0.5),
              patch_keep_ids(0, 5, 1, 8, 196, 0.5)]
    for b in others:
        assert not torch.equal(a, b)
    assert patch_keep_ids(0, 0, None, 2, 3, 0.999).shape == (2, 1)


def test_eval_forwards_keep_every_patch(monkeypatch):
    """Patch dropout belongs to the train step: the serving encoders and a
    forward given no indices see every patch."""
    over = dict(SMALL, vision_cfg=dict(SMALL["vision_cfg"],
                                       patch_dropout=0.5))
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **over)
    plain = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **SMALL)
    plain.load_state_dict(model.state_dict())
    images, ids = batch(6, 2)
    torch.testing.assert_close(model.encode_image(images),
                               plain.encode_image(images), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(model(images, ids)["image_features"],
                                   plain(images, ids)["image_features"],
                                   rtol=0, atol=0)
