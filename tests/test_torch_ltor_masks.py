"""megatron's document flags in the port (`models/gpt.py`) against the JAX
package, on the CPU, in fp32.

- `get_ltor_masks_and_position_ids` against JAX's on packed streams with
  no EOD, an EOD first, an EOD last, two EODs in a row and EODs at random:
  the attention bias, the loss mask and the per-row positions equal.
- The GPT loss and its gradients with --eod-mask-loss,
  --reset-position-ids and --reset-attention-mask each alone and all three
  together, as the JAX entry builds them (the masks of the inputs, the
  targets pre-shifted), against JAX `gpt_loss`: through the chunked loss
  and through the fused CE (its plain version here), with learned
  positions and with rope. The weights cross through
  `bridge.gpt_params_from_jax`, which the first test holds exact.
Tolerances: the masks exactly; the loss 1e-5 relative; each gradient
within 1e-4 of its own largest |value| (sums over the batch's tokens in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.models import gpt as jax_gpt
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.config import FP32
from megatron_clip_tpu_torch.models.gpt import (
    GPTCfg, GPTModel, get_ltor_masks_and_position_ids, gpt_loss)

EOD = 0
SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
             seq_length=64)
FLAGS = {
    "eod-mask-loss": dict(eod_mask_loss=True),
    "reset-position-ids": dict(reset_position_ids=True),
    "reset-attention-mask": dict(reset_attention_mask=True),
    "all": dict(eod_mask_loss=True, reset_position_ids=True,
                reset_attention_mask=True),
}


def _stream(rng, b: int, s: int, vocab: int) -> np.ndarray:
    """[B, S] ids with EODs: at random in every row, and in rows 0-3 also
    first, last, twice in a row, and none at all."""
    t = rng.integers(1, vocab, (b, s))
    t[rng.random((b, s)) < 0.08] = EOD
    t[0, 0] = EOD
    t[1 % b, -1] = EOD
    t[2 % b, 10:12] = EOD
    if b > 3:
        t[3] = rng.integers(1, vocab, s)
    return t.astype(np.int32)


@pytest.mark.parametrize("b,s", [(4, 33), (2, 8), (5, 64)])
def test_masks_match_jax(b, s):
    tokens = _stream(np.random.default_rng(s), b, s, 50)
    want = jax_gpt.get_ltor_masks_and_position_ids(
        jnp.asarray(tokens), EOD, reset_position_ids=True,
        reset_attention_mask=True, eod_mask_loss=True)
    got = get_ltor_masks_and_position_ids(
        torch.from_numpy(tokens), EOD, reset_position_ids=True,
        reset_attention_mask=True, eod_mask_loss=True)
    for name, g, w in zip(("attn_bias", "loss_mask", "position_ids"),
                          got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[0].dtype == got[1].dtype == torch.float32
    # each flag alone gives its own mask and None for the others
    for i, flag in enumerate(("reset_attention_mask", "eod_mask_loss",
                              "reset_position_ids")):
        alone = get_ltor_masks_and_position_ids(torch.from_numpy(tokens),
                                                EOD, **{flag: True})
        assert [x is not None for x in alone] == [j == i for j in range(3)]
        np.testing.assert_array_equal(alone[i].numpy(), got[i].numpy())


def _setup(position_embedding: str, seed: int = 0):
    kw = dict(SMALL, position_embedding=position_embedding)
    jcfg, pcfg = jax_gpt.GPTCfg(**kw), GPTCfg(**kw)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(seed), jcfg)
    model = GPTModel(pcfg, FP32)
    model.load_state_dict(gpt_params_from_jax(params, pcfg))
    tokens = _stream(np.random.default_rng(seed + 1), 3,
                     kw["seq_length"] + 1, kw["vocab_size"])
    return jcfg, params, model, tokens


def test_the_bridge_carries_the_weights():
    jcfg, params, model, _ = _setup("rope")
    sd = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(sd) == sum(leaf.shape[0] if "blocks" in str(path) else 1
                          for path, leaf in flat)
    np.testing.assert_array_equal(sd["tok_embed"].numpy(),
                                  np.asarray(params["tok_embed"]))
    for i in range(jcfg.num_layers):
        np.testing.assert_array_equal(
            sd[f"blocks.{i}.attn.wqkv"].numpy(),
            np.asarray(params["blocks"]["attn"]["wqkv"][i]))


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("loss", ["chunked", "fused-ce"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_gpt_loss_with_document_flags_matches_jax(flags, loss, pos):
    jcfg, params, model, tokens = _setup(pos)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    flag = FLAGS[flags]
    chunk = dict(loss_seq_chunk=24) if loss == "chunked" else {}

    def jax_loss(p):
        ab, lm, pid = jax_gpt.get_ltor_masks_and_position_ids(
            jnp.asarray(inputs), EOD, **flag)
        return jax_gpt.gpt_loss(p, jnp.asarray(inputs), jcfg,
                                targets=jnp.asarray(targets), loss_mask=lm,
                                attn_bias=ab, position_ids=pid,
                                compute_dtype=jnp.float32, **chunk)
    want, wg = jax.value_and_grad(jax_loss)(params)
    ab, lm, pid = get_ltor_masks_and_position_ids(
        torch.from_numpy(inputs).long(), EOD, **flag)
    got = gpt_loss(model, torch.from_numpy(inputs).long(),
                   targets=torch.from_numpy(targets).long(), loss_mask=lm,
                   attn_bias=ab, position_ids=pid,
                   fused_ce=loss == "fused-ce", **chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_grads = gpt_params_from_jax(wg, model.cfg)
    for n, p in model.named_parameters():
        w = want_grads[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


def test_the_flags_change_the_loss():
    """Each flag reaches the model: the loss differs from the plain one."""
    _, _, model, tokens = _setup("rope")
    t = torch.from_numpy(tokens).long()
    plain = float(gpt_loss(model, t[:, :-1], targets=t[:, 1:]))
    assert plain == pytest.approx(float(gpt_loss(model, t)), rel=1e-6)
    for flag in FLAGS.values():
        ab, lm, pid = get_ltor_masks_and_position_ids(t[:, :-1], EOD, **flag)
        got = float(gpt_loss(model, t[:, :-1], targets=t[:, 1:],
                             loss_mask=lm, attn_bias=ab, position_ids=pid))
        assert abs(got - plain) > 1e-6, flag
