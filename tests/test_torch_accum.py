"""open_CLIP's --accum-freq in the port (`make_train_step(...,
microbatches=M)`) against the JAX step, at a small size on the CPU in fp32,
without patch dropout (with it: `test_torch_patch_dropout.py`).

- Three fp32 steps against JAX `make_train_step(microbatches=M)` for M = 2
  and 4 under `SigLipLoss` and `ClipLoss`, at the tolerances of
  `test_train_step_matches_jax_three_fp32_steps` (loss and logit_scale
  1e-6 relative at the first step and 1e-5 after, grad_norm 1e-5; 99% of
  the parameters within 1e-6 after the steps, every one within 2 lr a
  step).
- The summed block gradients against the whole batch's gradient, within
  1e-5 of each gradient's norm.

Reference defect kept for parity: the JAX step calls the loss with
(image features, text features, logit_scale) only, so SigLIP's
`logit_bias` never reaches the loss; its gradient is zero and AdamW leaves
it at its init (-10 in ViT-B-16-SigLIP). The port's step does the same,
and `test_accumulated_steps_match_jax` holds the bias at its init on both
sides.
"""
import pytest

import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch import losses
from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                              make_optimizer, make_train_step)
from torch_recipe_util import (LR, SMALL, batch, check_accumulated_steps,
                               jax_model, one_thread, port_model)  # noqa: F401


@pytest.mark.parametrize("loss", ["siglip", "clip"])
@pytest.mark.parametrize("microbatches", [2, 4])
def test_accumulated_steps_match_jax(microbatches, loss):
    check_accumulated_steps(microbatches, loss)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_accumulated_gradient_is_the_whole_batch_gradient(microbatches):
    """Without patch dropout the summed block gradients (logit_scale's
    divided by M) are the gradient of the whole batch's loss."""
    jmodel, jparams = jax_model(SMALL, init_logit_bias=-10.0)
    images, texts = batch()
    grads = []
    for m in (1, microbatches):
        model = port_model(jmodel, jparams, SMALL, init_logit_bias=-10.0)
        opt = make_optimizer(model, cosine_lr(*LR.values()))
        kept = {}
        update = opt.update

        def keep(state, g, kept=kept, update=update):
            kept.update({n: t.clone() for n, t in g.items()})
            return update(state, g)
        opt.update = keep
        make_train_step(model, opt, loss_obj=losses.SigLipLoss(),
                        microbatches=m)(TrainState.create(model, opt),
                                        images, texts)
        grads.append(kept)
    whole, acc = grads
    assert float(whole["logit_bias"]) == float(acc["logit_bias"]) == 0.0
    for name, g in whole.items():
        if name == "logit_bias":
            continue
        err = float((acc[name] - g).norm() / g.norm())
        assert err < 1e-5, (name, err)


def test_a_batch_that_does_not_split_raises():
    model = port.create_model("ViT-B-32", precision="fp32", device="cpu",
                              **SMALL)
    opt = make_optimizer(model, cosine_lr(*LR.values()))
    step = make_train_step(model, opt, microbatches=3)
    with pytest.raises(ValueError, match="does not split"):
        step(TrainState.create(model, opt), *batch())
