"""The accumulated train step with patch dropout in the port against the
JAX package, at a small size on the CPU in fp32: three fp32 steps against
JAX `make_train_step(microbatches=M, seed=...)`, M = 2 and 4, under
`SigLipLoss` and `ClipLoss`, at the tolerances of
`test_train_step_matches_jax_three_fp32_steps` (loss and logit_scale 1e-6
relative at the first step and 1e-5 after, grad_norm 1e-5; 99% of the
parameters within 1e-6 after the steps, every one within 2 lr a step).
The port's step draws its kept patches through `jax_patch_ids`, the
indices the JAX step's keys give (`jax.random` streams cannot be
reproduced in torch), the same (step, block) indices in the cache pass and
in the block. Without patch dropout: `test_torch_accum.py`, which also
notes the `logit_bias` reference defect kept for parity.
"""
import pytest

from megatron_clip_tpu_torch.training import train_step
from torch_recipe_util import (check_accumulated_steps, jax_patch_ids,
                               one_thread)  # noqa: F401


@pytest.mark.parametrize("loss", ["siglip", "clip"])
@pytest.mark.parametrize("microbatches", [2, 4])
def test_accumulated_steps_with_patch_dropout_match_jax(microbatches, loss,
                                                        monkeypatch):
    monkeypatch.setattr(train_step, "patch_keep_ids", jax_patch_ids)
    check_accumulated_steps(microbatches, loss, patch_dropout=0.5)
