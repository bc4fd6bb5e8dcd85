"""The port's trainer data-parallel over two CPU ranks against the JAX
package's trainer, at `test-tiny` size.

Both `run_training`s take 3 fp32 steps on the same synthetic global batches
(batch 16): the JAX loop shards each over its 8 virtual devices, the port's
two ranks (processes over gloo, `torch_dp_util.trainer_rank`) hold 8 rows
each, their share of every block (`parallel.mesh.rank_rows`), gather the
features and all-reduce the gradients. The port starts from the JAX initial
parameters, carried through `bridge.py`; patch dropout draws JAX's indices
of the block's global rows (`jax_patch_ids`), each rank keeping its own
rows'.

- Each rank's step metrics against JAX's: loss and logit_scale within 1e-6
  relative at step 1 and 1e-5 after, grad_norm within 1e-5, the bounds of
  `test_torch_loop.py::test_loop_matches_the_jax_loop`.
- The final parameters against JAX's: each within 2 x 3 x lr (Adam moves
  an element by less than lr a step) and 99% of all elements within 1e-6,
  the bounds of `torch_recipe_util.assert_params`.
- The two ranks' metrics and parameters bit-equal.
- Plain ClipLoss; `--siglip --accum-freq 2 --force-patch-dropout 0.5`;
  `--lock-image` (every locked parameter bit-equal to its start).
"""
import jax
import numpy as np
import pytest
import torch

from megatron_clip_tpu import factory as jax_factory
from megatron_clip_tpu.training import loop as jax_loop
from megatron_clip_tpu.training import params as jax_params
from megatron_clip_tpu_torch.bridge import params_from_jax
from megatron_clip_tpu_torch.training.optim import tower_lock_mask
from torch_dp_util import spawn, trainer_rank
from torch_recipe_util import jax_patch_ids

BATCH, STEPS, LR = 16, 3, 5e-4
TINY_ARGS = [
    "--dataset-type", "synthetic", "--batch-size", str(BATCH), "--epochs",
    "1", "--warmup", "2", "--log-interval", "1", "--precision", "fp32",
    "--model", "test-tiny", "--train-num-samples", str(BATCH * STEPS),
    "--lr", str(LR)]
RECIPES = {
    "clip": [],
    "siglip-accum-patch-dropout": ["--siglip", "--accum-freq", "2",
                                   "--force-patch-dropout", "0.5"],
    "lock-image": ["--lock-image", "--lock-image-unlocked-groups", "1"],
}


def _jax_run(argv):
    """The JAX loop's step metrics, its initial and final parameters (host
    copies: the step donates its state)."""
    steps, runners = [], []
    step = jax_loop._JointRunner.step

    def wrapped(self, images, texts):
        if not runners:
            runners.append(jax.tree.map(np.array, self.state.params))
        m = step(self, images, texts)
        steps.append({k: float(v) for k, v in m.items()})
        runners.append(jax.tree.map(np.array, self.state.params))
        return m
    jax_loop._JointRunner.step = wrapped
    try:
        final = jax_loop.run_training(jax_params.parse_args(argv))
    finally:
        jax_loop._JointRunner.step = step
    return steps, final, runners[0], runners[-1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each recipe's JAX run, and the two ranks' port runs of every recipe
    (one spawn)."""
    cfg = jax_factory.create_model("test-tiny", precision="fp32",
                                   seed=0)[0].cfg
    grid = cfg.vision.image_size // cfg.vision.patch_size
    jax_runs, jobs = {}, []
    for name, flags in RECIPES.items():
        argv = TINY_ARGS + flags
        jax_runs[name] = _jax_run(argv)
        start = {k: v.numpy() for k, v in params_from_jax(
            jax_runs[name][2], cfg).items()}
        patch_ids = None
        if "--force-patch-dropout" in argv:
            patch_ids = {(s, i): jax_patch_ids(0, s, i, BATCH // 2,
                                               grid * grid, 0.5).numpy()
                         for s in range(STEPS) for i in range(2)}
        jobs.append((argv + ["--device", "cpu"], start, patch_ids))
    ranks = spawn(trainer_rank, 2, tmp_path_factory.mktemp("dp_loop"), jobs)
    return cfg, {name: (jax_runs[name], jobs[i][1], [r[i] for r in ranks])
                 for i, name in enumerate(RECIPES)}


@pytest.mark.parametrize("name", RECIPES)
def test_two_ranks_match_the_jax_trainer(name, runs):
    cfg, all_runs = runs
    (want, jax_final, _, jax_end), start, ranks = all_runs[name]
    for r, got in enumerate(ranks):
        assert len(got["steps"]) == len(want) == STEPS
        for i, (g, w) in enumerate(zip(got["steps"], want)):
            rtol = 1e-6 if i == 0 else 1e-5
            for key in ("loss", "logit_scale"):
                np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                           err_msg=f"rank {r} step {i + 1}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5, err_msg=f"rank {r}")
        assert got["final"]["step"] == jax_final["step"] == STEPS
    assert ranks[0]["steps"] == ranks[1]["steps"]
    p0, p1 = ranks[0]["params"], ranks[1]["params"]
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    end = params_from_jax(jax_end, cfg)
    tight = total = 0
    for n, w in end.items():
        g, w = p0[n].numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * STEPS * LR,
                                   err_msg=n)
        tight += int((np.abs(g - w) <= 1e-6).sum())
        total += g.size
    assert tight >= 0.99 * total, (tight, total)
    if name == "lock-image":
        mask = tower_lock_mask(p0, lock_image=True, image_unlocked_groups=1)
        locked = [n for n, m in mask.items() if m == 0.0]
        assert locked
        for n in locked:
            assert torch.equal(p0[n], torch.from_numpy(start[n])), n
