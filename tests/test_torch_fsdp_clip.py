"""FSDP of the port's CLIP trainer (`--fsdp-parallel-size 2`, as
examples/pretrain_clip_dp.sh sets it) over two gloo ranks on the CPU,
against one process of the port, at `test-tiny` size.

Each rank keeps its shards of the weights and of the Adam moments (the
JAX `clip_param_specs` rules, `parallel/sharding.py`), gathers a block's
weights before using them and reduce-scatters their gradients; the batch
and the feature gather span both ranks (data x fsdp).
- Each step's loss, logit_scale and grad_norm within the bounds of
  tests/test_torch_dp_loop.py (1e-6 relative at step 1, 1e-5 after;
  grad_norm 1e-5), each rank's final shards within 2 x 3 x lr of the one
  process's, 99% of the elements within 1e-6: plain ClipLoss, `--siglip
  --accum-freq 2 --force-patch-dropout 0.5` and `--lock-image`.
- A rank's parameter and moment bytes are at most 0.51 of one process's.
- A save at step 2 (whole tensors) resumes on two ranks bit-equal to the
  whole run, and in one process within the bounds above.
"""
import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch import factory
from megatron_clip_tpu_torch.parallel import sharding
from megatron_clip_tpu_torch.parallel.mesh import Layout
from megatron_clip_tpu_torch.training.optim import tower_lock_mask
from torch_dp_util import spawn, trainer_rank
from torch_tp_util import one_thread

BATCH, STEPS, LR = 16, 3, 5e-4
TINY_ARGS = [
    "--dataset-type", "synthetic", "--batch-size", str(BATCH), "--epochs",
    "1", "--warmup", "2", "--log-interval", "1", "--precision", "fp32",
    "--model", "test-tiny", "--train-num-samples", str(BATCH * STEPS),
    "--lr", str(LR), "--device", "cpu"]
FSDP = ["--fsdp-parallel-size", "2"]
RECIPES = {
    "clip": [],
    "siglip-accum-patch-dropout": ["--siglip", "--accum-freq", "2",
                                   "--force-patch-dropout", "0.5"],
    "lock-image": ["--lock-image", "--lock-image-unlocked-groups", "1"],
}


def _one_process(tmp, jobs) -> list:
    """`trainer_rank`'s results of `jobs` in this process, which joins no
    group (no torchrun environment): the one-process trainer, on one
    thread as the ranks (`torch_tp_util.one_thread`)."""
    (tmp / "out").mkdir(parents=True)
    with one_thread():
        trainer_rank(0, 1, str(tmp), jobs)
    return torch.load(tmp / "out" / "rank0.pt", weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_clip")
    save = ["--save", str(tmp / "ck"), "--name", "t"]
    one = _one_process(tmp / "one", [
        (TINY_ARGS + flags, None, None) for flags in RECIPES.values()])
    jobs = [(TINY_ARGS + FSDP + flags, None, None)
            for flags in RECIPES.values()]
    jobs += [(TINY_ARGS + FSDP + save + ["--exit-interval", "2"], None,
              None),
             # from the step-2 save, saving elsewhere: the one-process
             # resume below reads the same save
             (TINY_ARGS + FSDP + ["--resume", str(tmp / "ck" / "t"),
                                  "--save", str(tmp / "ck2")], None, None)]
    ranks = spawn(trainer_rank, 2, tmp / "ranks", jobs)
    from_fsdp = _one_process(tmp / "from_fsdp", [
        (TINY_ARGS + ["--resume", str(tmp / "ck" / "t")], None, None)])[0]
    return one, ranks, from_fsdp


def _placements():
    model = factory.create_model("test-tiny", precision="fp32",
                                 device="cpu")
    params = dict(model.named_parameters())
    return sharding.placements(model, sharding.clip_param_specs(params),
                               Layout(fsdp=2)), params


def _steps_close(got, want, tag):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = 1e-6 if i == 0 else 1e-5
        for key in ("loss", "logit_scale"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"{tag} step {i + 1}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5, err_msg=f"{tag} {i + 1}")


@pytest.mark.parametrize("i,name", list(enumerate(RECIPES)))
def test_two_fsdp_ranks_match_one_process(i, name, runs):
    one, ranks, _ = runs
    want = one[i]
    pls, _ = _placements()
    for r, got in enumerate(ranks):
        _steps_close(got[i]["steps"], want["steps"], f"{name} rank {r}")
        lay = Layout(fsdp=2, f=r)
        tight = total = 0
        for n, w in want["params"].items():
            g = got[i]["params"][n].numpy()
            w = sharding.split_tensor(w, pls[n], lay).numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * STEPS * LR,
                                       err_msg=f"{name} {n}")
            tight += int((np.abs(g - w) <= 1e-6).sum())
            total += g.size
        assert tight >= 0.99 * total, (name, r, tight, total)
    assert ranks[0][i]["steps"] == ranks[1][i]["steps"]
    if name == "lock-image":
        start = factory.create_model("test-tiny", precision="fp32",
                                     device="cpu").state_dict()
        mask = tower_lock_mask(start, lock_image=True,
                               image_unlocked_groups=1)
        for r, got in enumerate(ranks):
            for n, m in mask.items():
                if m == 0.0:
                    assert torch.equal(got[i]["params"][n],
                                       sharding.split_tensor(
                                           start[n], pls[n],
                                           Layout(fsdp=2, f=r))), n


def test_each_fsdp_rank_holds_half_the_state(runs):
    _, ranks, _ = runs
    _, params = _placements()
    one = sum(p.numel() * p.element_size() for p in params.values())
    for r, got in enumerate(ranks):
        b = got[0]["state_bytes"]
        assert b["params"] <= 0.51 * one, (r, b, one)
        assert b["moments"] <= 0.51 * 2 * one, (r, b, one)


def test_an_fsdp_save_resumes_on_two_ranks_and_in_one_process(runs):
    one, ranks, from_fsdp = runs
    k = len(RECIPES)
    for r, got in enumerate(ranks):
        whole, cut, resumed = got[0], got[k], got[k + 1]
        assert cut["steps"] == whole["steps"][:2]
        assert resumed["steps"] == whole["steps"][2:]
        for n, p in whole["params"].items():
            assert torch.equal(resumed["params"][n], p), (r, n)
    _steps_close(from_fsdp["steps"], one[0]["steps"][2:], "fsdp -> 1")
