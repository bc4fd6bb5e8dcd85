"""Shared helpers of the tensor- and fsdp-parallel tests
(`test_torch_tp_fsdp.py`, `test_torch_tp_dropout.py`,
`test_torch_fsdp_clip.py`): a config from flags, the one-process run with
its final parameters, and a rank's shards held against one process's
parameters.

The one-process runs beside the ranks take one thread (`one_thread`), as
the ranks do: in a test run whose other workers keep every core busy,
PyTorch's intra-op threads of a tiny model spend most of a step waiting
on one another, and a fixture of a few seconds takes minutes.
"""
import contextlib

import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch import pretrain_gpt
from megatron_clip_tpu_torch.models.gpt import GPTCfg, GPTModel
from megatron_clip_tpu_torch.parallel import sharding
from megatron_clip_tpu_torch.parallel.mesh import Layout
from megatron_clip_tpu_torch.training import workload
from torch_gpt_util import bridge_init, port_run


def gpt_cfg(argv) -> GPTCfg:
    return pretrain_gpt.gpt_cfg_from_args(pretrain_gpt.parse_args(argv))


def model_of(cfg: GPTCfg) -> GPTModel:
    """The model the entry draws from --seed 0, on the CPU."""
    return GPTModel(cfg, generator=torch.Generator().manual_seed(0))


def one_process_argv(argv) -> list:
    """argv without the layout's flags."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--tensor-model-parallel-size", "--fsdp-parallel-size"):
            skip = True
        elif a != "--sequence-parallel":
            out.append(a)
    return out


@contextlib.contextmanager
def one_thread():
    """PyTorch's intra-op threads set to one while the block runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def one_process_params(argv, init=None) -> dict:
    """The port's one-process run of argv (its layout flags dropped), from
    the JAX tree `init` where given: its result with the final parameters
    (`params`), each step's grad norm (`grad_norms`) and the gradients of
    its first step (`grads1`), as `torch_dp_util.gpt_rank` gives a rank's."""
    cap, run_wl = {"grad_norms": []}, pretrain_gpt.run_workload
    step, reduced = workload._Runner.step, workload._Runner._reduced_grads

    def ran(model, *a, **kw):
        res = run_wl(model, *a, **kw)
        cap["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        return res

    def stepped(self, batch, i):
        m = step(self, batch, i)
        cap["grad_norms"].append(float(m["grad_norm"]))
        return m

    def reduced_grads(self, *a):
        loss, grads = reduced(self, *a)
        if "grads1" not in cap:
            cap["grads1"] = {n: g.detach().clone() for n, g in grads.items()}
        return loss, grads
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setattr(pretrain_gpt, "run_workload", ran)
        mp.setattr(workload._Runner, "step", stepped)
        mp.setattr(workload._Runner, "_reduced_grads", reduced_grads)
        if init is not None:
            bridge_init(mp, init)
        out = port_run(one_process_argv(argv))
    return dict(out, **cap)


def rank_layout(rank: int, fsdp: int, tp: int) -> Layout:
    """Rank `rank`'s place, dp x fsdp x tp in the JAX mesh's order."""
    return Layout(fsdp=fsdp, tp=tp, f=rank // tp % fsdp, t=rank % tp)


def shards_close(got: dict, want: dict, init: dict, cfg: GPTCfg,
                 layout: Layout, tag) -> None:
    """Each of a rank's shards `got` within 1e-3 of the distance the steps
    moved it from one process's final parameters `want` (from `init`),
    both cut to the rank's shards (the bound of tests/
    test_torch_gpt_dp.py: Adam moves an element whose gradient sits at
    rounding level by a step either way)."""
    model = model_of(cfg)
    pls = sharding.placements(model, sharding.gpt_param_specs(
        dict(model.named_parameters())), layout)
    for n, g in got.items():
        w = sharding.split_tensor(want[n], pls[n], layout)
        moved = (w - sharding.split_tensor(init[n], pls[n], layout)).norm()
        assert (g - w).norm() <= 1e-3 * moved, (tag, n)


def close_to_one_process(got, want, tag) -> None:
    """A run's losses and grad norms against one process's: the losses
    within 1e-6 relative at step 1 and 1e-5 after (the bounds of
    tests/test_torch_gpt_dp.py), each step's grad norm within 1e-5 (a
    gradient summed twice, or weighted wrongly in the norm, moves it where
    Adam's first steps hide it from the losses and the parameters)."""
    assert len(got["history"]) == len(want["history"]), tag
    for (i, g), (_, w) in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g, w, rtol=1e-6 if i == 1 else 1e-5,
                                   err_msg=f"{tag} step {i}")
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-5, err_msg=f"{tag} grad norms")


def grads_close(got: dict, want: dict, cfg: GPTCfg, layout: Layout,
                tag) -> None:
    """Each of a rank's first-step gradients `got` (its shards) within
    1e-5 of the norm of one process's `want` cut to the same shard: a leaf
    summed over a group too many or too few, or divided by the wrong
    count, is off by a factor."""
    model = model_of(cfg)
    pls = sharding.placements(model, sharding.gpt_param_specs(
        dict(model.named_parameters())), layout)
    assert got.keys() == want.keys(), tag
    for n, g in got.items():
        w = sharding.split_tensor(want[n], pls[n], layout)
        assert (g - w).norm() <= 1e-5 * w.norm(), (
            tag, n, float((g - w).norm() / w.norm()))
