"""Dropout over the global batch, and tensor parallelism on two gloo ranks
on the CPU, against the port's one process.

- The fault this slice repairs: data-parallel ranks drew the attention
  masks of heads 0.. of their own rows, the same positions on every rank
  (the kernels number a launch's heads from 0). Two data-parallel ranks at
  --attention-dropout 0.1 now train as one process does, on the fused
  route (width 128 over 4 heads of 32, S = 32) and the flash route
  (S = 256 with rope), and a rank's multipliers are the one process's bit
  for bit (`Dropout::step_head`, `ops/dropout.RankSeed`).
- The hidden masks differ across data ranks and agree across the tensor
  ranks of a replicated activation: without sequence parallelism the two
  tensor ranks' replicated weights stay bit-equal under --hidden-dropout.
- At tp2 against one process (losses 1e-6 relative at step 1, 1e-5 after;
  each rank's shard of each final parameter within 1e-3 of the distance
  the steps moved it, tests/test_torch_gpt_dp.py's bounds; each step's
  grad norm within 1e-5, and each shard of the first step's gradients
  within 1e-5 of its norm, `torch_tp_util.close_to_one_process` and
  `grads_close`): attention
  dropout on the fused route; grouped-query attention with rope, swiglu,
  RMSNorm, the fused CE, micro-batches and mlp recompute under sequence
  parallelism; the three document flags (the unfused attention).
"""
import numpy as np
import pytest
import torch

from megatron_clip_tpu_torch.ops.dropout import (RankSeed, attention_dropout,
                                                 dropout)
from megatron_clip_tpu_torch.parallel import mesh
from megatron_clip_tpu_torch.parallel.mesh import Layout
from test_torch_gpt_dp import write_doc_corpus
from torch_dp_util import gpt_rank, spawn
from torch_gpt_util import TINY
from torch_tp_util import (close_to_one_process, gpt_cfg, grads_close,
                           model_of, one_process_params, rank_layout,
                           shards_close)

WORLD = 2
TP2 = ["--tensor-model-parallel-size", "2"]
# width 128 over 4 heads of 32: the attention dropout takes the fused
# kernels' route at S = 32 and the flash route at S = 256 with rope
WIDE = [a if a != "64" else "128" for a in TINY]
DROP_CASES = {
    "fused": WIDE + ["--batch-size", "16", "--train-steps", "2",
                     "--attention-dropout", "0.1"],
    "flash": WIDE + ["--seq-length", "256", "--position-embedding", "rope",
                     "--batch-size", "4", "--train-steps", "2",
                     "--attention-dropout", "0.1"],
}
TP_CASES = {
    "attn-dropout-fused": DROP_CASES["fused"] + TP2,
    "gqa-fused-ce-micro-mlp-sp": TINY + TP2 + [
        "--sequence-parallel", "--position-embedding", "rope", "--swiglu",
        "--normalization", "rmsnorm", "--kv-heads", "2", "--fused-ce",
        "--batch-size", "16", "--micro-batch-size", "8",
        "--recompute-granularity", "mlp", "--train-steps", "2"],
    "doc-flags": TINY + TP2 + [
        "--eod-token", "0", "--eod-mask-loss", "--reset-position-ids",
        "--reset-attention-mask", "--position-embedding", "rope",
        "--data-path", "{docs}", "--split", "8,2,0", "--batch-size", "16",
        "--micro-batch-size", "8", "--train-steps", "2"],
}
# hidden dropout: the ranks' masks are their own, not the one process's
HIDDEN = TINY + TP2 + ["--batch-size", "16", "--train-steps", "2",
                       "--hidden-dropout", "0.1"]


def test_a_rank_draws_the_one_process_attention_bits(monkeypatch):
    """Data rank 1 of 2 (rows 2-3 of 4) at tensor rank 1 of 2 (heads 2-3
    of 4): its launch's multipliers are the one process's at those rows
    and heads, bit for bit (the kernels' `Dropout::step_head`)."""
    monkeypatch.setitem(mesh._state, "layout",
                        Layout(dp=2, tp=2, d=1, t=1))
    seed = mesh.rank_seed(77, 2)
    assert (seed.row_base, seed.tp, seed.tp_rank) == (2, 2, 1)
    one = attention_dropout(0.1, 77, 5, 4).multipliers(4, 4, 16, 16, 1.25)
    mine = attention_dropout(0.1, seed, 5, 2).multipliers(2, 2, 16, 16,
                                                          1.25)
    assert torch.equal(mine, one[2:4, 2:4])


def test_hidden_masks_differ_across_data_ranks_and_agree_across_tensor():
    """A replicated activation's mask is the same on the tensor ranks of
    one data index and differs between data indices; a sharded one's
    differs between tensor ranks too."""
    x = torch.ones(2, 8, 32)

    def mask(batch_rank, tp_rank, sharded):
        seed = RankSeed(1234, row_base=0, tp=2, tp_rank=tp_rank,
                        batch_rank=batch_rank)
        return dropout(x, 0.5, seed, 3, sharded=sharded) != 0
    assert torch.equal(mask(0, 0, False), mask(0, 1, False))
    assert not torch.equal(mask(0, 0, False), mask(1, 0, False))
    assert not torch.equal(mask(0, 0, True), mask(0, 1, True))
    assert not torch.equal(mask(0, 0, True), mask(1, 0, True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's one-process runs and, in one spawn of 2 ranks, the
    data-parallel dropout runs, the tp2 runs and the hidden-dropout run."""
    tmp = tmp_path_factory.mktemp("tp_dropout")
    data = {"docs": write_doc_corpus(tmp / "d")}
    cases = {**{f"dp-{c}": a for c, a in DROP_CASES.items()},
             **{c: [x.format(**data) for x in a] + (
                 ["--data-cache-path", str(tmp / "c")]
                 if "--data-path" in a else [])
                for c, a in TP_CASES.items()}}
    one = {c: one_process_params(a) for c, a in cases.items()}
    jobs = ([(c, a, None, None) for c, a in cases.items()]
            + [("hidden-dropout", HIDDEN, None, None)])
    ranks = spawn(gpt_rank, WORLD, tmp / "ranks", jobs)
    got = {tag: [r[i] for r in ranks] for i, (tag, *_) in enumerate(jobs)}
    for tag, per_rank in got.items():
        for r, res in enumerate(per_rank):
            assert "error" not in res, (tag, r, res.get("error"))
            assert res["left"], (tag, r)
    return {"one": one, "ranks": got, "cases": cases}


@pytest.mark.parametrize("case", list(DROP_CASES))
def test_attention_dropout_over_data_ranks_is_one_process(case, runs):
    """Two data-parallel ranks at --attention-dropout 0.1 train as one
    process does (the fault: they drew the same positions of their own
    rows)."""
    one = runs["one"][f"dp-{case}"]
    cfg = gpt_cfg(DROP_CASES[case])
    init = {n: p.detach() for n, p in model_of(cfg).named_parameters()}
    for r, got in enumerate(runs["ranks"][f"dp-{case}"]):
        close_to_one_process(got, one, f"{case} rank {r}")
        grads_close(got["grads1"], one["grads1"], cfg, Layout(),
                    f"{case} rank {r}")
        shards_close(got["params"], one["params"], init, cfg, Layout(),
                     f"{case} rank {r}")


@pytest.mark.parametrize("case", list(TP_CASES))
def test_two_tensor_ranks_match_one_process(case, runs):
    argv = runs["cases"][case]
    one = runs["one"][case]
    cfg = gpt_cfg(argv)
    init = {n: p.detach() for n, p in model_of(cfg).named_parameters()}
    for r, got in enumerate(runs["ranks"][case]):
        close_to_one_process(got, one, f"{case} rank {r}")
        grads_close(got["grads1"], one["grads1"], cfg, rank_layout(r, 1, 2),
                    f"{case} rank {r}")
        shards_close(got["params"], one["params"], init, cfg,
                     rank_layout(r, 1, 2), f"{case} rank {r}")


def test_tensor_ranks_keep_replicated_weights_equal_under_hidden_dropout(
        runs):
    """Without sequence parallelism the residual stream is whole on both
    tensor ranks, and so is its hidden-dropout mask: their replicated
    weights (the norms, the row-parallel biases, whose gradients are not
    summed over the tensor ranks) stay bit-equal."""
    ranks = runs["ranks"]["hidden-dropout"]
    for n, p in ranks[0]["params"].items():
        if n.endswith(("scale", ".bo", ".b2")):
            assert torch.equal(p, ranks[1]["params"][n]), n
