"""The port's `pretrain_gpt` over two gloo ranks on the CPU against the JAX
package's `run`, which trains the same global batch data-parallel over the
8 virtual devices of tests/conftest.py.

Both train the tiny GPT (2 layers, width 64, S = 32, vocab 384) in fp32
from the same initial parameters (the JAX tree carried into rank 0's model
through `bridge.gpt_params_from_jax`; rank 1 starts from its own draw and
trains from rank 0's broadcast). The cases, each a torchrun-like launch of
two ranks (`torch_dp_util.gpt_rank`):
- the plain step on an indexed corpus (megatron's sequential sampler),
  with evals over the global eval batch;
- --micro-batch-size accumulation (global rows, each rank its share of
  every microbatch) with the cyclic sampler;
- --rampup-batch-size with micro-batches, on the synthetic stream;
- --eod-mask-loss on a corpus of short documents whose two ranks hold
  unequal counts of unmasked tokens (the masked mean's count is the
  global batch's), and all three document flags with rope.
Each logged loss within 1e-6 relative at step 1 and 1e-5 after (the JAX
run shards over 8 devices and sums in another order), the val loss within
1e-5, each final parameter's distance from JAX's within 1e-3 of the
distance the steps moved it (as tests/test_torch_gpt.py holds the steps of
bench.py's chain: Adam moves an element whose gradient sits at rounding
level by a step either way), and the two ranks' losses and parameters
bit-equal.

Then, without JAX: a run cut by SIGTERM on rank 1 after step 2 (rank 0
saves, both stop at step 2) and resumed over two ranks continues
bit-equal to the run left whole (rampup, micro-batches and the document
mask on, so the resume is at the ramped consumed samples); only rank 0
writes the checkpoint; global batches and micro-batches the world size
does not divide are refused (SystemExit, rank by rank), as are the
pipeline and context sizes above 1 beside tensor and fsdp parallelism
(NotImplementedError naming ROADMAP Queue A item 5), before any group is
joined; every rank leaves its group on every way out.
"""
import os

import numpy as np
import pytest
import torch

from torch_dp_util import gpt_rank, spawn
from torch_gpt_util import TINY, jax_run, write_corpus
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.data import indexed_dataset
from megatron_clip_tpu_torch.data.gpt_dataset import gpt_batch_iterator
from megatron_clip_tpu_torch.models.gpt import (
    get_ltor_masks_and_position_ids)
from megatron_clip_tpu_torch.parallel.mesh import rank_rows
from megatron_clip_tpu_torch.pretrain_gpt import gpt_cfg_from_args, parse_args

WORLD = 2
TINY_CFG = gpt_cfg_from_args(parse_args(TINY))
EOD = 0
DOCS = ["--eod-token", "0", "--eod-mask-loss"]
CASES = {
    "indexed": TINY + [
        "--data-path", "{corpus}", "--split", "8,2,0", "--batch-size", "16",
        "--train-steps", "3", "--eval-interval", "3", "--eval-iters", "2"],
    "indexed-micro-cyclic": TINY + [
        "--data-path", "{corpus}", "--split", "8,2,0", "--batch-size", "16",
        "--micro-batch-size", "8", "--dataloader-type", "cyclic",
        "--train-steps", "3"],
    "synthetic-micro-rampup": TINY + [
        "--batch-size", "16", "--micro-batch-size", "8",
        "--rampup-batch-size", "8", "8", "16", "--train-steps", "4"],
    "eod-mask-loss": TINY + DOCS + [
        "--data-path", "{docs}", "--split", "8,2,0", "--batch-size", "16",
        "--micro-batch-size", "8", "--train-steps", "3",
        "--eval-interval", "3", "--eval-iters", "1"],
    "all-document-flags-rope": TINY + DOCS + [
        "--reset-position-ids", "--reset-attention-mask",
        "--position-embedding", "rope", "--data-path", "{docs}",
        "--split", "8,2,0", "--batch-size", "16", "--train-steps", "3"],
}


def write_doc_corpus(prefix, n_docs: int = 400, seed: int = 1) -> str:
    """Documents of 1-12 ids below 384, each closed by EOD (id 0): many
    EODs a sample, so the ranks' rows hold unequal unmasked counts."""
    rng = np.random.default_rng(seed)
    b = indexed_dataset.MMapIndexedDatasetBuilder(prefix)
    for _ in range(n_docs):
        b.add_item(np.append(rng.integers(1, 384, int(rng.integers(1, 13))),
                             EOD))
        b.end_document()
    b.finalize()
    return str(prefix)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt_dp_data")
    return {"corpus": write_corpus(root / "c"),
            "docs": write_doc_corpus(root / "d"),
            "cache": str(root / "cache"), "jax_cache": str(root / "jcache")}


def _argv(case, data, cache="cache"):
    argv = [a.format(**data) for a in CASES[case]]
    if "--data-path" in argv:
        argv += ["--data-cache-path", data[cache]]
    return argv


def _state(init, argv):
    cfg = gpt_cfg_from_args(parse_args(argv))
    return {k: v.numpy() for k, v in gpt_params_from_jax(init, cfg).items()}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Every case's JAX run and its two-rank port run (one spawn)."""
    jax_runs = {case: jax_run(_argv(case, data, "jax_cache"))
                for case in CASES}
    jobs = [(case, _argv(case, data),
             _state(jax_runs[case]["init"], _argv(case, data)), None)
            for case in CASES]
    ranks = spawn(gpt_rank, WORLD, tmp_path_factory.mktemp("gpt_dp"), jobs)
    return {case: (jax_runs[case], [r[i] for r in ranks])
            for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_run(case, runs):
    want, ranks = runs[case]
    for r, got in enumerate(ranks):
        assert "error" not in got, (r, got.get("error"))
        assert got["left"]
        assert got["last_step"] == want["last_step"]
        assert [i for i, _ in got["history"]] == [
            i for i, _ in want["history"]]
        for (i, g), (_, w) in zip(got["history"], want["history"]):
            np.testing.assert_allclose(g, w, rtol=1e-6 if i == 1 else 1e-5,
                                       err_msg=f"{case} rank {r} step {i}")
        if "val_loss" in want:
            np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                                       rtol=1e-5)
        final = gpt_params_from_jax(want["final"], TINY_CFG)
        init = gpt_params_from_jax(want["init"], TINY_CFG)
        for n, p in got["params"].items():
            w = final[n].numpy()
            moved = np.linalg.norm(w - init[n].numpy())
            assert np.linalg.norm(p.numpy() - w) <= 1e-3 * moved, (
                f"{case} rank {r} {n}")
    assert ranks[0]["history"] == ranks[1]["history"]
    assert ranks[0].get("val_loss") == ranks[1].get("val_loss")
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n


def test_the_ranks_of_the_eod_corpus_hold_unequal_unmasked_counts(data):
    """The case that catches a rank-local masked mean: in the first
    microbatch the two ranks' rows hold different numbers of unmasked
    tokens."""
    it = gpt_batch_iterator(data["docs"], 16, 32, split="8,2,0",
                            cache_dir=data["cache"])
    batch = torch.from_numpy(next(it)[:, :-1])
    _, mask, _ = get_ltor_masks_and_position_ids(batch, EOD,
                                                 eod_mask_loss=True)
    counts = [float(mask[rank_rows(16, 2, r, WORLD)][:4].sum())
              for r in range(WORLD)]
    assert counts[0] != counts[1], counts


RESUME = TINY + DOCS + [
    "--data-path", "{docs}", "--split", "8,2,0", "--batch-size", "16",
    "--micro-batch-size", "4", "--rampup-batch-size", "8", "4", "24",
    "--train-steps", "5"]


@pytest.fixture(scope="module")
def resumed(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpt_dp_resume")
    argv = [a.format(**data) for a in RESUME] + [
        "--data-cache-path", data["cache"]]
    save = ["--save", str(tmp / "ck")]
    jobs = [("whole", argv, None, None),
            ("cut", argv + save, None, 2),
            ("resumed", argv + save + ["--resume"], None, None),
            ("batch-9", argv[:-2] + ["--batch-size", "9"], None, None),
            ("micro-3", TINY + ["--batch-size", "12", "--micro-batch-size",
                                "3"], None, None),
            ("rampup-5", TINY + ["--batch-size", "16", "--rampup-batch-size",
                                 "5", "5", "16"], None, None),
            ("tp-2", TINY + ["--tensor-model-parallel-size", "2",
                             "--pipeline-model-parallel-size", "2"], None,
             None),
            ("fsdp-2", TINY + ["--fsdp-parallel-size", "2",
                               "--context-parallel-size", "2"], None, None)]
    return tmp, [dict(zip([j[0] for j in jobs], r))
                 for r in spawn(gpt_rank, WORLD, tmp, jobs)]


def test_sigterm_on_one_rank_then_resume_is_bit_equal(resumed):
    tmp, ranks = resumed
    for r, got in enumerate(ranks):
        whole, cut, res = got["whole"], got["cut"], got["resumed"]
        for run in (whole, cut, res):
            assert "error" not in run, (r, run.get("error"))
            assert run["left"]
        assert cut["last_step"] == 2 and res["last_step"] == 5
        assert cut["history"] == whole["history"][:2]
        assert res["history"] == whole["history"][2:]
        for n, p in whole["params"].items():
            assert torch.equal(res["params"][n], p), (r, n)
    assert ranks[0]["resumed"]["history"] == ranks[1]["resumed"]["history"]
    ck = tmp / "ck"
    assert (ck / "latest_checkpointed_iteration.txt").read_text() == "5"
    assert sorted(os.listdir(ck)) == [
        "iter_0000002", "iter_0000005", "latest_checkpointed_iteration.txt"]


@pytest.mark.parametrize("job,kind,text", [
    ("batch-9", "SystemExit", "multiple of the 2 data-parallel ranks"),
    ("micro-3", "SystemExit", "multiple of the 2 data-parallel ranks"),
    ("rampup-5", "SystemExit", "require multiples of 2"),
    ("tp-2", "NotImplementedError", "Queue A item 5)"),
    ("fsdp-2", "NotImplementedError", "Queue A item 5)")])
def test_what_the_ranks_refuse(resumed, job, kind, text):
    for got in resumed[1]:
        assert got[job]["left"]
        name, msg = got[job]["error"]
        assert name == kind and text in msg, (name, msg)
