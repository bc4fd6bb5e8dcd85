"""Tensor parallelism (with sequence parallelism) and FSDP of the port's GPT
trainer, over four gloo ranks on the CPU.

- The rank layout is the JAX mesh's device order, tensor fastest, and each
  group's ranks are the devices along its mesh axes.
- Splitting a whole state into every rank's shards and putting them back
  is bit-equal; the packed projections split on their segments (each
  tensor rank's q, k and v heads; its value and gate halves); the bridge
  gives a rank its shards of the JAX package's parameters.
- `pretrain_gpt` on 4 ranks at tp2 x fsdp2, with and without
  --sequence-parallel, against the JAX `pretrain_gpt.run` at the same
  layout on 4 of the suite's virtual CPU devices (losses within rtol 2e-4,
  atol 2e-5, the JAX suite's bound of a sharded step against one device,
  tests/test_parallel.py), and against the port's one process within the
  bounds of tests/test_torch_gpt_dp.py (losses 1e-6 relative at step 1,
  1e-5 after; each rank's shard of each final parameter within 1e-3 of
  the distance the steps moved it), each step's grad norm within 1e-5 and
  each shard of the first step's gradients within 1e-5 of its norm (the
  norms, the row-parallel biases and pos_embed among them, whose
  gradients the tensor ranks sum).
- Each rank's parameter and moment bytes are at most 0.26 of one
  process's at tp2 x fsdp2.
- Checkpoints hold whole tensors: a tp2 x fsdp2 save resumes there
  bit-equal to the whole run, and at tp1 (one process); a one-process save
  resumes at tp2 x fsdp2.
The two-rank cases (dropout over the global batch, tp2 alone, the
document flags) are tests/test_torch_tp_dropout.py's.
"""
import jax
import numpy as np
import pytest
import torch

from megatron_clip_tpu.config import ParallelCfg
from megatron_clip_tpu.models.gpt import GPTCfg as JaxGPTCfg, init_gpt
from megatron_clip_tpu.parallel.mesh import build_mesh
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.checkpoints import load_checkpoint
from megatron_clip_tpu_torch.models.gpt import GPTCfg
from megatron_clip_tpu_torch.parallel import mesh, sharding
from megatron_clip_tpu_torch.parallel.mesh import Layout
from torch_dp_util import gpt_rank, spawn
from torch_gpt_util import TINY, jax_run, port_run
from torch_tp_util import (close_to_one_process, gpt_cfg, grads_close,
                           model_of, one_process_argv, one_process_params,
                           one_thread, rank_layout, shards_close)

WORLD = 4
TPF = ["--tensor-model-parallel-size", "2", "--fsdp-parallel-size", "2"]
SP = ["--sequence-parallel"]
BASE = TINY + ["--batch-size", "16", "--train-steps", "2"]
# pretrain_gpt_dist.sh's options but the fused CE (the JAX package's runs
# its Pallas kernel in interpret mode here)
DIST = ["--position-embedding", "rope", "--swiglu", "--normalization",
        "rmsnorm", "--recompute-granularity", "selective"]
JAX_CASES = {"tp2-fsdp2": BASE + TPF,
             "tp2-fsdp2-sp": BASE + TPF + SP + DIST}
# wide enough that the few weights every rank holds whole (the norms, the
# row-parallel biases) weigh what they weigh in a real model
CKPT = TINY + ["--batch-size", "16"] + TPF + [
    "--hidden-size", "256", "--vocab-size", "1024",
    "--position-embedding", "rope"]


def test_the_rank_layout_is_the_jax_mesh_order():
    """Rank (d fsdp + f) tp + t is the JAX mesh's device at (d, f, t), and
    every group of an axis holds the devices along that axis."""
    m = build_mesh(ParallelCfg(dp=2, fsdp=2, tp=2), jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(m.devices)[:, :, 0, 0, :]
    for d, f, t in np.ndindex(2, 2, 2):
        assert ids[d, f, t] == mesh.rank_of(d, f, t, 2, 2)
    want = {"tensor": [list(ids[d, f]) for d in range(2) for f in range(2)],
            "fsdp_group": [list(ids[d, :, t]) for d in range(2)
                           for t in range(2)],
            "batch": [list(ids[:, :, t].reshape(-1)) for t in range(2)],
            "data": [list(ids[:, f, t]) for f in range(2) for t in range(2)],
            "model": [list(ids[d].reshape(-1)) for d in range(2)]}
    assert mesh.axis_ranks(2, 2, 2) == want


def _layouts(fsdp: int, tp: int) -> list:
    return [Layout(fsdp=fsdp, tp=tp, f=f, t=t)
            for f in range(fsdp) for t in range(tp)]


CFGS = {"learned-gelu-ln": GPTCfg(num_layers=2, hidden_size=64, num_heads=4,
                                  vocab_size=384, seq_length=32),
        "rope-swiglu-gqa-untied": GPTCfg(
            num_layers=2, hidden_size=64, num_heads=4, kv_heads=2,
            vocab_size=384, seq_length=32, position_embedding="rope",
            swiglu=True, normalization="rmsnorm", tie_embeddings=False)}


@pytest.mark.parametrize("name", list(CFGS))
def test_split_then_gather_is_bit_equal(name):
    """Every rank's shards of a whole state, put back together (the fsdp
    blocks, then the tensor pieces on their segments), are the state."""
    model = model_of(CFGS[name])
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    specs = sharding.gpt_param_specs(whole)
    tp_most = 4 if CFGS[name].kv_heads is None else 2
    for fsdp, tp in ((2, 2), (1, tp_most), (4, 1)):
        lays = _layouts(fsdp, tp)
        pls = sharding.placements(model, specs, lays[0])
        shards = [sharding.split_state(whole, pls, lay) for lay in lays]
        for n, w in whole.items():
            pl = pls[n]
            pieces = []
            for t in range(tp):
                mine = [shards[f * tp + t][n] for f in range(fsdp)]
                pieces.append(mine[0] if pl.fsdp_dim is None
                              else torch.cat(mine, pl.fsdp_dim))
            got = (pieces[0] if pl.tensor_dim is None
                   else sharding._merge(pieces, pl.tensor_dim, pl.segments))
            assert torch.equal(got, w), (name, fsdp, tp, n)
            if pl.tensor_dim is None and pl.fsdp_dim is None:
                assert all(torch.equal(s[n], w) for s in shards)


def test_the_packed_projections_split_on_their_segments():
    """Tensor rank t's wqkv holds its query heads, then its k and v heads;
    its bqkv likewise; its swiglu w1 and b1 its value half, then its gate
    half."""
    model = model_of(CFGS["rope-swiglu-gqa-untied"])
    whole = {n: p.detach() for n, p in model.named_parameters()}
    lays = _layouts(1, 2)
    pls = sharding.placements(model, sharding.gpt_param_specs(whole),
                              lays[0])
    d, heads, hkv = 16, 4, 2
    ffn = whole["blocks.0.mlp.w1"].shape[1] // 2
    for t, lay in enumerate(lays):
        got = sharding.split_state(whole, pls, lay)
        for w in ("wqkv", "bqkv"):
            q, k, v = whole[f"blocks.0.attn.{w}"].split(
                [heads * d, hkv * d, hkv * d], dim=-1)
            want = torch.cat([q.chunk(2, -1)[t], k.chunk(2, -1)[t],
                              v.chunk(2, -1)[t]], -1)
            assert torch.equal(got[f"blocks.0.attn.{w}"], want)
        for w in ("w1", "b1"):
            value, gate = whole[f"blocks.0.mlp.{w}"].split(ffn, dim=-1)
            want = torch.cat([value.chunk(2, -1)[t], gate.chunk(2, -1)[t]],
                             -1)
            assert torch.equal(got[f"blocks.0.mlp.{w}"], want)
        # row-parallel: rows of wo (its heads' outputs); vocab rows
        assert torch.equal(got["blocks.0.attn.wo"],
                           whole["blocks.0.attn.wo"].chunk(2, 0)[t])
        assert torch.equal(got["tok_embed"],
                           whole["tok_embed"].chunk(2, 0)[t])


def test_heads_that_do_not_split_raise():
    model = model_of(CFGS["rope-swiglu-gqa-untied"])
    specs = sharding.gpt_param_specs(dict(model.named_parameters()))
    with pytest.raises(ValueError, match="kv heads must each split"):
        sharding.placements(model, specs, Layout(tp=4))


def test_a_sharded_state_loads_through_the_bridge():
    """`bridge.gpt_params_from_jax(..., model=)` gives each rank of a
    sharded model its shards of the JAX package's parameters."""
    jcfg = JaxGPTCfg(num_layers=2, hidden_size=64, num_heads=4, kv_heads=2,
                     vocab_size=384, seq_length=32,
                     position_embedding="rope", swiglu=True,
                     normalization="rmsnorm", tie_embeddings=False)
    tree = init_gpt(jax.random.PRNGKey(0), jcfg)
    cfg = CFGS["rope-swiglu-gqa-untied"]
    whole = gpt_params_from_jax(tree, cfg)
    for lay in _layouts(2, 2):
        model = model_of(cfg)
        sharding.shard_model(model, sharding.gpt_param_specs(
            dict(model.named_parameters())), lay)
        model.load_state_dict(gpt_params_from_jax(tree, cfg, model=model))
        for n, p in model.named_parameters():
            assert torch.equal(p, sharding.split_tensor(
                whole[n], model.placements[n], lay)), n


def _jax_run_on_four(argv) -> dict:
    """The JAX entry's run on the first 4 virtual devices: tp2 x fsdp2 is
    then its whole mesh (dp 1), the port's layout."""
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: devices(*a)[:WORLD])
        return jax_run(argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the port's one-process runs and, in one spawn of 4
    ranks, the layouts' runs and the checkpoint jobs."""
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    jax_runs = {c: _jax_run_on_four(a) for c, a in JAX_CASES.items()}
    one = {c: one_process_params(a, jax_runs[c]["init"])
           for c, a in JAX_CASES.items()}
    # a one-process save at step 2, for the ranks to resume
    with one_thread():
        port_run(one_process_argv(CKPT) + ["--train-steps", "2", "--save",
                                           str(tmp / "one")])
    jobs = ([(c, a, {k: v.numpy() for k, v in gpt_params_from_jax(
                jax_runs[c]["init"], gpt_cfg(a)).items()}, None)
             for c, a in JAX_CASES.items()]
            + [("ck-whole", CKPT + ["--train-steps", "3"], None, None),
               ("ck-cut", CKPT + ["--train-steps", "2", "--save",
                                  str(tmp / "tp")], None, None),
               ("ck-resumed", CKPT + ["--train-steps", "3", "--load",
                                      str(tmp / "tp")], None, None),
               ("ck-from-one", CKPT + ["--train-steps", "3", "--load",
                                       str(tmp / "one")], None, None)])
    ranks = spawn(gpt_rank, WORLD, tmp / "ranks", jobs)
    got = {tag: [r[i] for r in ranks] for i, (tag, *_) in enumerate(jobs)}
    for tag, per_rank in got.items():
        for r, res in enumerate(per_rank):
            assert "error" not in res, (tag, r, res.get("error"))
            assert res["left"], (tag, r)
    # the tp2 x fsdp2 save resumed in one process
    whole_one = one_process_params(CKPT + ["--train-steps", "3"])
    from_tp = one_process_params(CKPT + ["--train-steps", "3", "--load",
                                         str(tmp / "tp")])
    return {"jax": jax_runs, "one": one, "ranks": got, "tmp": tmp,
            "whole_one": whole_one, "from_tp": from_tp}


def _losses(res) -> np.ndarray:
    return np.array([l for _, l in res["history"]])


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_four_ranks_match_the_jax_run_and_one_process(case, runs):
    want = runs["jax"][case]
    one = runs["one"][case]
    cfg = gpt_cfg(JAX_CASES[case])
    init = gpt_params_from_jax(want["init"], cfg)
    ranks = runs["ranks"][case]
    np.testing.assert_allclose(_losses(ranks[0]), _losses(want), rtol=2e-4,
                               atol=2e-5)
    for r, got in enumerate(ranks):
        assert got["history"] == ranks[0]["history"], r
        close_to_one_process(got, one, f"{case} rank {r}")
        grads_close(got["grads1"], one["grads1"], cfg, rank_layout(r, 2, 2),
                    f"{case} rank {r}")
        shards_close(got["params"], one["params"], init, cfg,
                     rank_layout(r, 2, 2), f"{case} rank {r}")


def test_each_rank_holds_a_quarter_of_the_state(runs):
    """At tp2 x fsdp2 a rank's parameters and Adam moments take at most
    0.26 of one process's bytes; a save gathers the whole state onto rank
    0's host alone (its parameters and both moments, the other ranks
    keeping nothing of it)."""
    one = sum(p.numel() * 4 for p in model_of(gpt_cfg(CKPT)).parameters())
    for r, got in enumerate(runs["ranks"]["ck-whole"]):
        b = got["state_bytes"]
        assert b["params"] <= 0.26 * one, (r, b, one)
        assert b["moments"] <= 0.26 * 2 * one, (r, b, one)
    saved = [got["save_bytes"] for got in runs["ranks"]["ck-cut"]]
    assert saved == [3 * one] + [0] * (WORLD - 1), (saved, one)


def test_a_checkpoint_holds_whole_tensors(runs):
    tree, _, step = load_checkpoint(str(runs["tmp"] / "tp"))
    assert step == 2
    for n, p in model_of(gpt_cfg(CKPT)).named_parameters():
        assert tree["params"][n].shape == p.shape, n
        assert tree["opt_state"]["mu"][n].shape == p.shape, n


def test_a_same_layout_resume_is_bit_equal_to_the_whole_run(runs):
    ranks = runs["ranks"]
    for r in range(WORLD):
        whole, cut, res = (ranks[k][r] for k in ("ck-whole", "ck-cut",
                                                 "ck-resumed"))
        assert cut["history"] == whole["history"][:2]
        assert res["history"] == whole["history"][2:]
        for n, p in whole["params"].items():
            assert torch.equal(res["params"][n], p), (r, n)


def test_checkpoints_resume_across_layouts(runs):
    """tp2 x fsdp2 -> one process and one process -> tp2 x fsdp2: the
    resumed step within the one-process bounds of the whole run."""
    whole = {k: runs["whole_one"][k][2:] for k in ("history", "grad_norms")}
    close_to_one_process(runs["from_tp"], whole, "tp2 x fsdp2 -> 1")
    for r, got in enumerate(runs["ranks"]["ck-from-one"]):
        close_to_one_process(got, whole, f"1 -> tp2 x fsdp2 rank {r}")
