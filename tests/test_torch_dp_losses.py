"""The port's sharded contrastive losses (`losses.py` with a group) against
the JAX package's `axis_name` forms under `shard_map`, at W = 2 and 4.

The port's ranks are processes over gloo on the CPU
(`torch_dp_util.loss_rank`); the JAX side runs on the conftest's virtual
CPU devices, as `tests/test_losses.py` does. The features are 16 rows of
8, L2-normalised, the JAX test's `_features`.

- `gather_features`, with and without its gradient: the gathered rows
  equal the global features exactly, and the gradients of a weighted sum
  of them within 1e-6 of JAX's.
- `ClipLoss` in all four `local_loss` x `gather_with_grad` combinations
  and `SigLipLoss` with its ring exchange (a bias too): the loss within
  1e-6 relative of the JAX sharded loss on every rank, and the gradients
  of the features, logit_scale and logit_bias within 1e-6 (absolute, fp32
  sums in another order) of the JAX gradient of that loss. A rank's
  backward leaves the gradient of the sum of every rank's loss, as under
  DDP: W times the mean loss's, for the features of its rows; summed over
  ranks for the shared logit_scale and bias. The test divides by W, as
  the trainer's gradient all-reduce does.
- The refusals of the data-parallel trainer (two ranks): a global batch
  that does not split into M x W rows, webdataset shards with
  --accum-freq on two ranks, and the item-5 flags, each before the run
  trains a step; every rank leaves its group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from megatron_clip_tpu.losses import ClipLoss, SigLipLoss, gather_features
from torch_dp_util import loss_rank, refusal_rank, spawn

N, D = 16, 8
CASES = [("gather_with_grad", "gather", {"gather_with_grad": True}),
         ("gather_without_grad", "gather", {"gather_with_grad": False})] + [
    (f"clip_local{int(ll)}_grad{int(gg)}", "clip",
     {"local_loss": ll, "gather_with_grad": gg})
    for ll in (True, False) for gg in (True, False)] + [
    ("siglip", "siglip", {})]


def _features(key):
    ki, kt = jax.random.split(key)
    img = jax.random.normal(ki, (N, D))
    txt = jax.random.normal(kt, (N, D))
    return (img / jnp.linalg.norm(img, axis=-1, keepdims=True),
            txt / jnp.linalg.norm(txt, axis=-1, keepdims=True))


def _jax_case(mesh, kind, flags, img, txt, scale, bias, w_img, w_txt):
    """The JAX value (a rank's sharded result, and for a gather the
    gathered arrays) and gradients wrt (img, txt, scale, bias)."""
    if kind == "gather":
        def body(i, t):
            gi, gt = gather_features(i, t, "data", **flags)
            return gi, gt
        gathered = jax.shard_map(body, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P(), P()), check_vma=False)

        def f(i, t, s, b):
            # every shard's sum of its own gathered copy, then the mean
            def one(i, t):
                gi, gt = gather_features(i, t, "data", **flags)
                v = (gi * w_img).sum() + (gt * w_txt).sum()
                return jax.lax.pmean(v, "data")[None]
            return jax.shard_map(one, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=P())(i, t)[0]
        extra = [np.asarray(x) for x in jax.jit(gathered)(img, txt)]
    else:
        loss_obj = (ClipLoss(axis_name="data", **flags) if kind == "clip"
                    else SigLipLoss(axis_name="data"))

        def f(i, t, s, b):
            def one(i, t):
                if kind == "clip":
                    return loss_obj(i, t, s)[None]
                return loss_obj(i, t, s, b)[None]
            return jax.shard_map(one, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=P())(i, t)[0]
        extra = None
    value, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        img, txt, scale, bias)
    return float(value), extra, [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world_run(request, devices8, tmp_path_factory):
    """Both sides of every case at W ranks: the JAX results and each port
    rank's."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dp_losses_w{world}")
    img, txt = _features(jax.random.PRNGKey(world))
    rng = np.random.default_rng(world)
    w_img = rng.standard_normal((N, D)).astype(np.float32)
    w_txt = rng.standard_normal((N, D)).astype(np.float32)
    scale, bias = jnp.asarray(7.5), jnp.asarray(-10.0)
    np.savez(tmp / "inputs.npz", img=np.asarray(img), txt=np.asarray(txt),
             scale=np.float32(scale), bias=np.float32(bias), w_img=w_img,
             w_txt=w_txt)
    mesh = Mesh(np.array(devices8[:world]), ("data",))
    want = {name: _jax_case(mesh, kind, flags, img, txt, scale, bias,
                            jnp.asarray(w_img), jnp.asarray(w_txt))
            for name, kind, flags in CASES}
    got = spawn(loss_rank, world, tmp, CASES)
    return world, want, got, (np.asarray(img), np.asarray(txt))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_loss_matches_jax_shard_map(world_run, name):
    world, want, got, (img, txt) = world_run
    value, gathered, (g_img, g_txt, g_scale, g_bias) = want[name]
    kind = dict((c[0], c[1]) for c in CASES)[name]
    n = N // world
    for r, ranks in enumerate(got):
        res = ranks[name]
        rows = slice(r * n, (r + 1) * n)
        if kind == "gather":
            # a rank's value is its own weighted sum; JAX's the mean of them
            np.testing.assert_array_equal(res["gathered"][0], img)
            np.testing.assert_array_equal(res["gathered"][1], txt)
            np.testing.assert_array_equal(gathered[0], img)
        else:
            np.testing.assert_allclose(res["loss"], value, rtol=1e-6,
                                       err_msg=f"rank {r} loss")
        np.testing.assert_allclose(res["img"] / world, g_img[rows], rtol=0,
                                   atol=1e-6, err_msg=f"rank {r} img grad")
        np.testing.assert_allclose(res["txt"] / world, g_txt[rows], rtol=0,
                                   atol=1e-6, err_msg=f"rank {r} txt grad")
    if kind == "gather":
        np.testing.assert_allclose(np.mean([r[name]["loss"] for r in got]),
                                   value, rtol=1e-6)
        return
    scale = sum(r[name]["scale"] for r in got) / world
    np.testing.assert_allclose(scale, g_scale, rtol=1e-6, atol=1e-6)
    if kind == "siglip":
        bias = sum(r[name]["bias"] for r in got) / world
        np.testing.assert_allclose(bias, g_bias, rtol=1e-6, atol=1e-6)


TINY = ["--dataset-type", "synthetic", "--epochs", "1", "--precision",
        "fp32", "--model", "test-tiny", "--train-num-samples", "32",
        "--device", "cpu"]
REFUSALS = [
    # (argv, exception type, text it names)
    (["--batch-size", "9"], "ValueError", "must be a multiple of 1 x 2 = 2"),
    (["--batch-size", "12", "--accum-freq", "4"], "ValueError",
     "--batch-size 12 does not split into 4 microbatches on each of 2 "
     "ranks"),
    (["--batch-size", "16", "--accum-freq", "2", "--dataset-type",
      "webdataset", "--train-data", "none-{0..1}.tar"],
     "NotImplementedError", "Queue A item 5)"),
    (["--batch-size", "16", "--tensor-model-parallel-size", "2"],
     "NotImplementedError", "Queue A item 5)"),
    # FSDP is ported (test_torch_fsdp_clip.py); the pipeline beside it is
    # not
    (["--batch-size", "16", "--pipeline-model-parallel-size", "2",
      "--fsdp-parallel-size", "2"],
     "NotImplementedError", "Queue A item 5)"),
    (["--batch-size", "16", "--dcn-data-parallel-size", "2"],
     "NotImplementedError", "Queue A item 5)"),
    (["--batch-size", "16", "--extra-world-size", "2"],
     "NotImplementedError", "Queue A item 5)"),
]


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    return spawn(refusal_rank, 2, tmp_path_factory.mktemp("dp_refuse"),
                 [TINY + argv for argv, _, _ in REFUSALS])


@pytest.mark.parametrize("i", range(len(REFUSALS)),
                         ids=[f"{a[1]}-{a[-1]}" for a, _, _ in REFUSALS])
def test_two_rank_refusals(refusals, i):
    """Each rank raises the refusal (exactly: the type, and the numbers or
    the Queue A item it names) and leaves no group behind."""
    _, kind, text = REFUSALS[i]
    for rank in refusals:
        (got, left) = rank[i]
        assert got is not None and got[0] == kind and text in got[1], got
        assert left
