"""Shared helpers of the GPT trainer tests (`test_torch_pretrain_gpt.py`,
`test_torch_workload.py`): the tiny model's flags, a corpus writer, the
JAX entry's run with its initial parameters and final val loss captured,
and the port's run started from those parameters."""
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pretrain_gpt as jax_pretrain_gpt  # noqa: E402
from megatron_clip_tpu.training import workload as jax_workload  # noqa: E402
from megatron_clip_tpu_torch import pretrain_gpt  # noqa: E402
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax  # noqa: E402
from megatron_clip_tpu_torch.data import indexed_dataset  # noqa: E402

TINY = ["--num-layers", "2", "--hidden-size", "64", "--num-heads", "4",
        "--seq-length", "32", "--vocab-size", "384", "--precision", "fp32",
        "--warmup", "1", "--log-interval", "1"]


def write_corpus(prefix, n_docs: int = 120, seed: int = 0,
                 vocab: int = 384) -> str:
    """An indexed corpus of n_docs documents of 5-120 ids below `vocab`."""
    rng = np.random.default_rng(seed)
    b = indexed_dataset.MMapIndexedDatasetBuilder(prefix)
    for _ in range(n_docs):
        b.add_item(rng.integers(0, vocab, int(rng.integers(5, 120))))
        b.end_document()
    b.finalize()
    return str(prefix)


def jax_run(argv: list) -> dict:
    """The JAX entry's `run` on argv: its result, its initial and final
    parameters (numpy) and, when the run evaluates, the val loss of its final
    parameters over --eval-iters batches of a fresh validation stream (the
    JAX log prints it to 4 decimals only)."""
    cap = {}
    orig = jax_workload.run_workload

    def wrapped(params, loss_fn, batches, rc, **kw):
        cap["init"] = jax.tree.map(np.asarray, params)
        out = orig(params, loss_fn, batches, rc, **kw)
        cap["final"] = jax.tree.map(np.asarray, out["params"])
        if rc.eval_interval:
            vit, ev = kw["val_iter_factory"](), kw["eval_loss_fn"]
            cap["val_loss"] = float(np.mean([
                float(ev(out["params"], jax.numpy.asarray(next(vit))))
                for _ in range(rc.eval_iters)]))
        return out
    jax_workload.run_workload = wrapped
    try:
        out = jax_pretrain_gpt.run(jax_pretrain_gpt.parse_args(argv))
    finally:
        jax_workload.run_workload = orig
    return dict(out, **cap)


def bridge_init(monkeypatch, init) -> None:
    """Make the port entry's model start from the JAX tree `init`."""
    create = pretrain_gpt.create_gpt

    def bridged(cfg, **kw):
        model = create(cfg, **kw)
        model.load_state_dict(gpt_params_from_jax(
            init, cfg, dtype=model.tok_embed.dtype))
        return model
    monkeypatch.setattr(pretrain_gpt, "create_gpt", bridged)


def port_run(argv: list) -> dict:
    return pretrain_gpt.run(pretrain_gpt.parse_args(argv + ["--device",
                                                            "cpu"]))
