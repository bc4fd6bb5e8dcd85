"""The port's `pretrain_gpt` against the JAX package's `run`, on the CPU.

Both entries train the tiny GPT (2 layers, width 64, S = 32, vocab 384)
in fp32 from the same initial parameters (the JAX tree carried into the
port's model through `bridge.gpt_params_from_jax`), on the same data: the
synthetic stream and an indexed corpus (the train split, the valid split
for the evals), plain and with --micro-batch-size accumulation and
--rampup-batch-size (on the synthetic stream with SGD, a linear lr decay
and a scheduled weight decay too). Each logged loss within 1e-6 relative at step 1 and 1e-5 after
(the JAX run shards the batch over 8 virtual devices and sums in another
order), and the last eval's val loss within 1e-5 (the JAX val loss is its
final parameters' on a fresh validation stream, as its eval reads it).
"""
import numpy as np
import pytest

from torch_gpt_util import TINY, bridge_init, jax_run, port_run, write_corpus

SYNTH = TINY + ["--batch-size", "16", "--train-steps", "4",
                "--eval-interval", "4", "--eval-iters", "2"]
CASES = {
    "synthetic": SYNTH,
    "synthetic-micro-rampup-sgd": SYNTH + [
        "--micro-batch-size", "8", "--rampup-batch-size", "8", "8", "16",
        "--optimizer", "sgd", "--lr", "1e-2", "--lr-decay-style", "linear",
        "--min-lr", "1e-3", "--weight-decay-incr-style", "linear",
        "--start-weight-decay", "0.01", "--end-weight-decay", "0.1"],
    "indexed": TINY + [
        "--data-path", "{corpus}", "--split", "8,2,0", "--batch-size", "16",
        "--train-steps", "4", "--eval-interval", "2", "--eval-iters", "2"],
    "indexed-micro-rampup-cyclic": TINY + [
        "--data-path", "{corpus}", "--split", "8,2,0", "--batch-size", "32",
        "--micro-batch-size", "8", "--rampup-batch-size", "16", "16", "32",
        "--dataloader-type", "cyclic", "--train-steps", "4",
        "--eval-interval", "4", "--eval-iters", "2"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus") / "c")


def _argv(case, corpus, cache):
    argv = [a.format(corpus=corpus) for a in CASES[case]]
    if "--data-path" in argv:
        argv += ["--data-cache-path", cache]
    return argv


@pytest.fixture(scope="module")
def jax_runs(corpus, tmp_path_factory):
    return {case: jax_run(_argv(case, corpus,
                                str(tmp_path_factory.mktemp("jax_cache"))))
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_the_port_entry_matches_the_jax_entry(case, corpus, jax_runs,
                                              monkeypatch, tmp_path):
    want = jax_runs[case]
    bridge_init(monkeypatch, want["init"])
    got = port_run(_argv(case, corpus, str(tmp_path)))
    assert got["last_step"] == want["last_step"]
    steps = [i for i, _ in want["history"]]
    assert [i for i, _ in got["history"]] == steps == list(
        range(1, want["last_step"] + 1))
    for (i, g), (_, w) in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g, w, rtol=1e-6 if i == 1 else 1e-5,
                                   err_msg=f"{case} step {i}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["val_history"][-1][0] == want["last_step"]
