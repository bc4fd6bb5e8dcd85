"""Tensor-parallel serving: two gloo ranks on the CPU run the server tool
at --tensor-model-parallel-size 2 (rank 0 answers over HTTP and sends each
generation to rank 1, `inference/server.py`), against the tool in one
process on the same flags, random weights from --seed 0, fp32.

Two models of width 64, 4 heads, the CLIP BPE's vocabulary: megatron's
GPT (learned positions, LayerNorm, gelu, biases, the tied embedding,
split over the ranks on its vocabulary rows) and the example GPT's options
with two k/v heads (one a rank), partial rotary and an untied head (split
on its vocabulary columns). Each answers greedy ragged prompts with
log-probabilities, a top-k / decayed top-p sample and a beam search: the
texts and segments equal one process's, the log-probabilities and the
beam score within 1e-5 (each rank's partial products of wo and w2 summed
by the all-reduce in another order than one product). Every rank samples
the same token: the logits are the same on every rank, and so is its
generator's seed.
"""
import numpy as np

from megatron_clip_tpu_torch.inference.server import run_server
from megatron_clip_tpu_torch.tools import run_text_generation_server as tool
from torch_dp_util import put, serve_rank, spawn
from torch_tp_util import one_thread

BASE = ["--num-layers", "2", "--hidden-size", "64", "--num-heads", "4",
        "--seq-length", "64", "--vocab-size", "49408", "--precision", "fp32",
        "--device", "cpu", "--port", "0"]
MODELS = {
    "megatron": [],
    "example_gqa_untied": ["--position-embedding", "rope", "--swiglu",
                           "--normalization", "rmsnorm", "--kv-heads", "2",
                           "--rotary-percent", "0.5",
                           "--untie-embeddings-and-output-weights"],
}
REQUESTS = [
    {"prompts": ["a photo of a dog", "the cat", "an old map of the city"],
     "tokens_to_generate": 8, "temperature": 0.0, "logprobs": True},
    {"prompts": ["a photo of a dog", "the cat"], "tokens_to_generate": 8,
     "temperature": 0.9, "top_k": 40, "top_p": 0.9, "top_p_decay": 0.9,
     "top_p_bound": 0.5, "random_seed": 5, "logprobs": True},
    {"prompts": ["a photo of"], "tokens_to_generate": 6, "beam_width": 3},
]


def _one_process(argv) -> list:
    service, _ = tool.build(argv)
    srv = run_server(service, port=0)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        return [put(url, r) for r in REQUESTS]
    finally:
        srv.shutdown()


def test_two_tensor_ranks_serve_as_one_process(tmp_path):
    cases = [(name, BASE + flags + ["--tensor-model-parallel-size", "2"],
              REQUESTS) for name, flags in MODELS.items()]
    got = spawn(serve_rank, 2, tmp_path, cases)[0]
    with one_thread():
        want = {name: _one_process(BASE + flags)
                for name, flags in MODELS.items()}
    for name in MODELS:
        # rank 0 holds 2 of the 4 query heads and half the k/v heads
        hkv = 2 if "gqa" in name else 4
        assert got[name]["tp"] == 2
        assert got[name]["wqkv"] == (64, (4 + 2 * hkv) * 16 // 2)
        for (gs, g), (ws, w) in zip(got[name]["answers"], want[name]):
            assert gs == ws == 200, (name, g, w)
            assert g["text"] == w["text"], name
            assert g["segments"] == w["segments"], name
            for key in ("logprobs", "scores"):
                if w.get(key) is not None:
                    for a, b in zip(g[key], w[key]):
                        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                                   err_msg=name)
