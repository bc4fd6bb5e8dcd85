"""The port's REST server (`inference/server.py`) and its tools against the
JAX package's on the CPU: both servers on `127.0.0.1` port 0, over the same
weights (a small GPT, 2 layers of width 64, the CLIP BPE's vocabulary of
49408; JAX `init_gpt` moved by seeded noise and bridged, see
`tests/torch_gen_util.py`), answer the same requests with the same JSON:
the texts and segments equal, the log-probabilities and the beam score
within 1e-5 (fp32 sums in another order, the decode's tolerance), the 400
messages and the index page equal.

The tools: `run_text_generation_server` serving a checkpoint that one CPU
step of the port's `pretrain_gpt` wrote; `generate_samples_gpt` writing its
jsonl from it; the CLI's round trip. `generate_samples_gpt` builds its
model from its six flags alone (layers, width, heads, vocabulary, sequence
length, positions), as the JAX tool does (a reference defect kept for
parity): the checkpoint here is of pretrain_gpt's defaults, which those
describe. Refusals: int8 decode weights (Queue A item 4), pipeline serving
(item 5), and no CUDA device without --device cpu.
"""
import io
import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from megatron_clip_tpu.inference import server as jserver
from megatron_clip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from megatron_clip_tpu_torch import pretrain_gpt
from megatron_clip_tpu_torch.checkpoints.io import load_checkpoint
from megatron_clip_tpu_torch.inference import server as tserver
from megatron_clip_tpu_torch.inference.generation import generate
from megatron_clip_tpu_torch.models.gpt import GPTModel, create_gpt
from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
from megatron_clip_tpu_torch.tools import generate_samples_gpt, \
    run_text_generation_server as tool, text_generation_cli
from torch_gen_util import pair

VOCAB = 49408
TIMEOUT_S = 120
MODEL_FLAGS = ["--num-layers", "2", "--hidden-size", "64", "--num-heads",
               "4", "--seq-length", "32", "--vocab-size", str(VOCAB)]


def _put(url: str, body: bytes):
    req = urllib.request.Request(url + "/api", method="PUT", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


def _url(srv) -> str:
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """(the JAX server's url, the port's, the port's service)."""
    jcfg, params, _, model = pair("learned", vocab_size=VOCAB)
    jtok, tok = JaxTokenizer(), SimpleTokenizer()
    js = jserver.run_server(jserver.GenerationService(
        params, jcfg, jtok, eos_id=jtok.eot_token_id), port=0)
    service = tserver.GenerationService(model, tok, eos_id=tok.eot_token_id)
    ts = tserver.run_server(service, port=0)
    yield _url(js), _url(ts), service
    js.shutdown()
    ts.shutdown()


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert got["text"] == want["text"]
    assert got["segments"] == want["segments"]
    for key in ("logprobs", "scores"):
        if key not in want:
            continue
        if want[key] is None:
            assert got[key] is None
            continue
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _greedy(service, ids: list, n: int) -> list:
    """The port's greedy generation of n tokens after `ids`."""
    out = generate(service.model, torch.tensor([ids]),
                   torch.tensor([len(ids)]), max_new_tokens=n,
                   temperature=0.0)
    return out[0, len(ids):].tolist()


REQUESTS = {
    "greedy_logprobs": {"prompts": ["a photo of", "the cat sat on a mat"],
                        "tokens_to_generate": 6, "temperature": 0.0,
                        "logprobs": True},
    "greedy": {"prompts": ["a photo of", "the cat sat on a mat"],
               "tokens_to_generate": 6, "temperature": 0.0},
    "segments_non_ascii": {"prompts": ["a café photo"],
                           "tokens_to_generate": 6, "temperature": 0.0,
                           "logprobs": True},
    "stop_token_bos": {"prompts": ["a photo of"], "tokens_to_generate": 6,
                       "temperature": 0.0, "add_BOS": True,
                       "logprobs": True, "stop_token": "third"},
    "stop_on_eol": {"prompts": ["a photo of"], "tokens_to_generate": 6,
                    "temperature": 0.0, "logprobs": True,
                    "stop_on_eol": True, "stop_on_double_eol": True},
    "beam": {"prompts": ["a photo of"], "tokens_to_generate": 5,
             "beam_width": 2, "length_penalty": 0.9},
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_same_json_as_the_jax_server(servers, case):
    jurl, turl, service = servers
    req = dict(REQUESTS[case])
    if req.get("stop_token") == "third":  # the third token, with the BOS
        tok = service.tokenizer
        ids = [tok.eot_token_id] + tok.encode(req["prompts"][0])
        gen = _greedy(service, ids, 6)
        req["stop_token"] = gen[2]
    body = json.dumps(req).encode()
    (js, want), (ts, got) = _put(jurl, body), _put(turl, body)
    assert js == ts == 200, (want, got)
    _same(got, want)
    if case == "segments_non_ascii":
        assert "café" in "".join(got["segments"][0])
    if case == "stop_token_bos":  # cut before the stop token
        assert len(got["segments"][0]) == len(ids) + gen.index(gen[2])


@pytest.mark.parametrize("body", [
    {"prompts": [""], "tokens_to_generate": 4},
    {"prompts": [""], "beam_width": 2},
    {"prompts": ["a", "b"], "beam_width": 2},
    {"prompts": []},
    {"prompts": ["x"], "prevent_newline_after_colon": True},
    {"tokens_to_generate": 4},
    b"not json",
], ids=["empty", "empty_beam", "beam_two_prompts", "no_prompts",
        "newline_after_colon", "missing_prompts", "bad_body"])
def test_same_400_messages(servers, body):
    jurl, turl, _ = servers
    body = body if isinstance(body, bytes) else json.dumps(body).encode()
    (js, want), (ts, got) = _put(jurl, body), _put(turl, body)
    assert js == ts == 400
    assert got == want and set(got) == {"message"}


def test_same_index_page_and_404(servers):
    jurl, turl, _ = servers
    assert _get(turl + "/") == _get(jurl + "/")
    assert _get(turl + "/")[1] == jserver._INDEX_HTML.encode()
    assert _get(turl + "/nope")[0] == _get(jurl + "/nope")[0] == 404


def test_sampling_follows_the_request_seed(servers):
    _, turl, _ = servers
    req = {"prompts": ["one", "two three"], "tokens_to_generate": 5,
           "temperature": 1.0, "top_k": 5, "top_p": 0.9, "top_p_decay": 0.9,
           "top_p_bound": 0.5, "random_seed": 7}
    a, b = (_put(turl, json.dumps(req).encode()) for _ in range(2))
    c = _put(turl, json.dumps(dict(req, random_seed=8)).encode())
    assert a[0] == b[0] == c[0] == 200
    assert a[1] == b[1] and a[1]["segments"] != c[1]["segments"]


def test_the_cli_round_trip(servers, monkeypatch, capsys):
    _, turl, _ = servers
    monkeypatch.setattr(sys, "stdin", io.StringIO("a photo of\n\nthe dog\n"))
    assert text_generation_cli.main([turl, "4", "0.0"]) == 0
    printed = capsys.readouterr().out.splitlines()
    want = [_put(turl, json.dumps({"prompts": [p], "tokens_to_generate": 4,
                                   "temperature": 0.0}).encode())[1]["text"][0]
            for p in ("a photo of", "the dog")]
    assert printed == want


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint root written by one CPU step of the port's
    pretrain_gpt (its defaults: learned positions, LayerNorm, gelu, biases,
    the tied embedding), and its params."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    pretrain_gpt.main(MODEL_FLAGS + [
        "--precision", "fp32", "--batch-size", "2", "--train-steps", "1",
        "--lr", "1e-2", "--warmup", "1", "--save", root, "--save-interval",
        "1", "--device", "cpu"])
    return root, load_checkpoint(root)[0]["params"]


def test_the_server_tool_serves_a_trained_checkpoint(trained):
    root, params = trained
    service, port = tool.build(MODEL_FLAGS + ["--load", root, "--port", "0",
                                              "--device", "cpu"])
    assert port == 0 and service.compute_dtype == torch.float32
    got = service.model.state_dict()
    assert all(torch.equal(got[k], params[k]) for k in params)
    seeded = create_gpt(service.model.cfg, device="cpu").state_dict()
    assert not torch.equal(got["tok_embed"], seeded["tok_embed"])
    srv = tserver.run_server(service, port=0)
    try:
        req = {"prompts": ["a photo of", "a dog"], "tokens_to_generate": 5,
               "temperature": 0.0, "logprobs": True}
        status, out = _put(_url(srv), json.dumps(req).encode())
    finally:
        srv.shutdown()
    model = GPTModel(service.model.cfg)
    model.load_state_dict(params)
    tok = SimpleTokenizer()
    want = tserver.GenerationService(model.eval(), tok,
                                     eos_id=tok.eot_token_id)(
        req["prompts"], 5, 0.0, return_logprobs=True)
    assert status == 200
    assert (out["text"], out["segments"], out["logprobs"]) == want
    with pytest.raises(ValueError, match="do not match"):
        tool.build(MODEL_FLAGS + ["--swiglu", "--load", root, "--device",
                                  "cpu"])


def test_generate_samples_writes_its_jsonl(trained, tmp_path):
    root, params = trained
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text('{"prompt": {"text": "a photo of"}}\nthe dog\n\n'
                       '{"text": "a cat"}\n', encoding="utf-8")
    genfile = tmp_path / "gens.jsonl"
    generate_samples_gpt.main(MODEL_FLAGS + [
        "--load", root, "--genfile", str(genfile), "--sample-input-file",
        str(prompts), "--greedy", "--out-seq-length", "5",
        "--gen-batch-size", "2", "--device", "cpu"])
    lines = [json.loads(x) for x in genfile.read_text().splitlines()]
    assert [x["prompt"] for x in lines] == ["a photo of", "the dog", "a cat"]
    model = GPTModel(pretrain_gpt.gpt_cfg_from_args(
        pretrain_gpt.parse_args(MODEL_FLAGS)))
    model.load_state_dict(params)
    tok = SimpleTokenizer()
    texts, _, _ = tserver.GenerationService(
        model.eval(), tok, eos_id=tok.eot_token_id)(
            [x["prompt"] for x in lines], 5, 0.0)
    for line, text in zip(lines, texts):
        prompt_text = tok.decode(tok.encode(line["prompt"]))
        assert prompt_text + line["text"] == text


@pytest.mark.parametrize("flags,match", [
    (["--quantize-matmuls", "int8"], "Queue A item 4"),
    (["--pipeline-model-parallel-size", "2"], "Queue A item 5"),
])
def test_the_tool_refuses_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        tool.build(MODEL_FLAGS + flags + ["--device", "cpu"])


def test_a_pipeline_mesh_names_its_item(servers):
    _, _, service = servers
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        tserver.GenerationService(service.model, service.tokenizer,
                                  mesh={"tensor": 1, "stage": 2})


def test_the_card_is_the_default_and_its_absence_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default serves on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.build(MODEL_FLAGS)
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate_samples_gpt.main(MODEL_FLAGS + [
            "--genfile", str(tmp_path / "g.jsonl")])
