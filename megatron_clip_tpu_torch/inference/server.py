"""REST text-generation server.

Counterpart of `megatron_clip_tpu/inference/server.py` (megatron's
`MegatronServer`, text_generation_server.py, and
tools/run_text_generation_server.py) on the standard library's
http.server, with the same API and the same JSON, field for field:

  PUT /api  {"prompts": [...], "tokens_to_generate": N,
             "temperature": t, "top_k": k, "top_p": p,
             "top_p_decay": d, "top_p_bound": b, "add_BOS": bool,
             "stop_token": id, "stop_on_eol": bool,
             "stop_on_double_eol": bool, "random_seed": s,
             "logprobs": bool}
  -> {"text": [prompt+generation, ...], "segments": [[piece, ...], ...],
      "logprobs": [[lp, ...], ...] | null}

  PUT /api  {"prompts": [one], "beam_width": K, "length_penalty": a}
  -> {"text": [...], "segments": [...], "logprobs": null,
      "scores": [best]}   (batch size 1)

POST is PUT; GET / serves a playground page; a bad request is a 400 with
{"message"}. Prompt lengths are padded to powers of two from 16
(`_bucket`), as in the JAX server, whose buckets bound its recompiles.

Tensor-parallel serving (a model sharded over its layout's tensor group,
`tools/run_text_generation_server.py` under torchrun): rank 0 runs the HTTP
server, and before each generation broadcasts the request's arrays and
options over the host group (`parallel/mesh.control`); every rank runs it,
the others in `follow`, which a `stop` from rank 0 ends (megatron's design,
text_generation_server.py's send_do_generate / send_do_beam_search). The
JAX package gets the same result from one process under a mesh.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from megatron_clip_tpu_torch.inference.beam_search import beam_search
from megatron_clip_tpu_torch.inference.generation import generate
from megatron_clip_tpu_torch.parallel import mesh as pmesh


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


class GenerationService:
    """A GPT model and its tokenizer as a prompt -> text callable.

    `mesh`: the serving mesh's axis sizes, as the JAX mesh's `shape`
    ({"tensor": tp, "stage": pp}); a pipeline (`stage` above 1) is not
    ported yet (ROADMAP Queue A item 5), and `tensor` must be the model's
    tensor-parallel size (`parallel/sharding.shard_model`). Above 1 the
    ranks of the launch serve together (see the module's note).
    `compute_dtype`: the decode's (default: bf16 on the card, fp32 on the
    CPU)."""

    MAX_TOKENS_TO_GENERATE = 1024

    def __init__(self, model, tokenizer, eos_id: Optional[int] = None,
                 mesh: Optional[Mapping[str, int]] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        mesh = dict(mesh or {})
        if mesh.get("stage", 1) > 1:
            raise NotImplementedError(
                "GenerationService: pipeline-parallel serving (pp_generate, "
                "pp_beam_search) is not ported yet (ROADMAP Queue A item 5)")
        if mesh.get("tensor", 1) != model.tp:
            raise ValueError(f"mesh tensor size {mesh.get('tensor', 1)} != "
                             f"the model's tensor-parallel size {model.tp}")
        self.model = model
        self.tokenizer = tokenizer
        self.eos_id = eos_id if eos_id is not None else -1
        self.compute_dtype = compute_dtype
        self.device = model.tok_embed.device
        self.distributed = model.tp > 1
        self._lock = threading.Lock()

    @property
    def leader(self) -> bool:
        """Whether this process answers the requests (rank 0)."""
        return not self.distributed or dist.get_rank() == 0

    def _segment(self, token: int) -> str:
        """A token's surface string (megatron tokenization.py
        detokenize_generations' word loop): its decoder-table entry mapped
        back through byte_decoder for a byte-level BPE, the CLIP BPE's
        end-of-word marker as a trailing space."""
        dec = getattr(self.tokenizer, "decoder", None)
        bd = getattr(self.tokenizer, "byte_decoder", None)
        if isinstance(dec, dict) and token in dec:
            word = dec[token]
            if isinstance(bd, dict):
                word = bytearray(bd[c] for c in word if c in bd).decode(
                    "utf-8", errors="replace")
            return word.replace("</w>", " ")
        try:
            return self.tokenizer.decode([int(token)])
        except Exception:  # noqa: BLE001 (the JAX server's fallback)
            return str(int(token))

    # ------------------------------------------------------------------
    # the generations, on every rank

    def _broadcast(self, job) -> None:
        dist.broadcast_object_list([job], src=0, group=pmesh.control())

    def _run(self, kind: str, job: dict):
        """Run one generation (`kind` "generate" or "beam"), on every rank
        of a tensor-parallel launch: rank 0 sends it to the others first.
        One at a time."""
        with self._lock:
            if self.distributed:
                self._broadcast((kind, job))
            return self._execute(kind, job)

    def _execute(self, kind: str, job: dict):
        def tensor(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)
        if kind == "generate":
            res = generate(self.model, tensor(job["batch"]),
                           tensor(job["lens"]),
                           compute_dtype=self.compute_dtype, **job["kw"])
        else:
            res = beam_search(self.model, tensor(job["ids"]),
                              compute_dtype=self.compute_dtype, **job["kw"])
        return tuple(r.cpu().numpy() for r in res)

    def follow(self) -> None:
        """A tensor-parallel rank other than 0: run every generation rank 0
        sends, until it sends `stop`."""
        while True:
            got = [None]
            dist.broadcast_object_list(got, src=0, group=pmesh.control())
            if got[0] is None:
                return
            self._execute(*got[0])

    def stop(self) -> None:
        """Rank 0: release the other ranks' `follow`."""
        if self.distributed and self.leader:
            with self._lock:
                self._broadcast(None)

    # ------------------------------------------------------------------
    # the requests, on rank 0

    def __call__(self, prompts, tokens_to_generate=32, temperature=1.0,
                 top_k=0, top_p=0.0, seed=0, add_bos=False,
                 top_p_decay=0.0, top_p_bound=0.0, stop_token=None,
                 stop_on_eol=False, stop_on_double_eol=False,
                 return_logprobs=False):
        """(texts, segments, logprobs), the reference's
        generate_and_post_process triple (text_generation/api.py): `text`
        is the prompt and generation detokenized, `segments` the per-token
        pieces of that sequence, `logprobs` the selected tokens'
        log-probabilities (len(segments) - 1 each) when asked for."""
        tokens_to_generate = max(1, min(int(tokens_to_generate),
                                        self.MAX_TOKENS_TO_GENERATE))
        ids = [self.tokenizer.encode(p) for p in prompts]
        if add_bos and self.eos_id >= 0:
            # megatron add_BOS prepends tokenizer.eod (tokenization.py)
            ids = [[self.eos_id] + seq for seq in ids]
        if any(len(seq) == 0 for seq in ids):
            # the next-token gather would read index -1; megatron requires
            # add_BOS for empty prompts (tokenization.py)
            if self.eos_id >= 0:
                raise ValueError("empty prompt (tokenizes to zero tokens); "
                                 "pass add_BOS to generate unconditionally")
            raise ValueError("empty prompt (tokenizes to zero tokens); "
                             "this tokenizer has no BOS/EOD token, so "
                             "empty prompts are unsupported")
        max_len = _bucket(max(len(i) for i in ids))
        batch = np.zeros((len(ids), max_len), np.int64)
        lens = np.zeros((len(ids),), np.int64)
        for r, seq in enumerate(ids):
            batch[r, :len(seq)] = seq
            lens[r] = len(seq)
        kw = dict(max_new_tokens=tokens_to_generate,
                  temperature=float(temperature), top_k=int(top_k),
                  top_p=float(top_p), eos_id=self.eos_id, seed=seed,
                  return_lengths=True, top_p_decay=float(top_p_decay),
                  top_p_bound=float(top_p_bound),
                  return_logprobs=bool(return_logprobs))
        res = self._run("generate", {"batch": batch, "lens": lens, "kw": kw})
        if return_logprobs:
            out, n_gen, lp = res
        else:
            (out, n_gen), lp = res, None
        texts, segments, logprobs = [], [], []
        for r in range(len(ids)):
            gen_toks = list(out[r, lens[r]:lens[r] + n_gen[r]])
            if gen_toks and gen_toks[-1] == self.eos_id:
                gen_toks = gen_toks[:-1]  # n_gen counts the EOS; drop it
            if stop_token is not None and int(stop_token) in gen_toks:
                gen_toks = gen_toks[:gen_toks.index(int(stop_token))]
            gen_text = self.tokenizer.decode([int(t) for t in gen_toks])
            # stop_on_eol / stop_on_double_eol end the generation at the
            # marker, cut by token position (through the token that
            # completes it) so that the segments and the logprobs stay
            # aligned with what was sampled
            marker = ("\n\n" if stop_on_double_eol else
                      "\n" if stop_on_eol else None)
            if marker is not None and marker in gen_text:
                for k in range(1, len(gen_toks) + 1):
                    prefix = self.tokenizer.decode(
                        [int(t) for t in gen_toks[:k]])
                    if marker in prefix:
                        gen_toks = gen_toks[:k]
                        gen_text = prefix[:prefix.index(marker)]
                        break
            prompt_text = self.tokenizer.decode([int(t) for t in ids[r]])
            texts.append(prompt_text + gen_text)
            seq = [int(t) for t in ids[r]] + [int(t) for t in gen_toks]
            segments.append([self._segment(t) for t in seq])
            if lp is not None:
                # the row: the prompt's at [0, len-1), the generation's
                # at [len-1, len-1+n); cut to len(segments)-1 (api.py)
                row = list(map(float, lp[r, :lens[r] - 1])) + \
                    list(map(float, lp[r, lens[r] - 1:
                                       lens[r] - 1 + len(gen_toks)]))
                logprobs.append(row[:max(0, len(seq) - 1)])
        return texts, segments, (logprobs if lp is not None else None)

    def beam(self, prompts, tokens_to_generate=32, beam_width=4,
             length_penalty=1.0):
        """megatron text_generation_server's beam path (batch size 1, the
        reference's 'When doing beam_search, batch size must be 1')."""
        if len(prompts) != 1:
            raise ValueError("beam search requires exactly one prompt")
        tokens_to_generate = max(1, min(int(tokens_to_generate),
                                        self.MAX_TOKENS_TO_GENERATE))
        ids = self.tokenizer.encode(prompts[0])
        if not ids:
            raise ValueError("empty prompt (tokenizes to zero tokens)")
        # finished beams are frozen by extending with the EOS; without one,
        # token 0 plays that role, and the same id cuts the text below
        eff_eos = self.eos_id if self.eos_id >= 0 else 0
        toks, scores = self._run("beam", {
            "ids": np.asarray([ids], np.int64),
            "kw": dict(beam_size=int(beam_width),
                       max_new_tokens=tokens_to_generate, eos_id=eff_eos,
                       length_penalty=float(length_penalty))})
        best = list(toks[0, 0, len(ids):])
        if eff_eos in best:
            best = best[:best.index(eff_eos)]
        seq = [int(t) for t in ids] + [int(t) for t in best]
        text = self.tokenizer.decode([int(t) for t in ids]) + \
            self.tokenizer.decode([int(t) for t in best])
        return [text], [[self._segment(t) for t in seq]], \
            float(scores[0, 0])


_INDEX_HTML = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8"/>
<title>megatron_clip_tpu text generation</title>
<style>
 body{font-family:sans-serif;max-width:46rem;margin:2rem auto;padding:0 1rem}
 textarea{width:100%;min-height:14rem;font-family:inherit;padding:.5rem;
          border:1px solid #ccc;border-radius:6px}
 .row{display:flex;gap:1rem;margin:.7rem 0;align-items:center}
 input[type=number]{width:6rem} button{padding:.4rem 1.2rem}
 #status{color:#777;font-size:.85rem}
</style></head><body>
<h1>Text generation</h1>
<p id="status">PUT /api playground (same JSON contract as the REST API;
the reference serves an equivalent page from megatron/static/index.html).</p>
<textarea id="box" placeholder="Type a prompt, then Generate."></textarea>
<div class="row">
 <label>tokens <input id="n" type="number" value="32" min="1"/></label>
 <label>temperature <input id="t" type="number" value="1.0" step="0.1"/></label>
 <label>top_k <input id="k" type="number" value="0" min="0"/></label>
 <button id="go">Generate</button>
</div>
<script>
const el=i=>document.getElementById(i);
el('go').onclick=async()=>{
  el('status').textContent='generating...';
  try{
    const r=await fetch('/api',{method:'PUT',
      headers:{'Content-Type':'application/json'},
      body:JSON.stringify({prompts:[el('box').value],
        tokens_to_generate:+el('n').value,temperature:+el('t').value,
        top_k:+el('k').value})});
    const j=await r.json();
    if(!r.ok){el('status').textContent='error: '+(j.message||r.status);return;}
    el('box').value=j.text[0];
    el('status').textContent='done';
  }catch(e){el('status').textContent='error: '+e;}
};
</script></body></html>
"""


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # the playground at / (the reference Flask server's static
            # index.html)
            if self.path in ("/", "/index.html"):
                self._send(200, _INDEX_HTML.encode(),
                           "text/html; charset=utf-8")
            else:
                self.send_error(404)

        def do_PUT(self):
            if self.path.rstrip("/") != "/api":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                prompts = req["prompts"]
                if not isinstance(prompts, list) or not prompts:
                    raise ValueError("prompts must be a non-empty list")
                if req.get("prevent_newline_after_colon"):
                    raise ValueError("prevent_newline_after_colon is not "
                                     "supported (GPT2-BPE-specific logit "
                                     "mask in the reference)")
                if req.get("beam_width"):
                    texts, segments, score = service.beam(
                        prompts,
                        tokens_to_generate=req.get("tokens_to_generate", 32),
                        beam_width=req.get("beam_width"),
                        length_penalty=req.get("length_penalty", 1.0))
                    body = json.dumps({"text": texts, "segments": segments,
                                       "logprobs": None,
                                       "scores": [score]}).encode()
                else:
                    texts, segments, logprobs = service(
                        prompts,
                        tokens_to_generate=req.get("tokens_to_generate", 32),
                        temperature=req.get("temperature", 1.0),
                        top_k=req.get("top_k", 0),
                        top_p=req.get("top_p", 0.0),
                        seed=req.get("random_seed", 0),
                        add_bos=req.get("add_BOS", False),
                        top_p_decay=req.get("top_p_decay", 0.0),
                        top_p_bound=req.get("top_p_bound", 0.0),
                        stop_token=req.get("stop_token"),
                        stop_on_eol=req.get("stop_on_eol", False),
                        stop_on_double_eol=req.get("stop_on_double_eol",
                                                   False),
                        return_logprobs=req.get("logprobs", False))
                    body = json.dumps({"text": texts, "segments": segments,
                                       "logprobs": logprobs}).encode()
                self._send(200, body, "application/json")
            except Exception as e:  # noqa: BLE001 (the client's error)
                self._send(400, json.dumps({"message": str(e)}).encode(),
                           "application/json")

        do_POST = do_PUT

        def log_message(self, *a):  # quiet
            pass

    return Handler


def run_server(service: GenerationService, host: str = "127.0.0.1",
               port: int = 5000) -> ThreadingHTTPServer:
    """Serve `service` on a thread; returns the server (its
    `server_address` has the port, which port 0 lets the system pick)."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
