"""Bulk text sampling from a GPT checkpoint to a JSONL file.

The counterpart of the root `tools/generate_samples_gpt.py` (megatron's
examples/detxoify_lm/generate_samples_gpt.py): prompts from
--sample-input-file (jsonl with {"prompt": {"text": ...}} or {"prompt":
...} / {"text": ...}, or plain text lines), or --num-samples unconditional
samples (each context a lone <|endoftext|>), generated in batches of
--gen-batch-size and appended as {"prompt": ..., "text": ...} lines to
--genfile.

  python -m megatron_clip_tpu_torch.tools.generate_samples_gpt \\
      --load ckpt --num-layers 12 --hidden-size 768 --num-heads 12 \\
      --num-samples 64 --genfile gens.jsonl --top-p 0.9 [--device cpu]

The model's config comes from --num-layers, --hidden-size, --num-heads,
--vocab-size, --seq-length and --position-embedding alone, as the JAX
tool builds it: a checkpoint of a model with other options (swiglu,
rmsnorm, GQA, an untied head) does not load (a reference defect kept for
parity, ROADMAP). Without --device cpu it wants the card and raises.
"""
import argparse
import json
import time

import numpy as np
import torch

from megatron_clip_tpu_torch.models.gpt import GPTCfg
from megatron_clip_tpu_torch.pretrain_gpt import (parse_args,
                                                  precision_from_args)
from megatron_clip_tpu_torch.tools.run_text_generation_server import (
    build_model, device_from_args, load_params)


def _read_prompts(path):
    prompts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            try:
                j = json.loads(line)
                if isinstance(j, dict):
                    p = j.get("prompt", j.get("text", ""))
                    if isinstance(p, dict):
                        p = p.get("text", "")
                    prompts.append(str(p))
                else:
                    prompts.append(str(j))
            except json.JSONDecodeError:
                prompts.append(line)
    return prompts


def main(argv=None):
    from megatron_clip_tpu_torch.inference.generation import generate
    from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--load", default=None, help="checkpoint root")
    p.add_argument("--genfile", required=True, help="output jsonl")
    p.add_argument("--sample-input-file", default=None,
                   help="prompt file (jsonl or plain lines); unconditional "
                        "sampling when unset")
    p.add_argument("--num-samples", type=int, default=16,
                   help="unconditional sample count (--sample-input-file "
                        "unset)")
    p.add_argument("--out-seq-length", type=int, default=256)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--gen-batch-size", type=int, default=8)
    p.add_argument("--gen-seed", type=int, default=1234)
    gen_args, rest = p.parse_known_args(argv)
    args = parse_args(rest)
    device = device_from_args(args, "generate_samples_gpt")

    tok = SimpleTokenizer()
    cfg = GPTCfg(num_layers=args.num_layers, hidden_size=args.hidden_size,
                 num_heads=args.num_heads, vocab_size=args.vocab_size,
                 seq_length=args.seq_length,
                 position_embedding=args.position_embedding)
    params = None
    if gen_args.load:
        params, step = load_params(gen_args.load)
        print(f"loaded checkpoint @ step {step}", flush=True)
    model = build_model(cfg, precision_from_args(args), params,
                        args.seed).to(device).eval()

    if gen_args.sample_input_file:
        prompts = _read_prompts(gen_args.sample_input_file)
    else:
        prompts = [""] * gen_args.num_samples
    eot = tok.eot_token_id

    bs = gen_args.gen_batch_size
    new_tokens = min(gen_args.out_seq_length, cfg.seq_length - 1)
    t0 = time.time()
    written = 0
    with open(gen_args.genfile, "a", encoding="utf-8") as out:
        for lo in range(0, len(prompts), bs):
            chunk = prompts[lo:lo + bs]
            # unconditional contexts start from a lone EOT (megatron's
            # convention for context-free sampling)
            ids = [tok.encode(c) if c else [eot] for c in chunk]
            max_len = max(len(i) for i in ids)
            batch = np.full((len(ids), max_len), eot, np.int64)
            lens = np.zeros((len(ids),), np.int64)
            for r, seq in enumerate(ids):
                batch[r, :len(seq)] = seq
                lens[r] = len(seq)
            outp, n_gen = generate(
                model, torch.as_tensor(batch, device=device),
                torch.as_tensor(lens, device=device),
                max_new_tokens=new_tokens,
                temperature=0.0 if gen_args.greedy else gen_args.temperature,
                top_k=1 if gen_args.greedy else gen_args.top_k,
                top_p=0.0 if gen_args.greedy else gen_args.top_p,
                eos_id=eot, seed=gen_args.gen_seed + lo,
                return_lengths=True)
            outp, n_gen = outp.cpu().numpy(), n_gen.cpu().numpy()
            for r, c in enumerate(chunk):
                toks = list(outp[r, lens[r]:lens[r] + n_gen[r]])
                if toks and toks[-1] == eot:
                    toks = toks[:-1]
                text = tok.decode([int(t) for t in toks])
                out.write(json.dumps({"prompt": c, "text": text}) + "\n")
                written += 1
            print(f"{written}/{len(prompts)} samples "
                  f"({written / (time.time() - t0):.2f}/s)", flush=True)
    print(f"done: {written} samples -> {gen_args.genfile}", flush=True)


if __name__ == "__main__":
    main()
