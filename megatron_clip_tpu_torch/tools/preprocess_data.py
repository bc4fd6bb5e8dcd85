"""JSONL corpus -> memory-mapped indexed dataset (.bin/.idx).

The counterpart of the root `tools/preprocess_data.py` (megatron's
tools/preprocess_data.py): one document a line, `{"text": "..."}` (the key
is --json-key), tokenized, optionally closed by the tokenizer's EOD id
(--append-eod), and written as int32 tokens, one document a sequence, in
the byte format `data/indexed_dataset.py` reads. Lines that are not JSON,
or whose text is empty, are skipped. The output is byte-equal to the JAX
tool's for the same input and tokenizer, with any --workers.

  python -m megatron_clip_tpu_torch.tools.preprocess_data \\
      --input corpus.jsonl --output-prefix corpus \\
      --tokenizer GPT2BPETokenizer --vocab-file vocab.json \\
      --merge-file merges.txt --append-eod --workers 4

--tokenizer: clip-bpe (the CLIP BPE of `tokenizer/clip_bpe.py`, EOD
<|endoftext|>), or a megatron tokenizer type of
`tokenizer/megatron_tokenizers.build_tokenizer` (GPT2BPETokenizer,
NullTokenizer). `hf:<name>` (a transformers AutoTokenizer) raises
NotImplementedError (ROADMAP Queue A item 7), as do the tokenizers
`build_tokenizer` refuses. --workers > 1 tokenizes in a pool of spawned
processes, the documents kept in their order.
"""
import argparse
import json
import multiprocessing as mp
import time

import numpy as np

from megatron_clip_tpu_torch.data.indexed_dataset import (
    MMapIndexedDatasetBuilder)


def make_tokenizer(kind: str, vocab_file=None, merge_file=None,
                   tokenizer_model=None):
    """-> (encode(text) -> ids, eod_id)."""
    if kind == "clip-bpe":
        from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
        tok = SimpleTokenizer()
        return tok.encode, tok.eot_token_id
    if kind.startswith("hf:"):
        raise NotImplementedError("--tokenizer hf:<name> (a transformers "
                                  "AutoTokenizer) is not ported yet "
                                  "(ROADMAP Queue A item 7)")
    from megatron_clip_tpu_torch.tokenizer.megatron_tokenizers import (
        build_tokenizer)
    try:
        tok = build_tokenizer(kind, vocab_file=vocab_file,
                              merge_file=merge_file,
                              tokenizer_model=tokenizer_model)
    except ValueError:
        raise ValueError(f"unknown tokenizer {kind!r} "
                         "(clip-bpe | megatron tokenizer type)")
    return tok.tokenize, tok.eod


_worker = None  # (encode, eod, json_key, append_eod) of this process


def _init_worker(kind, vocab_file, merge_file, tokenizer_model, json_key,
                 append_eod):
    global _worker
    encode, eod = make_tokenizer(kind, vocab_file, merge_file,
                                 tokenizer_model)
    _worker = (encode, eod, json_key, append_eod)


def _encode(line: str):
    encode, eod, json_key, append_eod = _worker
    try:
        doc = json.loads(line)
    except json.JSONDecodeError:
        return None
    text = doc.get(json_key, "")
    if not text:
        return None
    ids = encode(text)
    if append_eod:
        ids = list(ids) + [eod]
    return np.asarray(ids, np.int32)


def parse_args(argv=None):
    p = argparse.ArgumentParser("megatron_clip_tpu_torch preprocess_data")
    p.add_argument("--input", required=True, help="jsonl file")
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--json-key", default="text")
    p.add_argument("--tokenizer", default="clip-bpe")
    p.add_argument("--vocab-file", default=None)
    p.add_argument("--merge-file", default=None)
    p.add_argument("--tokenizer-model", default=None)
    p.add_argument("--append-eod", action="store_true")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=10000)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the corpus; returns {"docs", "tokens", "seconds" (the whole
    run, the tokenizers' start included), "tokens_per_s" (from the first
    document's tokens to the end: the rate past the start)}."""
    args = parse_args(argv)
    init = (args.tokenizer, args.vocab_file, args.merge_file,
            args.tokenizer_model, args.json_key, args.append_eod)
    t0 = time.time()
    _init_worker(*init)  # here first: a tokenizer that fails, fails here
    builder = MMapIndexedDatasetBuilder(args.output_prefix, dtype=np.int32)
    n = tokens = 0
    pool = None
    with open(args.input) as f:
        if args.workers > 1:
            pool = mp.get_context("spawn").Pool(
                args.workers, initializer=_init_worker, initargs=init)
            it = pool.imap(_encode, f, chunksize=32)
        else:
            it = map(_encode, f)
        try:
            t_first = None
            for ids in it:
                t_first = t_first or time.time()
                if ids is None or len(ids) == 0:
                    continue
                builder.add_item(ids)
                builder.end_document()
                n += 1
                tokens += len(ids)
                if n % args.log_interval == 0:
                    rate = n / (time.time() - t0)
                    print(f"{n} docs, {tokens} tokens ({rate:.0f} docs/s)",
                          flush=True)
        finally:
            if pool is not None:
                pool.close()
                pool.join()
    builder.finalize()
    t_end = time.time()
    steady = t_end - (t_first or t_end)
    out = {"docs": n, "tokens": tokens, "seconds": t_end - t0,
           "tokens_per_s": tokens / steady if steady > 0 else 0.0}
    print(f"done: {n} docs, {tokens} tokens -> {args.output_prefix}.bin/.idx "
          f"in {out['seconds']:.2f} s ({out['tokens_per_s']:.0f} tokens/s "
          "from the first document on)", flush=True)
    return out


if __name__ == "__main__":
    main()
