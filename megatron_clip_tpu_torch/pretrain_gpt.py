"""GPT pretraining entry point of the port.

The counterpart of the root `pretrain_gpt.py` (megatron's pretrain_gpt.py
through megatron/training.py:60 pretrain()) on one device, or
data-parallel over the ranks of a torchrun launch, through
`training/workload.py::run_workload`:

  # an indexed corpus, written from a jsonl by tools/preprocess_data.py
  python -m megatron_clip_tpu_torch.tools.preprocess_data \\
      --input corpus.jsonl --output-prefix corpus --tokenizer clip-bpe \\
      --append-eod --workers 4
  # the model of examples/pretrain_gpt_dist.sh on one card, 8 microbatches
  # of 8 a step, with saves, resume and eval
  python -m megatron_clip_tpu_torch.pretrain_gpt \\
      --num-layers 24 --hidden-size 1024 --num-heads 16 \\
      --seq-length 2048 --vocab-size 50304 --position-embedding rope \\
      --swiglu --normalization rmsnorm --fused-ce \\
      --recompute-granularity selective --precision bf16 \\
      --batch-size 64 --micro-batch-size 8 --lr 3e-4 --weight-decay 0.1 \\
      --data-path corpus --save ckpt --save-interval 1000 --resume \\
      --eval-interval 1000 --eval-iters 20
  # the one-card rung of examples/pretrain_gpt_ladder.sh, synthetic data
  python -m megatron_clip_tpu_torch.pretrain_gpt --num-layers 24 \\
      --hidden-size 2048 --num-heads 16 --seq-length 2048 --batch-size 4 \\
      --recompute-granularity mlp --params-dtype bf16 --nu-dtype bf16 \\
      --loss-seq-chunk 512
  # on the CPU, a tiny model
  python -m megatron_clip_tpu_torch.pretrain_gpt --device cpu \\
      --num-layers 2 --hidden-size 64 --num-heads 4 --seq-length 64 \\
      --vocab-size 512 --batch-size 8 --precision fp32 --train-steps 4
  # the same over two gloo ranks on the CPU, with the document flags
  python -m torch.distributed.run --nproc-per-node 2 \\
      -m megatron_clip_tpu_torch.pretrain_gpt --device cpu \\
      --num-layers 2 --hidden-size 64 --num-heads 4 --seq-length 64 \\
      --vocab-size 512 --batch-size 8 --micro-batch-size 4 \\
      --precision fp32 --train-steps 4 --data-path corpus \\
      --eod-token 0 --eod-mask-loss --reset-position-ids \\
      --reset-attention-mask
  # examples/pretrain_gpt_dist.sh's layout on four cards: tensor
  # parallelism 2 with sequence parallelism, FSDP 2
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m megatron_clip_tpu_torch.pretrain_gpt --num-layers 24 \\
      --hidden-size 1024 --num-heads 16 --seq-length 2048 \\
      --vocab-size 50304 --position-embedding rope --swiglu \\
      --normalization rmsnorm --fused-ce --recompute-granularity selective \\
      --precision bf16 --batch-size 64 --tensor-model-parallel-size 2 \\
      --fsdp-parallel-size 2 --sequence-parallel

Its flags are the JAX parser's, plus `--device` (cuda, the default, or
cpu: without a CUDA device and without `--device cpu` it raises); as in
the JAX entry, megatron's `--distributed-backend` is a no-op. Under
torchrun the data-parallel group's backend is nccl on the card and gloo on
the CPU (a caller may set `args.dist_backend`, e.g. gloo for two ranks on
one card), its init method env:// (or an `args.dist_url` set by a caller).
Under torchrun every rank trains its rows
of the global batch (`--batch-size` and `--micro-batch-size` count global
rows, as the JAX runtime counts them; see `training/workload.py`), on
cuda:LOCAL_RANK. With --tensor-model-parallel-size and
--fsdp-parallel-size the W ranks lay out as dp x fsdp x tp (dp = W / (tp
fsdp)): the model is drawn whole, then each rank keeps its shards of it
(`parallel/sharding.py`, the JAX `gpt_param_specs`), the blocks run
tensor-parallel, with --sequence-parallel on S/tp rows between the
products, and the checkpoints hold whole tensors, so that a run resumes
at any layout. Data:
`--data-path` (an indexed corpus prefix; `--split`'s train range, its
valid range for `--eval-interval`; `--dataloader-type`, `--data-cache-path`)
or, without it, the JAX entry's synthetic stream (per-step seeded
RandomState draws, and a validation stream of its own). The model is the
port's `models/gpt.py` on the flags' `GPTCfg`, its weights drawn from
`--seed`; the loss `gpt_loss` (`--fused-ce`, `--loss-seq-chunk`) under
`--recompute-granularity` (none, selective, mlp, full), with dropout at the
flags' rates. `--precision` bf16 (or amp_bf16) computes in bf16, anything
else in fp32 (as the JAX entry decides; --bf16 / --fp16 map to bf16);
`--params-dtype bf16` stores the weights in bf16.

The document-boundary flags (--eod-mask-loss, --reset-position-ids,
--reset-attention-mask, which need --eod-token) run megatron's
get_ltor_masks_and_position_ids on each batch's inputs
(`models/gpt.py`) and the loss on pre-shifted targets, as the JAX entry
does: the loss mask's mean counts the whole global batch's tokens, per-row
positions index the learned or rotary tables, and the document mask sends
every layer's attention to the unfused `sdpa_bshd` ([B, H, S, S] fp32
logits a layer, as in the JAX package).

Options not taken raise NotImplementedError naming their ROADMAP Queue A
item: --quantize-matmuls int8, --kv-channels, --squared-relu and
--num-experts (item 4); --context-parallel-size and the pipeline and
cross-slice parallel sizes above 1 (item 5). --sequence-parallel at
--tensor-model-parallel-size 1 changes nothing, as in the JAX entry (its
sequence sharding is over the tensor axis, of size 1).
"""
import argparse

import numpy as np
import torch

from megatron_clip_tpu_torch.config import Precision
from megatron_clip_tpu_torch.models.gpt import (
    GPTCfg, create_gpt, get_ltor_masks_and_position_ids, gpt_loss)
from megatron_clip_tpu_torch.parallel import mesh
from megatron_clip_tpu_torch.parallel.sharding import (gpt_param_specs,
                                                       shard_model)
from megatron_clip_tpu_torch.training.workload import (
    add_runtime_args, build_workload_mesh, maybe_apply_checkpoint_args,
    run_workload,
    runtime_cfg_from_args, vocab_size_from_tokenizer_args)


def parse_args(argv=None):
    p = argparse.ArgumentParser("megatron_clip_tpu_torch GPT pretraining")
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--num-heads", "--num-attention-heads",
                   type=int, default=12)
    p.add_argument("--kv-heads", "--num-query-groups", type=int,
                   default=None,
                   help="GQA kv-head count (megatron --num-query-groups;\n"
                        "--group-query-attention is implied when set)")
    p.add_argument("--group-query-attention",
                   action="store_true",
                   help="accepted for megatron CLI parity; GQA activates\n"
                        "when --num-query-groups/--kv-heads is set")
    p.add_argument("--ffn-hidden-size", type=int, default=None,
                   help="MLP hidden size (megatron --ffn-hidden-size;\n"
                        "default 4*hidden, or swiglu sizing)")
    p.add_argument("--kv-channels", type=int, default=None,
                   help="per-head projection dim when not hidden/heads "
                        "(megatron --kv-channels)")
    p.add_argument("--max-position-embeddings", type=int, default=None,
                   help="learned position-table length >= --seq-length "
                        "(megatron --max-position-embeddings)")
    p.add_argument("--seq-length", type=int, default=1024)
    p.add_argument("--vocab-size", type=int, default=50304)
    p.add_argument("--make-vocab-size-divisible-by", type=int, default=None,
                   help="pad --vocab-size up to a multiple (megatron "
                        "--make-vocab-size-divisible-by, x tp size there)")
    p.add_argument("--position-embedding", choices=["learned", "rope"],
                   default="learned")
    p.add_argument("--rotary-percent", type=float, default=1.0,
                   help="rotate only the first head_dim*percent channels "
                        "(megatron --rotary-percent)")
    p.add_argument("--rotary-seq-len-interpolation-factor", type=float,
                   default=None,
                   help="divide rope positions for linear context extension "
                        "(megatron flag of the same name)")
    p.add_argument("--swiglu", action="store_true")
    p.add_argument("--squared-relu", action="store_true",
                   help="relu(x)^2 MLP activation (megatron --squared-relu)")
    p.add_argument("--init-method-std", type=float, default=0.02,
                   help="stddev of weight init (megatron --init-method-std)")
    p.add_argument("--normalization", choices=["layernorm", "rmsnorm"],
                   default="layernorm")
    p.add_argument("--disable-bias-linear", action="store_true")
    p.add_argument("--untie-embeddings-and-output-weights", action="store_true")
    p.add_argument("--num-experts", type=int, default=0)
    p.add_argument("--sequence-parallel", action="store_true")
    p.add_argument("--context-parallel-size", type=int, default=1,
                   help="shard the sequence over a ring of ranks "
                        "(ROADMAP Queue A item 5)")
    p.add_argument("--context-parallel-layout",
                   choices=["contiguous", "zigzag"], default="contiguous",
                   help="context parallelism's chunk order (item 5)")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--params-dtype", choices=["fp32", "bf16"],
                   default="fp32",
                   help="bf16 = the parameters in bf16 (open_CLIP "
                        "pure_bf16; with --nu-dtype bf16 the ladder's 1.3b "
                        "rung)")
    p.add_argument("--recompute-granularity",
                   choices=["none", "selective", "mlp", "full"], default="none")
    p.add_argument("--quantize-matmuls", choices=["none", "int8"],
                   default="none",
                   help="int8 MLP GEMMs (ROADMAP Queue A item 4)")
    p.add_argument("--data-path", type=str, default=None,
                   help="indexed dataset prefix (.bin/.idx); synthetic if unset")
    p.add_argument("--data-cache-path", type=str, default=None,
                   help="directory for the packing-index cache instead of "
                        "next to the data (megatron --data-cache-path)")
    p.add_argument("--split", type=str, default="969,30,1",
                   help="train/valid/test doc-split weights over --data-path "
                        "(megatron --split semantics); --eval-interval "
                        "validates on the valid range")
    p.add_argument("--loss-seq-chunk", type=int, default=0,
                   help="compute lm-head + cross-entropy in sequence chunks "
                        "of this size (recomputed in backward): caps peak "
                        "logits memory at [B,chunk,V]")
    p.add_argument("--fused-ce", action="store_true",
                   help="the fused lm-head + cross-entropy kernel: the "
                        "logits are never formed (ops/kernels/fused_ce.py)")
    p.add_argument("--eod-token", type=int, default=None,
                   help="end-of-document token id (megatron reads it from "
                        "the tokenizer; required by the document-boundary "
                        "flags below)")
    p.add_argument("--eod-mask-loss", action="store_true",
                   help="zero the loss at EOD input positions (megatron "
                        "--eod-mask-loss)")
    p.add_argument("--reset-position-ids", action="store_true",
                   help="restart position ids after each EOD (megatron "
                        "--reset-position-ids)")
    p.add_argument("--reset-attention-mask", action="store_true",
                   help="block attention across EOD boundaries (megatron "
                        "--reset-attention-mask)")
    p.add_argument("--attention-dropout", type=float, default=0.0,
                   help="attention-prob dropout (megatron default 0.1)")
    p.add_argument("--hidden-dropout", type=float, default=0.0,
                   help="hidden/embedding dropout (megatron default 0.1)")
    p.add_argument("--device", default=None,
                   help="where to train: cuda (the default) or cpu")
    add_runtime_args(p, lr=3e-4, weight_decay=0.1)
    return p.parse_args(argv)


def gpt_cfg_from_args(args) -> GPTCfg:
    """The port's GPTCfg from the parsed entry flags (the JAX
    `gpt_cfg_from_args`), with the dropout rates and
    --recompute-granularity, which the port's config carries."""
    # megatron sizes the embedding from --vocab-file/--merge-file when
    # given; --vocab-size (+ optional explicit padding) otherwise
    vocab = vocab_size_from_tokenizer_args(args)
    if vocab is None:
        vocab = args.vocab_size
        if args.make_vocab_size_divisible_by:
            d = args.make_vocab_size_divisible_by
            vocab = -(-vocab // d) * d
    return GPTCfg(
        num_layers=args.num_layers, hidden_size=args.hidden_size,
        num_heads=args.num_heads, kv_heads=args.kv_heads,
        kv_channels=args.kv_channels,
        max_position_embeddings=args.max_position_embeddings,
        mlp_ratio=(args.ffn_hidden_size / args.hidden_size
                   if args.ffn_hidden_size else 4.0),
        vocab_size=vocab, seq_length=args.seq_length,
        position_embedding=args.position_embedding,
        rotary_percent=args.rotary_percent,
        rope_interpolation=args.rotary_seq_len_interpolation_factor,
        swiglu=args.swiglu, squared_relu=args.squared_relu,
        normalization=args.normalization,
        use_bias=not args.disable_bias_linear,
        num_experts=args.num_experts,
        init_std=args.init_method_std,
        tie_embeddings=not args.untie_embeddings_and_output_weights,
        attention_dropout=args.attention_dropout,
        hidden_dropout=args.hidden_dropout,
        remat=args.recompute_granularity)


# (Queue A item, flag, whether args ask for it): the GPT entry's own
_REFUSED = (
    (4, "--quantize-matmuls int8", lambda a: a.quantize_matmuls != "none"),
    (5, "--context-parallel-size > 1", lambda a: a.context_parallel_size > 1),
)


def doc_flags(args) -> bool:
    return bool(args.eod_mask_loss or args.reset_position_ids
                or args.reset_attention_mask)


def check_supported(args) -> None:
    """Raise NotImplementedError for the first flag of the GPT entry the port
    does not carry yet, naming its ROADMAP Queue A item (the runtime's own
    are `training/workload.py::_REFUSED`; the model's, `GPTCfg`'s). The
    document flags without --eod-token exit, as in the JAX entry."""
    for item, flag, asked in _REFUSED:
        if asked(args):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP "
                                      f"Queue A item {item})")
    if doc_flags(args) and args.eod_token is None:
        raise SystemExit("--eod-mask-loss/--reset-position-ids/"
                         "--reset-attention-mask need --eod-token")


def precision_from_args(args) -> Precision:
    """bf16 compute for --precision bf16 / amp_bf16, else fp32 (the JAX
    entry's rule); the weights in bf16 with --params-dtype bf16."""
    compute = ("bfloat16" if args.precision in ("bf16", "amp_bf16")
               else "float32")
    param = "bfloat16" if args.params_dtype == "bf16" else "float32"
    return Precision(param_dtype=param, compute_dtype=compute)


def run(args, device=None, timeout=None) -> dict:
    """Train as `args` say, on `device` (default `args.device`, else the
    card); returns {"loss", "history", "last_step", "val_history",
    "val_loss"} (val_loss: the last eval's, or --skip-train's), the global
    batch's on every rank. Under torchrun the process joins its ranks'
    group first (`build_workload_mesh`; `timeout`, a timedelta, bounds its
    collectives) and leaves it on every way out."""
    args = maybe_apply_checkpoint_args(args)
    check_supported(args)
    rc = runtime_cfg_from_args(args, "gpt")  # --bf16/--fp16 remapped here
    device = torch.device(device or args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pretrain_gpt: no CUDA device is available; pass "
                           "--device cpu to train on the CPU")
    cfg = gpt_cfg_from_args(args)
    cfg.transformer()  # the model's refusals, before anything is built
    device = build_workload_mesh(rc, device, args, timeout)
    try:
        return _run(args, rc, cfg, device)
    finally:
        mesh.destroy()


def _run(args, rc, cfg: GPTCfg, device: torch.device) -> dict:
    if args.adam_beta2 is None:
        rc.beta2 = 0.95  # the megatron GPT recipe default
    rc.tokens_per_sample = args.seq_length
    model = create_gpt(cfg, precision=precision_from_args(args),
                       device=device, seed=args.seed).train()
    mesh.broadcast_module(model)  # every rank starts from rank 0's weights
    n = sum(p.numel() for p in model.parameters())
    lay = mesh.layout()
    if lay.sharded:  # this rank keeps its shards
        shard_model(model, gpt_param_specs(dict(model.named_parameters())),
                    lay)
    if mesh.is_main():
        print(f"GPT {n/1e6:.1f}M params, seq {cfg.seq_length}, "
              f"dp={lay.dp} fsdp={lay.fsdp} tp={lay.tp}"
              + (" sp" if lay.sequence_parallel else ""), flush=True)
    use_dropout = args.attention_dropout > 0 or args.hidden_dropout > 0
    group = mesh.group()

    def batches(start_step=0):
        if args.data_path:
            # O(1) seek: the sampler position is arithmetic on consumed
            # samples; no skipped batch is read
            from megatron_clip_tpu_torch.data.gpt_dataset import (
                gpt_batch_iterator)
            yield from gpt_batch_iterator(
                args.data_path, args.batch_size,
                args.seq_length, seed=args.seed,
                split=args.split, split_index=0,
                cache_dir=args.data_cache_path,
                start_sample=start_step * args.batch_size,
                dataloader_type=getattr(args, "dataloader_type", None)
                or "single",
                data_sharding=getattr(args, "data_sharding", False))
        else:
            # per-step keyed rng: seekable without replaying the stream
            step = start_step
            while True:
                step += 1
                rng = np.random.RandomState(
                    (args.seed * 2654435761 + step) % (2 ** 31))
                yield rng.randint(0, cfg.vocab_size,
                                  (args.batch_size, cfg.seq_length + 1)
                                  ).astype(np.int32)

    def val_batches():
        # validation never touches the training stream; real data reads
        # the --split valid doc range
        if args.data_path:
            from megatron_clip_tpu_torch.data.gpt_dataset import (
                gpt_batch_iterator)
            return gpt_batch_iterator(args.data_path, args.batch_size,
                                      args.seq_length, seed=args.seed,
                                      split=args.split, split_index=1,
                                      cache_dir=args.data_cache_path)

        def synth():
            rng = np.random.RandomState(args.seed + 7919)
            while True:
                yield rng.randint(0, cfg.vocab_size,
                                  (args.batch_size, cfg.seq_length + 1)
                                  ).astype(np.int32)
        return synth()

    def loss_fn(model, tokens, seed, remat=None):
        tokens = tokens.long()
        remat = model.cfg.remat if remat is None else remat
        kw = dict(fused_ce=args.fused_ce, loss_seq_chunk=args.loss_seq_chunk,
                  seed=seed, remat=remat, group=group)
        if not doc_flags(args):
            return gpt_loss(model, tokens, **kw)
        # megatron get_ltor_masks_and_position_ids over the INPUT tokens:
        # the loss mask, the positions and the attention follow the
        # documents of the packed stream
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        bias, mask, pos = get_ltor_masks_and_position_ids(
            inputs, args.eod_token,
            reset_position_ids=args.reset_position_ids,
            reset_attention_mask=args.reset_attention_mask,
            eod_mask_loss=args.eod_mask_loss)
        return gpt_loss(model, inputs, targets=targets, loss_mask=mask,
                        attn_bias=bias, position_ids=pos, **kw)

    out = run_workload(model, loss_fn, batches, rc, use_rng=use_dropout,
                       val_iter_factory=val_batches,
                       eval_loss_fn=lambda m, b: loss_fn(m, b, None, "none"),
                       args_ns=args)
    return {k: out[k] for k in ("loss", "history", "last_step",
                                "val_history", "val_loss")}


def main(argv=None) -> dict:
    out = run(parse_args(argv))
    print("final:", out, flush=True)
    return out


if __name__ == "__main__":
    main()
