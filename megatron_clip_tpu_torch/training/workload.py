"""The shared training runtime of the GPT entry point: `run_workload`.

Counterpart of `megatron_clip_tpu/training/workload.py` (the runtime of
pretrain_gpt, pretrain_bert, pretrain_t5, pretrain_ict, pretrain_retro and
the pretrain_vision_* entries; megatron/training.py:60-860's pretrain()) on
one device: the runtime's flags (`add_runtime_args`, megatron's spellings
and no-op flags, `runtime_cfg_from_args`, `--use-checkpoint-args`), then
`run_workload(model, loss_fn, batch_iter, rc)`, which trains a model's
`loss_fn(model, batch, seed) -> 0-d loss` for rc.train_steps:

  - the JAX package's optimizer (`training/optim.make_optimizer`: the clip,
    AdamW, SGD or bf16-nu AdamW, decay mask, megatron's lr schedule and
    scheduled weight decay);
  - --micro-batch-size accumulation: the global batch in microbatches of
    that size, one after the other, each gradient divided by their number
    and added into fp32 accumulators (the JAX package's
    `_accum_loss_and_grads`), cast to the parameters' dtype once;
  - --rampup-batch-size: exactly the ramped global batch each step, the
    unused rows of a source batch carried into the next
    (`_BatchDrawer`), so the consumed-samples count places the data;
  - saves (`checkpoints/io.py`: iter_XXXXXXX/ + metadata.json
    {consumed_samples, args} + latest_checkpointed_iteration.txt; the
    interval's in the background), --resume, --load, --finetune,
    --no-load-optim, --no-save-optim and --use-checkpoint-args; the data
    seeks to the consumed samples in O(1) (a factory `batch_iter(start)`);
  - --eval-interval / --eval-iters on the entry's validation stream,
    --skip-train, --exit-duration-in-mins and SIGTERM (save, then stop);
  - the log line (loss, grad norm, --log-params-norm,
    --log-num-zeros-in-grad, samples/s and tokens/s).

It runs where the model is. The JAX runtime's mesh (`build_workload_mesh`)
is reduced to one device: every parallel size above 1, and a torchrun
launch of more than one process, raise NotImplementedError naming ROADMAP
Queue A item 5; --tensorboard-dir and --profile name item 7. What only
other entry points use (the non-gradient `aux_state` of DINO, custom
evals, the pipeline's checkpoint transforms) comes with them.
"""
import argparse
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from megatron_clip_tpu_torch.checkpoints import (
    global_saver, latest_checkpoint_step, load_checkpoint,
    load_checkpoint_metadata, save_checkpoint)
from megatron_clip_tpu_torch.ops.dropout import fold_in
from megatron_clip_tpu_torch.training.optim import (
    OptState, make_optimizer, megatron_lr, megatron_wd)
from megatron_clip_tpu_torch.training.signals import sigterm_latch


@dataclass
class RuntimeCfg:
    """Runtime knobs shared by every entry (megatron's training/checkpoint
    argument groups, arguments.py)."""
    train_steps: int
    batch_size: int
    lr: float = 1e-4
    warmup: int = 10
    # megatron --lr-decay-style/--min-lr/--lr-decay-iters
    # (optimizer_param_scheduler.py)
    lr_decay_style: str = "cosine"
    min_lr: float = 0.0
    lr_decay_iters: Optional[int] = None
    weight_decay: float = 0.01
    # megatron --weight-decay-incr-style/--start/--end-weight-decay
    wd_incr_style: str = "constant"
    start_wd: Optional[float] = None
    end_wd: Optional[float] = None
    grad_clip_norm: float = 1.0
    skip_train: bool = False   # megatron --skip-train: eval only
    log_interval: int = 5
    # parallel layout
    tp: int = 1
    fsdp: int = 1
    pp: int = 1
    vpp: int = 1
    cp: int = 1
    dcn_dp: int = 1   # data parallelism across slices/pods (DCN)
    num_microbatches: int = 1
    # megatron --micro-batch-size at pp == 1: gradient accumulation over
    # batch_size // micro_batch_size microbatches, one after the other in
    # the step (the no-pipelining scheduler's microbatch loop,
    # megatron/core/pipeline_parallel/schedules.py:286), with fp32 grad
    # accumulators (megatron's main_grad). Lets an activation-bound config
    # train when the full-batch activations would not fit.
    micro_batch_size: Optional[int] = None
    tokens_per_sample: int = 0   # >0: log tok/s alongside samples/s
    # megatron --rampup-batch-size START INCREMENT RAMP_SAMPLES
    # (microbatches.py:83-144): the EFFECTIVE batch grows from START to
    # batch_size by INCREMENT every RAMP_SAMPLES/n_increments consumed
    # samples. The runtime draws EXACTLY gbs samples per step (unused rows
    # of a source batch carry to the next step — megatron's
    # consumed-samples law, sample-for-sample); consumed_samples in the
    # checkpoint metadata tracks the ramped count.
    rampup_batch_size: Optional[Tuple[int, int, int]] = None
    # checkpointing (megatron --save/--save-interval/--load/--finetune)
    save: Optional[str] = None
    save_interval: int = 0
    resume: bool = False
    # --load: initialize from a checkpoint under a DIFFERENT root than
    # --save (megatron checkpointing.py --load). Plain --load continues the
    # run (optimizer state + iteration restored); with --finetune only the
    # params load and the iteration resets to 0 (checkpointing.py:525).
    load: Optional[str] = None
    finetune: bool = False
    # eval (megatron --eval-interval/--eval-iters)
    eval_interval: int = 0
    eval_iters: int = 10
    # time-budget exit (megatron --exit-duration-in-mins,
    # training.py:829-851: save a checkpoint, then stop cleanly)
    exit_duration_mins: Optional[float] = None
    seed: int = 0
    name: str = "train"
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # megatron --optimizer {adam,sgd} / --sgd-momentum
    optimizer: str = "adam"
    sgd_momentum: float = 0.9
    # "bf16" = both Adam moments in bf16 (adamw_lowbits), the one-card
    # rung of examples/pretrain_gpt_ladder.sh
    nu_dtype: Optional[str] = None
    # megatron --no-load-optim / --no-save-optim (checkpointing.py):
    # params-only load keeping the iteration; save without optimizer state
    no_load_optim: bool = False
    no_save_optim: bool = False
    tensorboard_dir: Optional[str] = None  # megatron --tensorboard-dir
                                           # (refused: item 7)
    log_params_norm: bool = False          # megatron --log-params-norm
    log_num_zeros_in_grad: bool = False    # megatron --log-num-zeros-in-grad
    # megatron --profile/--profile-step-start/--profile-step-end
    # (refused: ROADMAP Queue A item 7)
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    profile_dir: Optional[str] = None


def add_runtime_args(p, *, lr: float = 1e-4, weight_decay: float = 0.01,
                     batch_size: int = 8, warmup: int = 10):
    """Attach the shared runtime flags to an entry's argparse parser.

    The JAX package's flags, with megatron's spellings registered as
    aliases of the same dest (--global-batch-size, --train-iters,
    --lr-warmup-iters, --clip-grad): a step consumes the global batch,
    in --micro-batch-size microbatches when given."""
    p.add_argument("--batch-size", "--global-batch-size", type=int,
                   default=batch_size,
                   help="samples consumed per step (megatron "
                        "--global-batch-size)")
    p.add_argument("--rampup-batch-size", type=int, nargs=3, default=None,
                   metavar=("START", "INCREMENT", "RAMP_SAMPLES"),
                   help="grow the effective batch from START to "
                        "--batch-size by INCREMENT as samples are consumed "
                        "(megatron --rampup-batch-size, microbatches.py)")
    p.add_argument("--micro-batch-size", type=int, default=None,
                   help="megatron per-rank microbatch: gradient "
                        "accumulation over batch_size // micro "
                        "microbatches (schedules.py:286 no-pipelining "
                        "loop)")
    p.add_argument("--train-steps", "--train-iters", type=int, default=20)
    p.add_argument("--train-samples", type=int, default=None,
                   help="run length in samples instead of steps (megatron "
                        "--train-samples; converted to "
                        "ceil(samples/batch-size) steps)")
    p.add_argument("--lr", type=float, default=lr)
    p.add_argument("--warmup", "--lr-warmup-iters", type=int,
                   default=warmup)
    p.add_argument("--lr-decay-style",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"], default="cosine",
                   help="megatron --lr-decay-style")
    p.add_argument("--min-lr", type=float, default=0.0)
    p.add_argument("--lr-decay-iters", type=int, default=None,
                   help="decay horizon in steps (defaults to --train-steps)")
    p.add_argument("--lr-warmup-fraction", type=float, default=None,
                   help="warmup as a fraction of the decay horizon instead "
                        "of --warmup steps (megatron --lr-warmup-fraction)")
    p.add_argument("--weight-decay", type=float, default=weight_decay)
    p.add_argument("--weight-decay-incr-style",
                   choices=["constant", "linear", "cosine"],
                   default="constant",
                   help="ramp weight decay from --start-weight-decay to "
                        "--end-weight-decay over the run (megatron flag)")
    p.add_argument("--start-weight-decay", type=float, default=None)
    p.add_argument("--end-weight-decay", type=float, default=None)
    p.add_argument("--grad-clip-norm", "--clip-grad", type=float,
                   default=1.0)
    p.add_argument("--skip-train", action="store_true",
                   help="run validation only, no training (megatron "
                        "--skip-train)")
    p.add_argument("--log-interval", type=int, default=5)
    p.add_argument("--tensor-model-parallel-size", type=int, default=1)
    p.add_argument("--fsdp-parallel-size", type=int, default=1)
    p.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    p.add_argument("--virtual-pipeline-parallel-size", type=int, default=1)
    p.add_argument("--dcn-data-parallel-size", type=int, default=1,
                   help="data parallelism across slices (ROADMAP Queue "
                        "A item 5)")
    p.add_argument("--num-microbatches", type=int, default=1)
    p.add_argument("--save", type=str, default=None,
                   help="checkpoint root (iter_XXXXXXX dirs + tracker file)")
    p.add_argument("--save-interval", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint under --save")
    p.add_argument("--load", type=str, default=None,
                   help="initialize from a checkpoint root distinct from "
                        "--save (megatron --load); continues optimizer "
                        "state + iteration unless --finetune")
    p.add_argument("--finetune", action="store_true",
                   help="with --load: restore model params only and reset "
                        "the iteration/optimizer (megatron --finetune)")
    p.add_argument("--eval-interval", type=int, default=0)
    p.add_argument("--eval-iters", type=int, default=10)
    p.add_argument("--no-load-optim", action="store_true",
                   help="restore params + iteration but re-init the "
                        "optimizer (megatron --no-load-optim; also how to "
                        "resume from a --no-save-optim checkpoint)")
    p.add_argument("--no-save-optim", action="store_true",
                   help="save checkpoints without optimizer state "
                        "(megatron --no-save-optim)")
    p.add_argument("--exit-duration-in-mins", type=float, default=None,
                   help="stop (after saving, if --save) once this much "
                        "wall-clock has elapsed (megatron "
                        "--exit-duration-in-mins)")
    p.add_argument("--use-checkpoint-args", action="store_true",
                   help="override model-architecture flags from the "
                        "checkpoint being loaded (megatron "
                        "checkpointing.py:441 load_args_from_checkpoint)")
    p.add_argument("--adam-beta1", type=float, default=None,
                   help="megatron --adam-beta1 (default 0.9)")
    p.add_argument("--adam-beta2", type=float, default=None,
                   help="megatron --adam-beta2 (entries pick their recipe "
                        "default when unset)")
    p.add_argument("--adam-eps", type=float, default=None,
                   help="megatron --adam-eps (default 1e-8)")
    p.add_argument("--optimizer", choices=["adam", "sgd"], default="adam",
                   help="megatron --optimizer")
    p.add_argument("--sgd-momentum", type=float, default=0.9,
                   help="megatron --sgd-momentum")
    p.add_argument("--nu-dtype", choices=["fp32", "bf16"], default="fp32",
                   help="adam second-moment storage; bf16 = both "
                        "moments in bf16 (adamw_lowbits)")
    p.add_argument("--tensorboard-dir", type=str, default=None,
                   help="megatron --tensorboard-dir (ROADMAP Queue A "
                        "item 7)")
    p.add_argument("--log-num-zeros-in-grad", action="store_true",
                   help="count exact zeros in the gradients each logged "
                        "step (megatron --log-num-zeros-in-grad)")
    p.add_argument("--log-params-norm", action="store_true",
                   help="log the global parameter norm each interval "
                        "(megatron --log-params-norm)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="megatron --profile (ROADMAP Queue A item 7)")
    p.add_argument("--profile-step-start", type=int, default=10)
    p.add_argument("--profile-step-end", type=int, default=12)
    p.add_argument("--profile-dir", type=str, default=None,
                   help="megatron --profile's trace directory")
    add_megatron_compat_args(p)
    return p


# megatron flags that change nothing in this runtime, as in the JAX
# package's: kernel-fusion toggles (the port's kernels are always fused),
# fp16 dynamic loss scaling (bf16 needs none), process-group wiring, CUDA
# allocator knobs, and host-side RNG checkpointing (the dropout seeds are
# derived from the step). Accepted so reference launch scripts run
# unmodified; warned when set.
_MEGATRON_NOOP_STORE_TRUE = (
    "--use-flash-attn",                    # always on (the kernels)
    "--no-masked-softmax-fusion", "--no-bias-gelu-fusion",
    "--no-bias-dropout-fusion", "--no-persist-layer-norm",
    "--no-gradient-accumulation-fusion",
    "--no-async-tensor-model-parallel-allreduce",
    "--overlap-grad-reduce", "--overlap-p2p-communication",
    "--use-ring-exchange-p2p", "--no-scatter-gather-tensors-in-pipeline",
    "--use-cpu-initialization", "--data-parallel-random-init",
    "--attention-softmax-in-fp32",         # kernels accumulate fp32 already
    "--accumulate-allreduce-grads-in-fp32",
    "--fp32-residual-connection",
    "--no-load-rng", "--no-save-rng",
    "--no-check-for-nan-in-loss-and-grad", "--distribute-saved-activations",
    "--no-query-key-layer-scaling", "--use-mcore-models",
    "--no-barrier-with-level-1-timing",
)
_MEGATRON_NOOP_VALUE = {
    "--distributed-backend": str, "--distributed-timeout-minutes": int,
    "--loss-scale": float, "--initial-loss-scale": float,
    "--min-loss-scale": float, "--loss-scale-window": int,
    "--hysteresis": int, "--empty-unused-memory-level": int,
    "--num-workers": int, "--timing-log-level": int,
    "--timing-log-option": str, "--max-tokens-to-oom": int,
    "--tensorboard-log-interval": int, "--tensorboard-queue-size": int,
    "--transformer-impl": str, "--recompute-method": str,
    "--recompute-num-layers": int, "--lazy-mpu-init": str,
    # real (pos-table length) on the GPT entry, which defines it first;
    # accepted-for-parity on encoder entries where seq_length bounds it
    "--max-position-embeddings": int,
}


def add_megatron_compat_args(p):
    """Megatron arguments.py flags accepted for CLI compatibility.

    Three kinds: (a) true no-ops (warned), (b) remaps onto native knobs
    (--bf16/--fp16 -> --precision, --checkpoint-activations /
    --recompute-activations -> --recompute-granularity, applied in
    runtime_cfg_from_args), (c) --dataloader-type and the sampler's flags
    (data/samplers.py)."""
    g = p.add_argument_group(
        "megatron compatibility",
        "accepted so reference megatron commands run unmodified; "
        "no-ops warn once")
    # only flags the ENTRY did not already define for real are no-ops:
    # pretrain_gpt's --max-position-embeddings sizes the position table
    registered = []
    for flag in _MEGATRON_NOOP_STORE_TRUE:
        try:
            g.add_argument(flag, action="store_true",
                           help=argparse.SUPPRESS)
            registered.append(flag)
        except argparse.ArgumentError:
            pass  # the entry defines a real version of this flag
    for flag, typ in _MEGATRON_NOOP_VALUE.items():
        try:
            g.add_argument(flag, type=typ, default=None,
                           help=argparse.SUPPRESS)
            registered.append(flag)
        except argparse.ArgumentError:
            pass
    p.set_defaults(_mct_noop_flags=tuple(registered))
    for flag, hlp in (
            ("--bf16", "megatron --bf16: maps to --precision bf16"),
            ("--fp16", "megatron --fp16: bf16 is used instead, as the "
                       "JAX package does (no loss scaling)"),
            ("--checkpoint-activations",
             "deprecated megatron spelling of full recompute"),
            ("--recompute-activations",
             "megatron selective recompute (core attention only)")):
        try:
            g.add_argument(flag, action="store_true", help=hlp)
        except argparse.ArgumentError:
            pass
    for flag, hlp in (
            ("--vocab-file", "tokenizer vocab (megatron --vocab-file): "
                             "when given, the model vocab size derives "
                             "from the tokenizer + padding, like megatron "
                             "build_tokenizer"),
            ("--merge-file", "GPT2 BPE merges.txt (megatron --merge-file)"),
            ("--tokenizer-model", "sentencepiece .model "
                                  "(megatron --tokenizer-model)")):
        try:
            g.add_argument(flag, type=str, default=None, help=hlp)
        except argparse.ArgumentError:
            pass
    try:
        g.add_argument("--tokenizer-type", type=str, default=None,
                       choices=["BertWordPieceLowerCase", "BertWordPieceCase",
                                "GPT2BPETokenizer", "SentencePieceTokenizer",
                                "GPTSentencePieceTokenizer",
                                "Llama2Tokenizer", "NullTokenizer",
                                "CLIPTokenizer"],
                       help="megatron --tokenizer-type (picks the vocab-size "
                            "derivation; data here is already tokenized)")
        g.add_argument("--data-impl", type=str, default=None,
                       help=argparse.SUPPRESS)  # mmap is the only impl
        g.add_argument("--profile-ranks", type=int, nargs="*", default=None,
                       help=argparse.SUPPRESS)
        g.add_argument("--dataloader-type", choices=["single", "cyclic"],
                       default=None,
                       help="megatron --dataloader-type: 'single' = "
                            "sequential with consumed-samples resume "
                            "(MegatronPretrainingSampler, "
                            "data_samplers.py:48); 'cyclic' = per-epoch "
                            "random resampling "
                            "(MegatronPretrainingRandomSampler, :93), both "
                            "O(1)-seekable (data/samplers.py)")
        g.add_argument("--no-data-sharding", action="store_false",
                       dest="data_sharding", default=True,
                       help="megatron --no-data-sharding: cyclic sampler "
                            "draws from one shared permutation (rank-"
                            "strided) instead of per-rank buckets")
        g.add_argument("--sampler-rng", choices=["numpy", "torch"],
                       default=None,
                       help="permutation generator for the cyclic sampler: "
                            "'torch' reproduces the reference's "
                            "torch.Generator(epoch)+randperm stream "
                            "bit-for-bit (use when resuming a megatron "
                            "run or A/B-ing data order); default numpy "
                            "PCG64 (same law, different order)")
    except argparse.ArgumentError:
        pass


def vocab_size_from_tokenizer_args(args, extra_ids: int = 0,
                                   with_real: bool = False):
    """megatron sizes the embedding from the tokenizer files, not a
    --vocab-size flag (tokenizer.py build_tokenizer +
    _vocab_size_with_padding): with --vocab-file / --merge-file the padded
    vocab size derives from the tokenizer as the JAX package derives it.
    None when no tokenizer files were given (the entry's --vocab-size
    applies). with_real=True returns (padded, real). GPT-2's BPE is the
    port's own; SentencePiece and BERT WordPiece files raise
    NotImplementedError (ROADMAP Queue A items 4 and 7)."""
    from megatron_clip_tpu_torch.tokenizer import megatron_tokenizers as mt
    tt = getattr(args, "tokenizer_type", None) or ""
    vf = getattr(args, "vocab_file", None)
    mf = getattr(args, "merge_file", None)
    sp = getattr(args, "tokenizer_model", None)
    if not (vf or sp):
        return (None, None) if with_real else None
    if tt in ("NullTokenizer", "CLIPTokenizer"):
        # fixed-size vocabs; the entry's default already matches
        return (None, None) if with_real else None
    if sp or tt in ("SentencePieceTokenizer", "GPTSentencePieceTokenizer",
                    "Llama2Tokenizer"):
        mt.build_tokenizer("SentencePieceTokenizer", tokenizer_model=sp)
    if not (mf or tt == "GPT2BPETokenizer"):
        # a bare vocab.txt: megatron's default BERT WordPiece
        mt.build_tokenizer("BertWordPieceLowerCase", vocab_file=vf)
    tok = mt.GPT2BPETokenizer(vf, mf)
    d = getattr(args, "make_vocab_size_divisible_by", None) or 128
    tp = getattr(args, "tensor_model_parallel_size", 1) or 1
    real = tok.vocab_size + extra_ids
    padded = mt.vocab_size_with_padding(real, d, tp)
    return (padded, real) if with_real else padded


def normalize_megatron_compat(ns):
    """Apply the (b)-kind remaps and warn once for set no-ops."""
    import warnings
    if getattr(ns, "bf16", False):
        ns.precision = "bf16"
    if getattr(ns, "fp16", False):
        warnings.warn("--fp16 requested: using bf16, as the JAX package "
                      "does (no loss scaling needed)")
        ns.precision = "bf16"
    if hasattr(ns, "recompute_granularity"):
        if getattr(ns, "checkpoint_activations", False) \
                and ns.recompute_granularity == "none":
            ns.recompute_granularity = "full"
        if getattr(ns, "recompute_activations", False) \
                and ns.recompute_granularity == "none":
            ns.recompute_granularity = "selective"
    # warn only for flags registered AS no-ops on this entry's parser
    # (an entry's real flag of the same name is behavior-bearing)
    noop_true = set(getattr(ns, "_mct_noop_flags",
                            tuple(_MEGATRON_NOOP_STORE_TRUE)
                            + tuple(_MEGATRON_NOOP_VALUE)))
    set_noops = [f for f in _MEGATRON_NOOP_STORE_TRUE if f in noop_true
                 and getattr(ns, f[2:].replace("-", "_"), False) is True]
    set_noops += [f for f in _MEGATRON_NOOP_VALUE if f in noop_true
                  and getattr(ns, f[2:].replace("-", "_"), None) is not None]
    if set_noops:
        warnings.warn("megatron flags accepted but no-ops here: "
                      + " ".join(sorted(set_noops)))
    return ns


def runtime_cfg_from_args(args, name: str) -> RuntimeCfg:
    normalize_megatron_compat(args)
    if getattr(args, "sampler_rng", None):
        from megatron_clip_tpu_torch.data.samplers import (
            set_default_perm_impl)
        set_default_perm_impl(args.sampler_rng)
    steps = args.train_steps
    if getattr(args, "train_samples", None):
        steps = -(-args.train_samples // args.batch_size)
    warmup = args.warmup
    if getattr(args, "lr_warmup_fraction", None) is not None:
        horizon = getattr(args, "lr_decay_iters", None) or steps
        warmup = int(args.lr_warmup_fraction * horizon)
    return RuntimeCfg(
        train_steps=steps, batch_size=args.batch_size,
        lr=args.lr, warmup=warmup,
        lr_decay_style=getattr(args, "lr_decay_style", "cosine"),
        min_lr=getattr(args, "min_lr", 0.0),
        lr_decay_iters=getattr(args, "lr_decay_iters", None),
        weight_decay=args.weight_decay,
        wd_incr_style=getattr(args, "weight_decay_incr_style", "constant"),
        start_wd=getattr(args, "start_weight_decay", None),
        end_wd=getattr(args, "end_weight_decay", None),
        skip_train=getattr(args, "skip_train", False),
        grad_clip_norm=args.grad_clip_norm, log_interval=args.log_interval,
        tp=args.tensor_model_parallel_size, fsdp=args.fsdp_parallel_size,
        pp=args.pipeline_model_parallel_size,
        vpp=args.virtual_pipeline_parallel_size,
        cp=getattr(args, "context_parallel_size", 1),
        dcn_dp=getattr(args, "dcn_data_parallel_size", 1),
        # megatron --micro-batch-size: with pipelining (item 5) the
        # microbatch count is global/micro; without it, the accumulation
        num_microbatches=max(
            args.num_microbatches,
            (args.batch_size // args.micro_batch_size)
            if getattr(args, "micro_batch_size", None)
            and args.pipeline_model_parallel_size > 1 else 1),
        micro_batch_size=(getattr(args, "micro_batch_size", None)
                          if args.pipeline_model_parallel_size == 1
                          else None),
        save=args.save, save_interval=args.save_interval,
        resume=args.resume, load=getattr(args, "load", None),
        finetune=getattr(args, "finetune", False),
        eval_interval=args.eval_interval,
        eval_iters=args.eval_iters,
        exit_duration_mins=getattr(args, "exit_duration_in_mins", None),
        # explicit None checks: 0.0 is a legitimate beta1 (RMSProp-style)
        beta1=(lambda v: 0.9 if v is None else v)(
            getattr(args, "adam_beta1", None)),
        beta2=(lambda v: 0.999 if v is None else v)(
            getattr(args, "adam_beta2", None)),
        eps=(lambda v: 1e-8 if v is None else v)(
            getattr(args, "adam_eps", None)),
        optimizer=getattr(args, "optimizer", "adam"),
        sgd_momentum=getattr(args, "sgd_momentum", 0.9),
        no_load_optim=getattr(args, "no_load_optim", False),
        no_save_optim=getattr(args, "no_save_optim", False),
        tensorboard_dir=getattr(args, "tensorboard_dir", None),
        log_params_norm=getattr(args, "log_params_norm", False),
        log_num_zeros_in_grad=getattr(args, "log_num_zeros_in_grad", False),
        profile=getattr(args, "profile", False),
        profile_step_start=getattr(args, "profile_step_start", 10),
        profile_step_end=getattr(args, "profile_step_end", 12),
        profile_dir=getattr(args, "profile_dir", None),
        rampup_batch_size=(tuple(args.rampup_batch_size)
                           if getattr(args, "rampup_batch_size", None)
                           else None),
        seed=args.seed, name=name,
        nu_dtype=None if getattr(args, "nu_dtype", "fp32") == "fp32"
        else args.nu_dtype)


# flags that describe the RUN, not the model: --use-checkpoint-args must
# not clobber these (megatron's load_args_from_checkpoint likewise only
# restores architecture/tokenizer args, checkpointing.py:441-524); the
# JAX package's set, and the port's --device
_RUN_ARG_KEYS = frozenset({
    "batch_size", "train_steps", "train_samples", "lr", "warmup",
    "lr_decay_style",
    "min_lr", "lr_decay_iters", "weight_decay",
    "grad_clip_norm", "log_interval", "tensor_model_parallel_size",
    "fsdp_parallel_size", "pipeline_model_parallel_size",
    "virtual_pipeline_parallel_size", "num_microbatches",
    "context_parallel_size", "save", "save_interval", "resume", "load",
    "finetune", "eval_interval", "eval_iters", "exit_duration_in_mins",
    "use_checkpoint_args", "seed", "nu_dtype", "data_path", "split",
    "recompute_granularity", "adam_beta1", "adam_beta2", "adam_eps",
    "optimizer", "sgd_momentum", "no_load_optim", "no_save_optim",
    "lr_warmup_fraction", "weight_decay_incr_style", "start_weight_decay",
    "end_weight_decay", "skip_train", "tensorboard_dir", "log_params_norm",
    "log_num_zeros_in_grad", "micro_batch_size",
    # execution-strategy / environment knobs, never architecture
    "profile", "profile_step_start", "profile_step_end", "profile_dir",
    "dataloader_type", "rampup_batch_size", "sampler_rng", "data_sharding",
    "precision", "params_dtype", "quantize_matmuls", "sequence_parallel",
    "context_parallel_layout", "fused_ce", "loss_seq_chunk",
    "attention_dropout", "hidden_dropout", "eod_token", "eod_mask_loss",
    "reset_position_ids", "reset_attention_mask", "device",
})


def _is_run_key(k: str) -> bool:
    # any path/dir/file-valued flag describes the environment, not the model
    return k in _RUN_ARG_KEYS or k.endswith(("_path", "_dir", "_file"))


def maybe_apply_checkpoint_args(args):
    """megatron --use-checkpoint-args (checkpointing.py:441-524): override
    the namespace's model-architecture flags from the metadata of the
    checkpoint about to be loaded (--load, or --save when --resume).
    Call before building the model config."""
    if not getattr(args, "use_checkpoint_args", False):
        return args
    from megatron_clip_tpu_torch.checkpoints import (
        latest_checkpoint_step, load_checkpoint_metadata)
    root = getattr(args, "load", None) or \
        (args.save if getattr(args, "resume", False) else None)
    if not root or latest_checkpoint_step(root) is None:
        raise SystemExit("--use-checkpoint-args needs a checkpoint to read "
                         "args from (--load PATH, or --resume with --save)")
    stored = load_checkpoint_metadata(root).get("args")
    if stored is None:
        raise SystemExit(f"checkpoint under {root} was saved without an "
                         "args record; cannot --use-checkpoint-args")
    applied = {}
    for k, v in stored.items():
        if _is_run_key(k) or not hasattr(args, k):
            continue
        if getattr(args, k) != v:
            applied[k] = (getattr(args, k), v)
            setattr(args, k, v)
    if applied:
        print("[use-checkpoint-args] overriding from checkpoint: " +
              ", ".join(f"{k}: {old!r} -> {new!r}"
                        for k, (old, new) in applied.items()), flush=True)
    return args


def _json_safe_args(args) -> dict:
    out = {}
    for k, v in vars(args).items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
    return out



# (Queue A item, what, whether the runtime config asks for it)
_REFUSED = (
    (5, "--tensor-model-parallel-size > 1", lambda rc: rc.tp > 1),
    (5, "--fsdp-parallel-size > 1", lambda rc: rc.fsdp > 1),
    (5, "--pipeline-model-parallel-size > 1", lambda rc: rc.pp > 1),
    (5, "--virtual-pipeline-parallel-size > 1", lambda rc: rc.vpp > 1),
    (5, "--context-parallel-size > 1", lambda rc: rc.cp > 1),
    (5, "--dcn-data-parallel-size > 1", lambda rc: rc.dcn_dp > 1),
    (5, "data parallelism over a torchrun launch of more than one process",
     lambda rc: int(os.environ.get("WORLD_SIZE", "1")) > 1),
    (7, "--tensorboard-dir", lambda rc: bool(rc.tensorboard_dir)),
    (7, "--profile", lambda rc: rc.profile),
)


def build_workload_mesh(rc: RuntimeCfg) -> None:
    """The JAX runtime's mesh, on one device: there is none. Every parallel
    size above 1, a torchrun launch of more than one process,
    --tensorboard-dir and --profile raise NotImplementedError naming their
    ROADMAP Queue A item."""
    for item, what, asked in _REFUSED:
        if asked(rc):
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                      f"Queue A item {item})")
    return None


def _tree_map(fn, tree, *rest):
    """`fn` over the arrays of a batch: an array, or dicts, lists and
    tuples of them (the batch pytrees the entries yield)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class _BatchDrawer:
    """Draw exactly-n-row batches from a fixed-size batch iterator, carrying
    the unused tail of each source batch over to the next draw.

    megatron's rampup sampler draws exactly gbs samples per step
    (microbatches.py:83-144 + data_samplers.py), so the consumed-samples ->
    dataset-position mapping is sample-exact. Leaves whose leading dim is
    not the source batch size (scalars, step metadata) pass through, the
    latest value winning, as in the JAX package's drawer."""

    def __init__(self, it: Iterator, src_bs: int):
        self.it, self.src_bs = it, src_bs
        self.buf = None
        self.buf_rows = 0
        self.mask = None  # per leaf: whether it has the batch's rows

    def _pull(self):
        b = next(self.it)
        if self.mask is None:
            self.mask = _tree_map(lambda x: getattr(x, "ndim", 0) > 0
                                  and x.shape[0] == self.src_bs, b)
        return b

    def draw(self, n: int):
        parts, have = [], 0
        if self.buf_rows:
            parts.append(self.buf)
            have = self.buf_rows
        while have < n:
            parts.append(self._pull())
            have += self.src_bs
        if len(parts) == 1:
            cat = parts[0]
        else:
            cat = _tree_map(
                lambda m, *xs: np.concatenate([np.asarray(x) for x in xs])
                if m else xs[-1], self.mask, *parts)
        out = _tree_map(lambda m, x: x[:n] if m else x, self.mask, cat)
        self.buf = (_tree_map(lambda m, x: x[n:] if m else x, self.mask,
                              cat) if have > n else None)
        self.buf_rows = have - n
        return out

    def skip_rows(self, n: int) -> None:
        """Discard n rows (resume mid-source-batch)."""
        if n:
            self.draw(n)


class _Runner:
    """The model (its parameters updated in place), the optimizer and its
    state: one step (`step`), the eval loss (`evaluate`), the checkpoint
    tree and its loads."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, rc: RuntimeCfg, use_rng: bool,
                 eval_loss_fn: Optional[Callable]):
        self.model, self.loss_fn, self.optimizer, self.rc = (
            model, loss_fn, optimizer, rc)
        self.params = dict(model.named_parameters())
        self.opt_state = optimizer.init()
        self.use_rng = use_rng
        self.eval_loss_fn = eval_loss_fn or (
            lambda m, b: loss_fn(m, b, None))
        self.device = next(iter(self.params.values())).device

    def _to_device(self, batch):
        return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(
            self.device, non_blocking=True), batch)

    def _grads(self, batch, seed) -> Tuple[torch.Tensor, dict]:
        for p in self.params.values():
            p.grad = None
        loss = self.loss_fn(self.model, batch, seed)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        return loss.detach(), grads

    def _accumulated(self, batch, seed, micro: int):
        """The JAX package's `_accum_loss_and_grads`: n = rows // micro
        microbatches in order, each loss and gradient divided by n and added
        into fp32 accumulators, the gradients cast to the parameters'
        dtypes once; microbatch i's dropout seed is fold_in(seed, i)."""
        leads = set()
        _tree_map(lambda x: leads.add(x.shape[0]) if x.dim() else None,
                  batch)
        if len(leads) != 1:
            raise ValueError(
                "--micro-batch-size accumulation requires every batch leaf "
                f"to share one leading (batch) dim; got {sorted(leads)}")
        (gbs,) = leads
        if gbs % micro:
            raise ValueError(f"global batch {gbs} not divisible by "
                             f"--micro-batch-size {micro}")
        n = gbs // micro
        if n <= 1:
            return self._grads(batch, seed)
        names = list(self.params)
        acc = [torch.zeros_like(p, dtype=torch.float32)
               for p in self.params.values()]
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n):
            mb = _tree_map(lambda x: x[i * micro:(i + 1) * micro]
                           if x.dim() else x, batch)
            loss, g = self._grads(mb, None if seed is None
                                  else fold_in(seed, i))
            acc_loss = acc_loss + loss.float() / n
            g32 = torch._foreach_div([g[k].float() for k in names], n)
            torch._foreach_add_(acc, g32)
        grads = {k: a.to(self.params[k].dtype) for k, a in zip(names, acc)}
        return acc_loss, grads

    def step(self, batch, i: int) -> dict:
        """Step i (from 1) on `batch` (host arrays): the loss and gradients,
        the metrics, the optimizer's update in place."""
        rc = self.rc
        batch = self._to_device(batch)
        seed = fold_in(rc.seed + 1, i) if self.use_rng else None
        if rc.micro_batch_size:
            loss, grads = self._accumulated(batch, seed, rc.micro_batch_size)
        else:
            loss, grads = self._grads(batch, seed)
        metrics = {"loss": loss}
        if rc.log_params_norm:
            metrics["params_norm"] = self.optimizer.global_norm(
                {n: p.detach() for n, p in self.params.items()})
        if rc.log_num_zeros_in_grad:
            metrics["num_zeros"] = sum((g == 0).sum().float()
                                       for g in grads.values())
        self.opt_state, metrics["grad_norm"] = self.optimizer.update(
            self.opt_state, grads)
        return metrics

    @torch.no_grad()
    def evaluate(self, val_iter, iters: int) -> float:
        """The mean of `iters` eval losses on `val_iter`'s batches."""
        vals = [float(self.eval_loss_fn(self.model,
                                        self._to_device(next(val_iter))))
                for _ in range(iters)]
        return float(np.mean(vals))

    def state_tree(self, with_optim: bool = True) -> dict:
        tree = {"params": dict(self.model.state_dict())}
        if with_optim:
            opt = self.opt_state
            tree["opt_state"] = {"count": opt.count, "mu": opt.mu,
                                 "nu": opt.nu,
                                 "schedule_count": opt.schedule_count}
        return tree

    def load(self, root: str, with_optim: bool = True) -> Tuple[dict, int]:
        """The newest checkpoint under `root` into the model, and with
        `with_optim` into the optimizer state (else a fresh one); returns
        (metadata, step)."""
        tree, meta, step = load_checkpoint(root)
        params = tree["params"]
        own = self.model.state_dict()
        if params.keys() != own.keys() or any(
                params[k].shape != own[k].shape for k in own):
            raise ValueError(f"params loaded from {root} do not match this "
                             "model's parameter tree")
        self.model.load_state_dict(params)
        self.opt_state = self.optimizer.init()
        if with_optim:
            if "opt_state" not in tree:
                raise ValueError(f"the checkpoint under {root} holds no "
                                 "optimizer state (saved with "
                                 "--no-save-optim): load it with "
                                 "--no-load-optim")
            like, opt = self.opt_state, tree["opt_state"]
            self.opt_state = OptState(
                count=opt["count"],
                mu={n: t.to(like.mu[n]) for n, t in opt["mu"].items()},
                nu={n: t.to(like.nu[n]) for n, t in opt["nu"].items()},
                schedule_count=opt["schedule_count"])
        return meta, step


def run_workload(model: torch.nn.Module, loss_fn: Callable, batch_iter,
                 rc: RuntimeCfg, *, use_rng: bool = False,
                 val_iter_factory: Optional[Callable] = None,
                 eval_loss_fn: Optional[Callable] = None,
                 args_ns=None) -> dict:
    """Train `loss_fn(model, batch, seed) -> 0-d loss` for rc.train_steps.

    batch: a host array (or dict / list / tuple of them), leading axis the
    batch, moved to the model's device each step. `seed` is None without
    `use_rng`, else step i's dropout seed fold_in(rc.seed + 1, i).
    `batch_iter` may be an iterator or a factory `fn(start) -> iterator`
    that seeks to source batch `start` (the consumed-samples fast-forward,
    megatron data_samplers.py:14-48); a plain iterator is replayed and
    discarded. `val_iter_factory()` gives a fresh validation stream for
    each eval, scored by `eval_loss_fn(model, batch)` (default the loss
    without dropout) under no_grad. `args_ns` is recorded in each
    checkpoint's metadata for --use-checkpoint-args.

    Returns {"loss", "history" [(step, loss) at the log interval], "last_step",
    "val_history" [(step, val loss)], "val_loss" (the last eval's or
    --skip-train's), "model"}."""
    build_workload_mesh(rc)
    # the JAX run_workload's optimizer: megatron's lr schedule, the
    # scheduled or constant (decay-masked) weight decay, the clip, and
    # AdamW, SGD or the bf16-nu AdamW
    wd = rc.weight_decay
    if rc.wd_incr_style != "constant":
        start = rc.start_wd if rc.start_wd is not None else rc.weight_decay
        end = rc.end_wd if rc.end_wd is not None else rc.weight_decay
        wd = megatron_wd(start, end, rc.train_steps,
                         incr_style=rc.wd_incr_style)
    optimizer = make_optimizer(
        model, megatron_lr(rc.lr, rc.warmup, rc.train_steps,
                           decay_style=rc.lr_decay_style, min_lr=rc.min_lr,
                           decay_steps=rc.lr_decay_iters),
        beta1=rc.beta1, beta2=rc.beta2, eps=rc.eps, weight_decay=wd,
        grad_clip_norm=rc.grad_clip_norm, optimizer=rc.optimizer,
        sgd_momentum=rc.sgd_momentum,
        nu_dtype=torch.bfloat16 if rc.nu_dtype == "bf16" else None)
    runner = _Runner(model, loss_fn, optimizer, rc, use_rng, eval_loss_fn)
    eval_ok = val_iter_factory is not None
    if rc.eval_interval and not eval_ok:
        print(f"[{rc.name}] WARNING: --eval-interval set but this entry "
              "provides no validation data source; skipping eval",
              flush=True)

    consumed = 0

    def _meta():
        m = {"consumed_samples": consumed}
        if args_ns is not None:
            # the args record behind --use-checkpoint-args (megatron saves
            # the full args namespace, checkpointing.py:215)
            m["args"] = _json_safe_args(args_ns)
        return m

    def _save(i: int, block: bool = True):
        save_checkpoint(rc.save, i, runner.state_tree(not rc.no_save_optim),
                        _meta(), block=block)

    start_step = 0
    if rc.resume and rc.save and latest_checkpoint_step(rc.save) is not None:
        meta, start_step = runner.load(rc.save, not rc.no_load_optim)
        if rc.no_load_optim:
            print(f"[{rc.name}] resumed params-only from {rc.save} @ step "
                  f"{start_step} (--no-load-optim: fresh optimizer)",
                  flush=True)
        else:
            print(f"[{rc.name}] resumed from {rc.save} @ step {start_step} "
                  f"(consumed_samples={meta.get('consumed_samples', 0)})",
                  flush=True)
    elif rc.load:
        if rc.finetune:
            _, from_step = runner.load(rc.load, with_optim=False)
            print(f"[{rc.name}] finetune init: params from {rc.load} "
                  f"@ step {from_step} (optimizer/iteration reset)",
                  flush=True)
        elif rc.no_load_optim:
            _, start_step = runner.load(rc.load, with_optim=False)
            print(f"[{rc.name}] loaded params-only {rc.load} @ step "
                  f"{start_step} (--no-load-optim: fresh optimizer)",
                  flush=True)
        else:
            _, start_step = runner.load(rc.load)
            print(f"[{rc.name}] loaded {rc.load} @ step {start_step} "
                  f"(continuing; saving to {rc.save})", flush=True)

    if rc.skip_train:
        # megatron --skip-train (training.py): validation only
        if not eval_ok:
            raise SystemExit("--skip-train needs a validation source "
                             "(this entry provides none)")
        v = runner.evaluate(val_iter_factory(), rc.eval_iters)
        print(f"[{rc.name}] --skip-train: val loss {v:.4f} over "
              f"{rc.eval_iters} batches", flush=True)
        return {"loss": v, "history": [], "val_loss": v,
                "val_history": [], "last_step": start_step, "model": model}

    # --rampup-batch-size (megatron microbatches.py:83-144), built before
    # the data is placed: a ramped run's position is consumed SAMPLES
    rampup = None
    consumed = start_step * rc.batch_size
    if rc.micro_batch_size and rc.batch_size % rc.micro_batch_size:
        raise SystemExit(f"--batch-size {rc.batch_size} must be divisible "
                         f"by --micro-batch-size {rc.micro_batch_size}")
    if rc.rampup_batch_size is not None:
        from megatron_clip_tpu_torch.training.microbatches import (
            build_num_microbatches_calculator)
        # every ramped size must split into whole microbatches
        gran = math.lcm(1, rc.micro_batch_size or 1)
        try:
            rampup = build_num_microbatches_calculator(
                rc.batch_size, 1, gran, rc.rampup_batch_size)
        except (ValueError, ZeroDivisionError) as e:
            raise SystemExit(
                f"--rampup-batch-size {rc.rampup_batch_size}: {e} (the "
                f"microbatch split requires multiples of {gran})") from e
        if start_step and (rc.save or rc.load):
            # a resumed rampup run restores the RAMPED consumed count
            try:
                consumed = int(load_checkpoint_metadata(
                    rc.save if rc.resume else rc.load).get(
                        "consumed_samples", consumed))
            except (FileNotFoundError, KeyError, ValueError):
                pass
        start, inc, _ = rc.rampup_batch_size
        print(f"[{rc.name}] batch rampup {start} -> {rc.batch_size} "
              f"(+{inc})", flush=True)

    # place the data: start_step source batches without rampup; with it,
    # `consumed` samples (whole source batches, then the rows of the next)
    drawer = None
    if rampup is None:
        if callable(batch_iter):
            batch_iter = batch_iter(start_step)
        else:
            for _ in range(start_step):
                next(batch_iter)
    else:
        src_batches, skip_rows = divmod(consumed, rc.batch_size)
        if callable(batch_iter):
            batch_iter = batch_iter(src_batches)
        else:
            for _ in range(src_batches):
                next(batch_iter)
        drawer = _BatchDrawer(batch_iter, rc.batch_size)
        drawer.skip_rows(skip_rows)

    t0 = time.perf_counter()
    run_t0 = t0
    loss = None
    history, val_history = [], []
    win_samples = 0
    last_step, exited_early = start_step, False
    with sigterm_latch() as term:
        for i in range(start_step + 1, rc.train_steps + 1):
            gbs = rc.batch_size
            if rampup is not None:
                rampup.update(consumed)
                gbs = rampup.current_global_batch_size()
                batch = drawer.draw(gbs)  # exactly gbs samples, tail kept
            else:
                batch = next(batch_iter)
            metrics = runner.step(batch, i)
            loss = metrics["loss"]
            last_step = i
            consumed += gbs
            win_samples += gbs
            if i % rc.log_interval == 0 or i == rc.train_steps:
                l = float(loss)  # waits for the device
                history.append((i, l))
                dt = time.perf_counter() - t0
                ips = win_samples / dt
                win_samples = 0
                extra = (f" | {ips * rc.tokens_per_sample:.0f} tok/s"
                         if rc.tokens_per_sample else "")
                gn = float(metrics["grad_norm"])
                pn = (f" | params norm {float(metrics['params_norm']):.2f}"
                      if "params_norm" in metrics else "")
                if "num_zeros" in metrics:
                    pn += f" | num zeros {int(metrics['num_zeros'])}"
                print(f"[{rc.name}] step {i}/{rc.train_steps} | "
                      f"loss {l:.4f} | grad norm {gn:.3f}{pn} | "
                      f"{ips:.1f} samples/s{extra}", flush=True)
                t0 = time.perf_counter()
            if rc.save and rc.save_interval and i % rc.save_interval == 0:
                # in the background: the host copy is taken here, the write
                # commits while training goes on
                _save(i, block=False)
            if rc.eval_interval and eval_ok and i % rc.eval_interval == 0:
                v = runner.evaluate(val_iter_factory(), rc.eval_iters)
                val_history.append((i, v))
                print(f"[{rc.name}] eval @ {i}: val loss {v:.4f}",
                      flush=True)
            if term["flag"]:
                if rc.save and (not rc.save_interval
                                or i % rc.save_interval != 0):
                    _save(i)
                if rc.save:
                    print(f"[{rc.name}] SIGTERM: saved checkpoint @ step "
                          f"{i}, exiting", flush=True)
                else:
                    print(f"[{rc.name}] SIGTERM: exiting @ step {i} "
                          "(no --save configured)", flush=True)
                exited_early = True
                break
            if rc.exit_duration_mins is not None and \
                    time.perf_counter() - run_t0 > rc.exit_duration_mins * 60:
                # megatron --exit-duration-in-mins (training.py:829-851)
                if rc.save and (not rc.save_interval
                                or i % rc.save_interval != 0):
                    _save(i)
                print(f"[{rc.name}] exiting at step {i}: "
                      f"--exit-duration-in-mins {rc.exit_duration_mins} "
                      "budget reached", flush=True)
                exited_early = True
                break
        if rc.save and not exited_early \
                and (not rc.save_interval
                     or last_step % rc.save_interval != 0) \
                and last_step > start_step:
            _save(last_step)
    global_saver().wait()  # the contract: checkpoints durable on return
    return {"loss": float(loss) if loss is not None else None,
            "history": history, "last_step": last_step,
            "val_history": val_history,
            "val_loss": val_history[-1][1] if val_history else None,
            "model": model}
