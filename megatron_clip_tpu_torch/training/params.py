"""Training CLI flags of the port's CLIP trainer.

The parser of `megatron_clip_tpu/training/params.py`, every flag, default
and alias, with its post-parse fix-ups (`--grad-checkpointing` -> full
recompute, `--fp16` / `--bf16` -> `--precision bf16`, `--dataset-type auto`
from the train data's name). It merges open_CLIP's training flags
(open_CLIP/src/training/params.py) with megatron's parallelism flags
(megatron/arguments.py), the branch-parallel family and the `--v-*`
vision-tower overrides.

The port adds one flag, `--device` (default `cuda`): the trainer runs on
the card unless the caller asks for the CPU. Flags of modules the port does
not carry yet stay in the parser, so that the same command line parses on
both sides; `training/loop.py::run_training` refuses each of them, naming
its ROADMAP Queue A item, before it builds anything.
"""
import argparse


def parse_args(args=None):
    p = argparse.ArgumentParser("megatron_clip_tpu_torch pretraining")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the trainer runs on: cuda (the card, the default) or cpu")

    # --- data ---------------------------------------------------------------
    p.add_argument("--train-data", type=str, default=None,
                   help="path: webdataset shard spec (brace-expandable), csv "
                        "file, or empty for synthetic")
    p.add_argument("--val-data", type=str, default=None)
    p.add_argument("--dataset-type", choices=["webdataset", "csv", "synthetic",
                                              "auto"], default="auto")
    p.add_argument("--train-num-samples", type=int, default=None)
    p.add_argument("--val-num-samples", type=int, default=None)
    p.add_argument("--csv-separator", type=str, default="\t")
    p.add_argument("--csv-img-key", type=str, default="filepath")
    p.add_argument("--csv-caption-key", type=str, default="title")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--dataset-resampled", action="store_true",
                   help="sample wds shards with replacement (ResampledShards2)")
    p.add_argument("--train-data-upsampling-factors", type=str, default=None,
                   help="'::'-separated per-source weights for a multi-source "
                        "--train-data (open_CLIP flag; needs "
                        "--dataset-resampled)")

    # --- model --------------------------------------------------------------
    p.add_argument("--model", type=str, default="ViT-B-32")
    p.add_argument("--pretrained", type=str, default="")
    p.add_argument("--pretrained-image", type=str, default="",
                   help="initialize ONLY the vision tower from this "
                        "pretrained tag/path (open_CLIP --pretrained-image "
                        "/ LiT-style init); text tower stays at init")
    p.add_argument("--precision", choices=["amp", "amp_bf16", "bf16", "fp16",
                                           "fp32", "pure_bf16"], default="bf16")
    # megatron pretrain_CLIP.py spellings (zPretrain/pretrain_clip.sh passes
    # --fp16 as a flag): map onto --precision bf16, as the JAX package does
    p.add_argument("--fp16", action="store_true",
                   help="megatron --fp16: bf16 is used, as in the JAX "
                        "package (no loss scaling)")
    p.add_argument("--bf16", action="store_true",
                   help="megatron --bf16: maps to --precision bf16")
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--force-patch-dropout", type=float, default=None,
                   help="override the model config's vision patch_dropout "
                        "rate at train time (open_CLIP --force-patch-dropout)")
    p.add_argument("--force-custom-text", action="store_true",
                   help="accepted for open_CLIP CLI parity; text towers "
                        "here are always the unified functional "
                        "implementation (CustomTextCLIP semantics)")
    p.add_argument("--force-image-size", type=int, nargs="+", default=None,
                   help="override the vision tower's input resolution "
                        "(open_CLIP --force-image-size); a pretrained "
                        "checkpoint's position table is bicubic-resized to "
                        "the new grid at load (model.py:417 resize_pos_embed)")
    p.add_argument("--image-mean", type=float, nargs="+", default=None,
                   help="normalization mean override (open_CLIP --image-mean)")
    p.add_argument("--image-std", type=float, nargs="+", default=None,
                   help="normalization std override (open_CLIP --image-std)")
    p.add_argument("--aug-cfg", nargs="*", default=None,
                   help="train augmentation overrides as key=value pairs, "
                        "e.g. scale='(0.8,1.0)' color_jitter=0.4 "
                        "gray_scale_prob=0.2 (open_CLIP --aug-cfg)")
    p.add_argument("--grad-checkpointing", action="store_true",
                   help="full activation recompute (megatron "
                        "--recompute-granularity full)")
    p.add_argument("--recompute-granularity",
                   choices=["none", "selective", "mlp", "full"], default="none")
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0,
                   help="weight of the CoCa captioning loss term "
                        "(open_CLIP --coca-caption-loss-weight)")
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0,
                   help="weight of the CoCa contrastive loss term "
                        "(open_CLIP --coca-contrastive-loss-weight)")
    p.add_argument("--siglip", action="store_true",
                   help="use SigLIP sigmoid pairwise loss")
    # LiT-style tower locking (open_CLIP --lock-image/--lock-text,
    # main.py:259-267)
    p.add_argument("--lock-image", action="store_true",
                   help="freeze the vision tower (LiT)")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0,
                   help="leave the last N vision groups trainable")
    p.add_argument("--lock-image-freeze-bn-stats", action="store_true",
                   help="accepted for CLI parity; frozen towers never update "
                        "batch stats here (functional BN is stateless)")
    p.add_argument("--lock-text", action="store_true",
                   help="freeze the text tower")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-text-freeze-layer-norm", action="store_true")
    # distillation (open_CLIP --distill-model/--distill-pretrained)
    p.add_argument("--distill-model", type=str, default=None,
                   help="teacher model config name for DistillClipLoss")
    p.add_argument("--distill-pretrained", type=str, default=None,
                   help="teacher checkpoint (zoo tag or path)")
    # open_CLIP defaults these to False; the JAX package defaults them to
    # True. On one process neither changes the loss.
    # (per-shard logits + grad-flowing all-gather). --no-* turns them off.
    p.add_argument("--local-loss", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--gather-with-grad", action=argparse.BooleanOptionalAction,
                   default=True)

    # --- optimization (open_CLIP defaults) -----------------------------------
    p.add_argument("--batch-size", type=int, default=64,
                   help="GLOBAL batch size")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=5.0e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--eps", type=float, default=1.0e-6)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--lr-scheduler", choices=["cosine", "const",
                                              "const-cooldown"], default="cosine")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--epochs-cooldown", type=int, default=None)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="gradient accumulation steps (microbatches)")
    p.add_argument("--seed", type=int, default=0)

    # --- parallelism (megatron names) ----------------------------------------
    p.add_argument("--tensor-model-parallel-size", type=int, default=1)
    p.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    p.add_argument("--virtual-pipeline-parallel-size", type=int, default=1,
                   help="layer chunks per stage (interleaved schedule; "
                        "megatron --num-layers-per-virtual-pipeline-stage)")
    p.add_argument("--fsdp-parallel-size", type=int, default=1,
                   help="param/optimizer shard axis (ZeRO / distributed "
                        "optimizer analogue, --use-distributed-optimizer)")
    p.add_argument("--num-microbatches", type=int, default=1)
    p.add_argument("--dcn-data-parallel-size", type=int, default=1,
                   help="data parallelism across slices/pods over DCN "
                        "(outer-major blocks of the data axis; only grad "
                        "all-reduce crosses the data-center network)")
    p.add_argument("--sequence-parallel", action="store_true")
    p.add_argument("--extra-world-size", type=int, default=0,
                   help="devices for the text branch; >0 enables "
                        "branch-parallel two-mesh training")
    p.add_argument("--xtensor-model-parallel-size", type=int, default=1)
    p.add_argument("--xpipeline-model-parallel-size", type=int, default=1)

    # --- vision tower overrides (megatron --v-* family) ----------------------
    p.add_argument("--v-num-layers", type=int, default=None)
    p.add_argument("--v-hidden-size", type=int, default=None)
    p.add_argument("--v-patch-size", type=int, default=None)
    p.add_argument("--v-image-size", type=int, default=None)

    # --- checkpointing / logging ---------------------------------------------
    p.add_argument("--save", "--logs", dest="save", type=str, default=None,
                   help="checkpoint/log root directory")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--save-frequency", type=int, default=1,
                   help="save every N epochs")
    p.add_argument("--save-interval", type=int, default=None,
                   help="save every N steps (megatron --save-interval)")
    p.add_argument("--save-most-recent", action="store_true",
                   help="also save at EVERY epoch boundary regardless of "
                        "--save-frequency (open_CLIP epoch_latest.pt "
                        "semantics; the tracker file always points at the "
                        "newest checkpoint)")
    p.add_argument("--delete-previous-checkpoint", action="store_true",
                   help="after each save, remove older iter_* directories "
                        "(open_CLIP --delete-previous-checkpoint)")
    p.add_argument("--resume", type=str, default=None,
                   help="'latest' or a checkpoint dir")
    p.add_argument("--log-interval", "--log-every-n-steps", type=int,
                   default=10,
                   help="console/TB metrics every N steps (megatron "
                        "--log-interval / open_CLIP --log-every-n-steps)")
    p.add_argument("--skip-scheduler", action="store_true",
                   help="raw constant lr, no warmup/decay (open_CLIP)")
    p.add_argument("--wandb-notes", type=str, default=None)
    p.add_argument("--copy-codebase", action="store_true",
                   help="snapshot the code tree into <save>/<name>/code "
                        "(open_CLIP main.py copy_codebase)")
    p.add_argument("--report-to", type=str, default="",
                   help="comma list: tensorboard,wandb (wandb is a no-op "
                        "with a warning if the package is absent)")
    p.add_argument("--wandb-project-name", type=str, default="megatron-clip-tpu")
    p.add_argument("--remote-sync", type=str, default=None,
                   help="rsync/copy the checkpoint dir to this target in a "
                        "background thread (open_CLIP --remote-sync)")
    p.add_argument("--remote-sync-frequency", type=int, default=300,
                   help="seconds between background syncs")
    p.add_argument("--exit-interval", type=int, default=None,
                   help="stop after N steps total (megatron --exit-interval)")
    p.add_argument("--exit-duration-in-mins", type=float, default=None,
                   help="save (if --save set) and stop after this much "
                        "wall-clock (megatron --exit-duration-in-mins, "
                        "training.py:829-851)")

    # --- torch/NCCL-only open_CLIP flags: accepted so reference launch
    # commands run unmodified; each is a no-op here, as in the JAX package
    # (DDP graph capture, process-group wiring, torchscript export, synced
    # BatchNorm) -----------------------------------------------------------
    for noop in ("--torchscript", "--ddp-static-graph", "--horovod",
                 "--use-bn-sync", "--no-set-device-rank", "--debug",
                 "--log-local", "--enable-deepspeed", "--enable-flexpipe"):
        p.add_argument(noop, action="store_true",
                       help="accepted for open_CLIP CLI parity; no-op")
    p.add_argument("--dist-backend", type=str, default=None,
                   help="accepted for CLI parity; no-op")
    p.add_argument("--dist-url", type=str, default=None,
                   help="accepted for CLI parity; no-op")
    p.add_argument("--remote-sync-protocol", choices=["s3", "fsspec"],
                   default="s3",
                   help="accepted for CLI parity; --remote-sync here shells "
                        "out to rsync/cp for any target")

    # --- eval ----------------------------------------------------------------
    p.add_argument("--val-frequency", type=int, default=1)
    p.add_argument("--imagenet-val", type=str, default=None,
                   help="path to ImageNet val dir for zero-shot eval")
    p.add_argument("--imagenet-v2", type=str, default=None,
                   help="path to ImageNet-V2 dir: a second zero-shot eval "
                        "with the same classifier (open_CLIP --imagenet-v2)")
    p.add_argument("--zeroshot-frequency", type=int, default=2)

    ns = p.parse_args(args)
    for noop in ("torchscript", "ddp_static_graph", "horovod", "use_bn_sync",
                 "enable_deepspeed", "enable_flexpipe"):
        if getattr(ns, noop):
            import warnings
            warnings.warn(f"--{noop.replace('_', '-')} accepted for "
                          "open_CLIP CLI parity but is a no-op")
    if ns.fp16 or ns.bf16:
        if ns.fp16:
            import warnings
            warnings.warn("--fp16 requested: using bf16 (no loss "
                          "scaling needed)")
        ns.precision = "bf16"
    if ns.grad_checkpointing and ns.recompute_granularity == "none":
        ns.recompute_granularity = "full"
    if ns.dataset_type == "auto":
        if not ns.train_data:
            ns.dataset_type = "synthetic"
        elif ns.train_data.endswith((".csv", ".tsv")):
            ns.dataset_type = "csv"
        else:
            ns.dataset_type = "webdataset"
    ns.loss_axis_name = None  # one process: no gather axis
    return ns
