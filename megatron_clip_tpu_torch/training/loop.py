"""The CLIP trainer: `run_training(args)`.

Counterpart of `megatron_clip_tpu/training/loop.py` (megatron's
pretrain()/train(), megatron/training.py:60-860, and open_CLIP's
main()/train_one_epoch, training/main.py:73-524, train.py:338-525) on one
device or data-parallel over torchrun's ranks: the model, optimizer and
data, then the epoch/step loop with the log line, NaN surveillance, saves
at `--save-interval` (in the background, older checkpoints pruned once the
new one has committed), the SIGTERM, `--exit-interval` and
`--exit-duration-in-mins` exits, and at each epoch's end the save, the val
metrics and the zero-shot eval. Resume reads
`--resume latest` (the run dir under `--save`) or an explicit checkpoint
root, and fast-forwards the data to the consumed samples.

It runs on the card unless `--device cpu` (or `device="cpu"`) asks for the
CPU; without a CUDA device it raises. The attention backward follows the
JAX default, from saved probabilities unless MCT_MHA_SAVE_PROBS=0, read
once a run. Host batches reach the card one batch ahead, through pinned
buffers and a copy stream on a thread (`_Prefetch`, where the JAX
package's unused `device_prefetch` stood).

Launched by `torch.distributed.run` with more than one process, the run is
the JAX trainer's on a `dp = W` mesh (`parallel/mesh.py`): `--batch-size`
stays the global batch, each rank loads and steps on its rows of it
(`parallel.mesh.rank_rows`; `--workers` decode workers a rank), the step
gathers the features and all-reduces the gradients
(`training/train_step.py`), and the weights start as rank 0 draws them.
Rank 0 alone logs, writes checkpoints, copies the codebase, prunes and
evaluates, while the others wait at a barrier; every rank loads on resume.
Once a step the ranks agree on the host (`mesh.agree`) on SIGTERM (any
rank's) and on the `--exit-duration-in-mins` budget (rank 0's clock), so
that they stop, save and exit at the same step, and at each batch on
whether every rank still has one, so that a loader that ends early ends
the epoch on every rank.

Flags of modules the port does not carry yet raise NotImplementedError
before anything is built, each naming its ROADMAP Queue A item
(`_REFUSED`): there is no silent no-op.
"""
import glob
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from megatron_clip_tpu_torch import factory
from megatron_clip_tpu_torch.checkpoints import (
    global_saver, latest_checkpoint_step, load_checkpoint, save_checkpoint)
from megatron_clip_tpu_torch.config import check_remat
from megatron_clip_tpu_torch.data.loaders import get_data
from megatron_clip_tpu_torch.data.transforms import image_transform
from megatron_clip_tpu_torch.parallel import mesh
from megatron_clip_tpu_torch.training.optim import (
    OptState, const_lr, const_lr_cooldown, constant_lr, cosine_lr,
    make_optimizer, tower_lock_mask)
from megatron_clip_tpu_torch.training.signals import sigterm_latch
from megatron_clip_tpu_torch.training.train_step import (
    TrainState, make_train_step)


def _log(msg: str):
    if mesh.is_main():
        print(msg, flush=True)


def _aug_keys(args) -> set:
    return {it.partition("=")[0].replace("-", "_")
            for it in (getattr(args, "aug_cfg", None) or [])}


# (Queue A item, flag, whether args ask for it)
_REFUSED = (
    (2, "a CoCa model", lambda a: a.model.startswith("coca")),
    (2, "--precision fp16", lambda a: a.precision == "fp16"),
    (3, "--pretrained", lambda a: bool(a.pretrained)),
    # the teacher needs --distill-pretrained, which needs --pretrained's
    # checkpoint reader
    (3, "--distill-model", lambda a: bool(a.distill_model)),
    (3, "--pretrained-image", lambda a: bool(a.pretrained_image)),
    (3, "--aug-cfg color_jitter", lambda a: "color_jitter" in _aug_keys(a)),
    (3, "--aug-cfg auto_augment",
     lambda a: bool({"auto_augment", "autoaugment"} & _aug_keys(a))),
    (5, "--extra-world-size > 0", lambda a: a.extra_world_size > 0),
    (5, "--tensor-model-parallel-size > 1",
     lambda a: a.tensor_model_parallel_size > 1),
    (5, "--pipeline-model-parallel-size > 1",
     lambda a: a.pipeline_model_parallel_size > 1),
    (5, "--virtual-pipeline-parallel-size > 1",
     lambda a: a.virtual_pipeline_parallel_size > 1),
    (5, "--fsdp-parallel-size > 1", lambda a: a.fsdp_parallel_size > 1),
    (5, "--dcn-data-parallel-size > 1",
     lambda a: a.dcn_data_parallel_size > 1),
    (5, "--sequence-parallel", lambda a: a.sequence_parallel),
    (7, "--remote-sync", lambda a: bool(a.remote_sync)),
)


def check_supported(args) -> None:
    """Raise NotImplementedError for the first flag the port does not carry
    yet, naming its ROADMAP Queue A item."""
    for item, flag, asked in _REFUSED:
        if asked(args):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP "
                                      f"Queue A item {item})")


def _make_schedule(args, total_steps: int):
    if getattr(args, "skip_scheduler", False):
        # open_CLIP --skip-scheduler: raw constant lr, no warmup/decay
        return constant_lr(args.lr)
    if args.lr_scheduler == "cosine":
        return cosine_lr(args.lr, args.warmup, total_steps)
    if args.lr_scheduler == "const":
        return const_lr(args.lr, args.warmup)
    cooldown = (args.epochs_cooldown or 1) * max(
        total_steps // max(args.epochs, 1), 1)
    return const_lr_cooldown(args.lr, args.warmup, total_steps, cooldown,
                             args.lr_cooldown_power, args.lr_cooldown_end)


def _model_overrides(args) -> dict:
    """The `--v-*` tower flags, `--force-image-size`,
    `--force-patch-dropout` and `--force-quick-gelu` as `create_model`
    overrides."""
    ov = {}
    vision = {}
    if args.v_num_layers:
        vision["layers"] = args.v_num_layers
    if args.v_hidden_size:
        vision["width"] = args.v_hidden_size
    if args.v_patch_size:
        vision["patch_size"] = args.v_patch_size
    if args.v_image_size:
        vision["image_size"] = args.v_image_size
    fis = getattr(args, "force_image_size", None)
    if fis:
        # open_CLIP --force-image-size; square towers: take the first dim
        vision["image_size"] = int(fis[0] if isinstance(fis, (list, tuple))
                                   else fis)
    if getattr(args, "force_patch_dropout", None) is not None:
        # open_CLIP --force-patch-dropout: override the config's rate
        vision["patch_dropout"] = args.force_patch_dropout
    if vision:
        base = factory.get_model_config(args.model.replace("/", "-"))
        base_v = dict(base["vision_cfg"]) if base else {}
        base_v.update(vision)
        ov["vision_cfg"] = base_v
    if args.force_quick_gelu:
        ov["quick_gelu"] = True
    return ov


def _prune_older_checkpoints(root: str, keep_step: int) -> None:
    """open_CLIP --delete-previous-checkpoint: only the newest survives."""
    for d in glob.glob(os.path.join(root, "iter_*")):
        try:
            s = int(os.path.basename(d)[5:])
        except ValueError:
            continue
        if s != keep_step:
            shutil.rmtree(d, ignore_errors=True)


def _save_probs_default() -> bool:
    """The attention backward's mode, as the JAX package reads it
    (`megatron_clip_tpu/ops/pallas/fused_mha.py:279-281`)."""
    return os.environ.get("MCT_MHA_SAVE_PROBS", "1") == "1"


def resolve_device(args, device=None) -> torch.device:
    """`device`, else `--device`; a CUDA device that is not there raises."""
    device = torch.device(device or getattr(args, "device", None) or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_training: no CUDA device is available; pass "
                           "--device cpu to train on the CPU")
    return device


def run_training(args, device=None) -> dict:
    """Train as `args` (from `training/params.parse_args`) say, on `device`
    (default `args.device`); returns the last logged metrics, with the val
    and zero-shot metrics of the last eval (rank 0's). Under torchrun the
    run joins its group first (`mesh.init_distributed`) and leaves it on
    every exit path."""
    check_supported(args)
    device = mesh.init_distributed(args, resolve_device(args, device))
    try:
        # SIGTERM latch around the whole run: the context manager restores
        # the previous handler on every exit path, exceptions included
        with sigterm_latch() as term:
            return _run_training(args, term, device)
    finally:
        mesh.destroy()


def _run_training(args, term, device: torch.device) -> dict:
    world, rank = mesh.world_size(), mesh.rank()
    microbatches = max(1, args.accum_freq)
    mesh.rank_rows(args.batch_size, microbatches, rank, world)  # B % (M W)
    model = factory.create_model(
        args.model, precision=args.precision, device=device, seed=args.seed,
        attn_save_probs=_save_probs_default(), **_model_overrides(args))
    mesh.broadcast_module(model)  # every rank starts from rank 0's weights
    model.remat = check_remat(args.recompute_granularity)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"model {args.model}: {n_params/1e6:.1f}M params | device={device} "
         f"dp={mesh.data_parallel_size(args, world)} fsdp=1 tp=1 pp=1 "
         f"extra=0")

    try:
        from megatron_clip_tpu_torch.tokenizer import get_tokenizer
        tokenizer = get_tokenizer(args.model)
    except FileNotFoundError:
        tokenizer = None
        if args.dataset_type != "synthetic":
            raise
    image_size = model.cfg.vision.image_size
    mean = getattr(args, "image_mean", None)
    std = getattr(args, "image_std", None)
    pp_train = image_transform(image_size, is_train=True, mean=mean, std=std,
                               aug_cfg=getattr(args, "aug_cfg", None))
    pp_val = image_transform(image_size, is_train=False, mean=mean, std=std)
    data = get_data(args, pp_train, pp_val, tokenizer,
                    context_length=model.context_length,
                    image_size=image_size, rank=rank, world_size=world,
                    microbatches=microbatches)
    steps_per_epoch = args.steps_per_epoch or data["train"].num_batches
    total_steps = steps_per_epoch * args.epochs

    schedule = _make_schedule(args, total_steps)
    lock_mask = None
    if args.lock_image or args.lock_text:
        # LiT (open_CLIP --lock-image / --lock-text): the JAX loop's
        # tower_lock_mask, last in the optimizer's chain
        lock_mask = tower_lock_mask(
            dict(model.named_parameters()), lock_image=args.lock_image,
            image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text,
            text_unlocked_layers=args.lock_text_unlocked_layers)
    optimizer = make_optimizer(
        model, schedule, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        weight_decay=args.wd, grad_clip_norm=args.grad_clip_norm,
        lock_mask=lock_mask)
    runner = _JointRunner(model, optimizer, factory.create_loss(args),
                          device, microbatches=microbatches, seed=args.seed,
                          group=mesh.group())

    start_step, consumed = 0, 0
    if args.resume:
        # open_CLIP --resume semantics (main.py:108-170): "latest" finds the
        # newest checkpoint under the run dir; anything else is an explicit
        # checkpoint root to load from (which does not require --save)
        root = None
        if args.resume != "latest":
            root = os.path.expanduser(args.resume)
            if latest_checkpoint_step(root) is None:
                raise FileNotFoundError(
                    f"--resume {args.resume}: no checkpoint tracker found "
                    f"under that directory")
        elif args.save:
            root = os.path.join(args.save, args.name or "default")
            if latest_checkpoint_step(root) is None:
                root = None
        else:
            _log("WARNING: --resume latest needs --save to locate the run "
                 "dir; starting from scratch")
        if root is not None:
            meta, start_step = runner.load(root)
            consumed = meta.get("consumed_samples", 0)
            _log(f"resumed from {root} @ step {start_step} "
                 f"(consumed_samples={consumed})")

    save_root = (os.path.join(args.save, args.name or "default")
                 if args.save else None)
    main = mesh.is_main()
    if getattr(args, "copy_codebase", False) and save_root and main:
        _copy_codebase(args.save, save_root)
    writer = None
    if "tensorboard" in (args.report_to or "") and save_root and main:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(os.path.join(save_root, "tensorboard"))
        except ImportError:
            _log("tensorboardX unavailable; skipping TB logging")
    # wandb mirror (open_CLIP --report-to wandb); a clean no-op when the
    # package is absent from the image
    wandb_run = None
    if "wandb" in (args.report_to or "") and main:
        try:
            import wandb
            wandb_run = wandb.init(project=args.wandb_project_name,
                                   name=args.name or None,
                                   notes=getattr(args, "wandb_notes", None),
                                   config=vars(args))
        except Exception as e:  # noqa: BLE001 — logging must not kill training
            _log(f"wandb unavailable ({type(e).__name__}); skipping")

    def _finish():
        global_saver().wait()  # barrier on any in-flight async save
        if wandb_run is not None:
            wandb_run.finish()
        mesh.barrier()  # no rank reads a `latest` rank 0 has yet to write

    step = start_step
    interval_saved = None  # the step the interval save last wrote
    t_window = time.perf_counter()
    run_t0 = t_window
    window_samples = 0
    nan_iters = 0  # NaN surveillance (megatron training.py:527-539)
    final_metrics = {}
    # consumed-samples resume: fast-forward within the interrupted epoch
    # (megatron/training.py:1031-1038); loaders with skip_batches() seek
    # without decoding, others are replayed and discarded
    start_epoch = start_step // steps_per_epoch
    skip_batches = start_step % steps_per_epoch
    if start_epoch and hasattr(data["train"], "set_epoch"):
        # sync the loader's epoch-keyed shard order/seeds so the mid-epoch
        # fast-forward skips the samples the interrupted run consumed
        data["train"].set_epoch(start_epoch)
    for epoch in range(start_epoch, args.epochs):
        loader = data["train"]
        pre_skipped = 0
        if epoch == start_epoch and skip_batches and \
                hasattr(loader, "skip_batches"):
            loader.skip_batches(skip_batches)
            pre_skipped = skip_batches
        for batch_i, (images, texts) in enumerate(
                _together(runner.batches(loader))):
            if epoch == start_epoch and \
                    batch_i < skip_batches - pre_skipped:
                continue
            if step >= total_steps or (args.exit_interval and
                                       step >= args.exit_interval):
                break
            if step >= (epoch + 1) * steps_per_epoch:
                # --steps-per-epoch shorter than the loader: stop the epoch
                # here so the resume math, the LR schedule and the
                # epoch-boundary eval/save cadence agree on where epochs fall
                break
            metrics = runner.step(images, texts)
            step += 1
            consumed += args.batch_size
            window_samples += args.batch_size
            if step % args.log_interval == 0 or step == total_steps:
                loss = float(metrics["loss"])  # waits for the card
                if not np.isfinite(loss):
                    nan_iters += 1
                    _log(f"WARNING: non-finite loss at step {step} "
                         f"(nan iters so far: {nan_iters})")
                dt = time.perf_counter() - t_window
                ips = window_samples / dt if dt > 0 else 0.0
                lr_now = float(schedule(step))
                scale = float(metrics.get("logit_scale", 0.0))
                _log(f"step {step}/{total_steps} | epoch {epoch} | "
                     f"loss {loss:.4f} | lr {lr_now:.3e} | "
                     f"logit_scale {scale:.2f} | {ips:.1f} samples/s")
                if writer is not None:
                    writer.add_scalar("train/loss", loss, step)
                    writer.add_scalar("train/lr", lr_now, step)
                    writer.add_scalar("train/logit_scale", scale, step)
                    writer.add_scalar("train/samples_per_s", ips, step)
                if wandb_run is not None:
                    wandb_run.log({"train/loss": loss, "train/lr": lr_now,
                                   "train/logit_scale": scale,
                                   "train/samples_per_s": ips}, step=step)
                final_metrics = {"loss": loss, "samples_per_s": ips,
                                 "step": step}
                t_window = time.perf_counter()
                window_samples = 0
            if save_root and args.save_interval and \
                    step % args.save_interval == 0:
                # async: the loop goes on while the host copy is written;
                # pruning waits for the commit (until the tracker moves,
                # the previous checkpoint is the only durable one)
                prune = ((lambda s=step: _prune_older_checkpoints(
                    save_root, s))
                    if args.delete_previous_checkpoint else None)
                runner.save(save_root, step, consumed, block=False,
                            on_commit=prune)
                interval_saved = step
            # one host collective a step: SIGTERM on any rank, rank 0's
            # clock against --exit-duration-in-mins
            stop, out_of_time = mesh.agree([
                term["flag"], main and args.exit_duration_in_mins is not None
                and time.perf_counter() - run_t0
                > args.exit_duration_in_mins * 60])
            if stop:
                if save_root:
                    # skip the save when the interval branch above just
                    # wrote this very step
                    if not args.save_interval \
                            or step % args.save_interval != 0:
                        runner.save(save_root, step, consumed)
                    _log(f"SIGTERM: saved checkpoint @ step {step}, exiting")
                else:
                    _log(f"SIGTERM: exiting @ step {step} (no --save)")
                _finish()
                return final_metrics
            if out_of_time:
                # megatron --exit-duration-in-mins: save-then-exit on a
                # wall-clock budget (training.py:829-851)
                if save_root:
                    runner.save(save_root, step, consumed)
                _log(f"exiting at step {step}: --exit-duration-in-mins "
                     f"{args.exit_duration_in_mins} budget reached")
                _finish()
                return final_metrics
        # a step budget (total_steps or --exit-interval) ends the RUN, not
        # just the epoch: save/eval once below, then stop (megatron
        # --exit-interval exits outright, training.py:829)
        run_done = step >= total_steps or (args.exit_interval and
                                           step >= args.exit_interval)
        if save_root and ((epoch + 1) % args.save_frequency == 0
                          or args.save_most_recent or run_done):
            if interval_saved == step:
                # the interval save wrote this very step: wait for it to
                # commit instead of writing the same state again (as the
                # SIGTERM exit skips it; the JAX loop writes it twice)
                global_saver().wait()
            else:
                runner.save(save_root, step, consumed)
            _log(f"saved checkpoint @ step {step}")
            if args.delete_previous_checkpoint and main:
                _prune_older_checkpoints(save_root, step)
        # validation + zero-shot eval at epoch boundaries (open_CLIP
        # evaluate/zero_shot_eval cadence, train.py:530, main.py epoch loop)
        if (epoch + 1) % max(args.val_frequency, 1) == 0:
            if main:
                final_metrics.update(_epoch_eval(args, runner.model, data,
                                                 tokenizer, epoch, step,
                                                 save_root, wandb_run))
            mesh.barrier()
        if run_done:
            break
    if nan_iters:
        _log(f"total non-finite loss iterations: {nan_iters}")
    _finish()
    return final_metrics


def _together(batches):
    """`batches` while every rank still has one: over more than one rank,
    the ranks agree at each batch, so that a loader that ends early (a
    rank's shards run out) ends the epoch on every rank, not in a
    collective the others never join."""
    if mesh.world_size() == 1:
        yield from batches
        return
    for item in batches:
        if mesh.agree([0])[0]:
            return
        yield item
    mesh.agree([1])


def _copy_codebase(save: str, save_root: str) -> None:
    """open_CLIP --copy-codebase (main.py copy_codebase): snapshot the code
    into the experiment dir for reproducibility."""
    code_dir = os.path.join(save_root, "code")
    if os.path.exists(code_dir):
        return
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base_ignore = shutil.ignore_patterns(
        ".git", "__pycache__", "*.pyc", "logs", "wandb")
    save_abs = os.path.abspath(save)

    def _ignore(path, names):
        ignored = set(base_ignore(path, names))
        for n in names:
            # never recurse into the experiment root itself, matched by
            # path, not basename
            if os.path.abspath(os.path.join(path, n)) == save_abs:
                ignored.add(n)
        return ignored

    shutil.copytree(src, code_dir, ignore=_ignore)
    _log(f"copied codebase to {code_dir}")


def _epoch_eval(args, model, data, tokenizer, epoch, step, save_root,
                wandb_run) -> dict:
    """The epoch end's val metrics (`--val-data`) and zero-shot eval
    (`--imagenet-val`, `--imagenet-v2` every `--zeroshot-frequency`
    epochs); returns them for the final metrics."""
    out = {}
    if "val" in data:
        from megatron_clip_tpu_torch.evaluation import contrastive_eval_metrics
        em = contrastive_eval_metrics(model, data["val"])
        _log("val: " + " ".join(f"{k}={v:.4f}" for k, v in em.items()
                                if isinstance(v, float)))
        out.update({f"val_{k}": v for k, v in em.items()})
        if save_root:
            import json
            with open(os.path.join(save_root, "results.jsonl"), "a") as rf:
                rf.write(json.dumps({"epoch": epoch, **{
                    k: v for k, v in em.items()
                    if isinstance(v, (int, float))}}) + "\n")
        if wandb_run is not None:
            wandb_run.log({f"val/{k}": v for k, v in em.items()
                           if isinstance(v, (int, float))}, step=step)
    if (args.imagenet_val or args.imagenet_v2) and tokenizer is not None \
            and (epoch + 1) % max(args.zeroshot_frequency, 1) == 0:
        from megatron_clip_tpu_torch.data.image_folder import \
            image_folder_batches
        from megatron_clip_tpu_torch.evaluation import (
            build_zero_shot_classifier, zero_shot_eval)
        from megatron_clip_tpu_torch.evaluation.zero_shot import \
            load_imagenet_metadata
        names, templates = load_imagenet_metadata()
        clf = build_zero_shot_classifier(model, names, templates, tokenizer)
        image_size = model.cfg.vision.image_size
        for root, prefix in ((args.imagenet_val, ""),
                             (args.imagenet_v2, "v2_")):
            if not root:
                continue
            zs = zero_shot_eval(model, clf, image_folder_batches(
                root, args.batch_size, image_size, is_train=False,
                epochs=1))
            _log(f"zero-shot{' v2' if prefix else ''}: "
                 + " ".join(f"{k}={v:.4f}" for k, v in zs.items()))
            out.update({f"{prefix}{k}": v for k, v in zs.items()})
    return out


class _Prefetch:
    """The loader's batches on the card, one batch ahead: a thread iterates
    the loader, copies each batch into a pinned buffer (`stage`, two buffer
    sets used in turn, a set refilled only once its last copy has
    finished) and then to the card by a non_blocking copy on its own
    stream, while the step of the batch before runs. Iterating yields
    (images, texts) on the card, the step's stream made to wait for their
    copy and nothing else. A loader's exception is raised where the batch
    would have been; closing (or leaving the loop) stops the thread and
    closes the loader's iterator."""

    _END = object()

    def __init__(self, loader, device: torch.device):
        self.loader, self.device = loader, device
        self.stream = torch.cuda.Stream(device)
        self.sets = [None, None]

    def stage(self, i: int, arrays):
        """Batch i's arrays into pinned buffer set i % 2, then to the card:
        (device tensors, the copy's event)."""
        arrays = [np.asarray(a) for a in arrays]
        slot = self.sets[i % 2]
        if slot is None or [p.shape for p in slot[0]] != \
                [torch.Size(a.shape) for a in arrays]:
            slot = self.sets[i % 2] = [
                [torch.empty(a.shape, pin_memory=True,
                             dtype=torch.from_numpy(a).dtype)
                 for a in arrays], None]
        pinned, done = slot
        if done is not None:
            done.synchronize()
        for p, a in zip(pinned, arrays):
            np.copyto(p.numpy(), a)
        with torch.cuda.stream(self.stream):
            out = [p.to(self.device, non_blocking=True) for p in pinned]
            slot[1] = torch.cuda.Event()
            slot[1].record(self.stream)
        return out, slot[1]

    def _fill(self, q: queue.Queue, stop: threading.Event) -> None:
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False
        it = iter(self.loader)
        try:
            for i, batch in enumerate(it):
                if not put(self.stage(i, batch)):
                    return
            put(self._END)
        except Exception as e:  # noqa: BLE001 — raised in the loop
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()
        thread = threading.Thread(target=self._fill, args=(q, stop),
                                  name="batch-prefetch", daemon=True)
        thread.start()
        compute = torch.cuda.current_stream(self.device)
        try:
            while True:
                item = q.get()
                if item is self._END:
                    return
                if isinstance(item, Exception):
                    raise item
                tensors, done = item
                compute.wait_event(done)
                for t in tensors:
                    t.record_stream(compute)
                yield tuple(tensors)
        finally:
            stop.set()
            # a loader waiting on its decode workers stops at its next batch
            thread.join(timeout=60)


class _JointRunner:
    """The train step on one device, or on this rank's over `group`: the
    model (its parameters updated in place), the optimizer state and the
    step count, saved (by rank 0 alone: every rank holds the same) and
    loaded as one tree: {"params": state dict, "opt_state": {count, mu,
    nu, schedule_count}, "step": int}."""

    def __init__(self, model, optimizer, loss_obj, device: torch.device,
                 microbatches: int = 1, seed: int = 0, group=None):
        self.model = model
        self.state = TrainState.create(model, optimizer)
        self.step_fn = make_train_step(model, optimizer, loss_obj=loss_obj,
                                       microbatches=microbatches, seed=seed,
                                       group=group)
        self.device = device

    def batches(self, loader):
        """`loader`'s batches as the step takes them: on the card through
        `_Prefetch`, on the CPU as they are."""
        return _Prefetch(loader, self.device) \
            if self.device.type == "cuda" else loader

    def step(self, images, texts):
        self.state, metrics = self.step_fn(self.state, images, texts)
        return metrics

    def state_tree(self) -> dict:
        opt = self.state.opt_state
        return {"params": dict(self.model.state_dict()),
                "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu,
                              "schedule_count": opt.schedule_count},
                "step": self.state.step}

    def save(self, root, step, consumed, block=True, on_commit=None):
        if not mesh.is_main():
            return
        save_checkpoint(root, step, self.state_tree(),
                        {"consumed_samples": consumed}, block=block,
                        on_commit=on_commit)

    def load(self, root):
        """Load the newest checkpoint under `root` into the model and the
        optimizer state; returns (metadata, step)."""
        tree, meta, step = load_checkpoint(root)
        self.model.load_state_dict(tree["params"])
        like = self.state.opt_state
        opt = tree["opt_state"]
        self.state = TrainState(
            model=self.model,
            opt_state=OptState(
                count=opt["count"],
                mu={n: t.to(like.mu[n]) for n, t in opt["mu"].items()},
                nu={n: t.to(like.nu[n]) for n, t in opt["nu"].items()},
                schedule_count=opt["schedule_count"]),
            step=tree["step"])
        return meta, step
