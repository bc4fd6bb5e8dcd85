"""The CLIP and GPT train steps.

Counterpart of `megatron_clip_tpu/training/train_step.py` (`TrainState`,
`make_train_step`) with the mesh's `data` axis as a `torch.distributed`
group (the CLIP step's `group`), without the other axes, the teacher and
CoCa, which come with their slices. One CLIP step: the training forward of
both towers (with patch dropout where the vision config sets a rate), the
contrastive loss, backward through the attention and LayerNorm kernels, the
optimizer update in place, and the post-step clamp of logit_scale to
[0, ln 100]. With `microbatches` > 1, open_CLIP's --accum-freq as the JAX
step does it: a pass without gradients caches every block's features, then
each block recomputes its own with gradients inside the whole batch's
loss, the other blocks' cached features standing in, and the gradients are
summed. Over a group of W ranks each rank runs the forwards and backwards
of its own rows, gathers the features (with their gradient) so that the
loss is the global batch's, as the JAX trainer's is, and all-reduces the
gradients once a step. One GPT step (`make_gpt_train_step`) is
bench.py's `bench_gpt_345m` step: `gpt_loss` (chunked, or through the fused
lm-head cross entropy of `pretrain_gpt.py --fused-ce`), its backward, the
clipped AdamW update in place; with a seed, dropout at the config's rates,
and activation recompute as `remat` says (the step of
examples/pretrain_gpt_pipeline.sh), with bench.py's chain
(`make_gpt_optimizer`); `pretrain_gpt.py`'s runtime runs its own step
(`training/workload.py`: the microbatch accumulation, megatron's
optimizer branches).

The metrics stay device tensors: the step itself never waits for the card
(but for gloo's collectives, which stage CUDA tensors through the host).
"""
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from megatron_clip_tpu_torch.config import check_remat
from megatron_clip_tpu_torch.losses import ClipLoss, gather_features
from megatron_clip_tpu_torch.models.clip import CLIPModel, clamp_logit_scale
from megatron_clip_tpu_torch.models.gpt import GPTModel, gpt_loss
from megatron_clip_tpu_torch.models.vit import patch_keep_ids
from megatron_clip_tpu_torch.ops.dropout import fold_in
from megatron_clip_tpu_torch.parallel.sharding import reduction_plan
from megatron_clip_tpu_torch.training.optim import AdamW, OptState


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer state
    and the number of steps taken."""
    model: nn.Module
    opt_state: OptState
    step: int

    @classmethod
    def create(cls, model: nn.Module, optimizer: AdamW) -> "TrainState":
        return cls(model=model, opt_state=optimizer.init(), step=0)


class GradBuckets:
    """One flat gradient buffer a dtype (and reduction), allocated once,
    each parameter's `.grad` a view of it (DDP's gradient-as-bucket-view):
    the backward accumulates into the buffers in place, and
    `all_reduce_mean` reduces each buffer in one collective a group: no
    copy of the gradients into a flat buffer and back, and no buffer
    allocated a step (NCCL holds a tensor it reduced until its stream is
    done, so the allocator could not reuse a buffer made anew each step at
    once).

    A sharded model's gradients (`parallel/sharding.reduction_plan`, given
    as `plan`: each parameter's groups) are summed over each of their
    groups, in turn, then divided by the ranks that hold rows of their own
    (`ranks`); without a plan every buffer is reduced over the group
    `all_reduce_mean` is given and divided by its size."""

    def __init__(self, params: dict, plan: Optional[dict] = None,
                 ranks: Optional[int] = None):
        by_key = {}
        for n, p in params.items():
            key = (p.dtype, None if plan is None else plan[n])
            by_key.setdefault(key, []).append((n, p))
        self.flats, self.groups, self.views = [], [], {}
        self.ranks = ranks
        for (dtype, groups), named in by_key.items():
            flat = torch.zeros(sum(p.numel() for _, p in named), dtype=dtype,
                               device=named[0][1].device)
            self.flats.append(flat)
            self.groups.append(groups)
            for (n, p), part in zip(named, flat.split(
                    [p.numel() for _, p in named])):
                self.views[n] = part.view_as(p)

    def zero_(self) -> None:
        for flat in self.flats:
            flat.zero_()

    def attach(self, params: dict) -> None:
        """Zero the buffers and make them the parameters' gradients."""
        self.zero_()
        for n, p in params.items():
            p.grad = self.views[n]

    def all_reduce_mean(self, group) -> None:
        """Each gradient replaced, in place, by its mean over `group`: each
        buffer all-reduced (summed) in its dtype, then divided by W; a
        no-op without a group (one process). With a plan, each buffer is
        summed over its own groups and divided by `ranks`."""
        if group is None:
            return
        world = self.ranks or dist.get_world_size(group)
        for flat, groups in zip(self.flats, self.groups):
            for g in ((group,) if groups is None else groups):
                dist.all_reduce(flat, group=g)
            flat /= world


def make_train_step(model: CLIPModel, optimizer: AdamW, *,
                    loss_obj: Optional[Callable] = None,
                    microbatches: int = 1, seed: int = 0,
                    group=None) -> Callable:
    """Build `step(state, images, texts) -> (state, metrics)` for `model`,
    whose parameters `optimizer` was made for. images: [B, H, W, 3] float,
    texts: [B, S] token ids, numpy arrays or tensors. metrics: `loss`,
    `logit_scale` (exp of the clamped temperature the loss used) and
    `grad_norm` (the global norm before clipping), as 0-d device tensors.

    `microbatches` M > 1 splits the batch into M blocks (B must divide)
    and accumulates as the JAX step does: every block's loss is the whole
    batch's, so each block's gradient holds all of logit_scale's, and the
    sum is divided by M there; the metric `loss` is the last block's.
    `seed` keys patch dropout: the indices of step s come from
    `models.vit.patch_keep_ids(seed, s, i, rows, patches, rate)`, i the
    block (None without accumulation), the same in the cache pass and in
    block i.

    The loss is called with (image features, text features, logit_scale),
    as the JAX step calls it: a SigLIP model's `logit_bias` never reaches
    the loss, so its gradient is zero and it stays at its init (a
    reference defect kept for parity).

    `group`: a `torch.distributed` group of W ranks, each given its rows
    of the global batch (B/W; with M blocks, its share of each block in
    turn, `parallel.mesh.rank_rows`). Every forward's features are
    gathered over the group with their gradient (`losses.gather_features`)
    and `loss_obj` is called, without a group, on the whole block: every
    rank computes the global batch's loss, which is the metric, as the JAX
    trainer computes it on a `dp` mesh (`loss_axis_name = None`), so
    `--local-loss` and `--gather-with-grad` change nothing here, as there.
    Each rank's backward then holds W times its rows' share of the
    gradient (the gather's backward sums the W ranks' cotangents); after
    the last backward the gradients are all-reduced and divided by W
    (`GradBuckets`), before logit_scale's division by M and the
    update, so the clipping norm is the global batch's and every rank
    updates the same weights. Patch dropout draws the indices of the
    block's global rows and each rank keeps its own rows' of them."""
    loss_obj = loss_obj or ClipLoss()
    params = dict(model.named_parameters())
    vision = model.cfg.vision
    rate = vision.patch_dropout
    patches = vision.grid * vision.grid
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    buckets = (None if group is None
               else GradBuckets(params, reduction_plan(model), world))

    def keep(step: int, i: Optional[int], rows: int):
        if rate <= 0.0:
            return None
        ids = patch_keep_ids(seed, step, i, rows * world, patches, rate)
        return ids[rank * rows:(rank + 1) * rows]

    def features(out: dict) -> tuple:
        fi, ft = out["image_features"], out["text_features"]
        if group is None:
            return fi, ft
        return gather_features(fi, ft, group)

    def grads_of() -> dict:
        # a parameter the loss never saw (logit_bias) has a zero gradient
        return {n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}

    def blocks(images, texts):
        """The step's blocks (images, texts, block index): the batch
        itself, or its M blocks."""
        if microbatches == 1:
            return [(images, texts, None)]
        images = torch.as_tensor(images, device=model.device)
        texts = torch.as_tensor(texts, device=model.device)
        if images.shape[0] % microbatches:
            raise ValueError(f"batch {images.shape[0]} does not split into "
                             f"{microbatches} microbatches")
        return list(zip(images.chunk(microbatches),
                        texts.chunk(microbatches), range(microbatches)))

    def step(state: TrainState, images, texts):
        if buckets is None:
            for p in params.values():
                p.grad = None
        else:
            buckets.attach(params)
        todo = [(im, tx, keep(state.step, i, len(im)))
                for im, tx, i in blocks(images, texts)]
        cached = []  # the cache pass: every block's features, no gradients
        if microbatches > 1:
            with torch.no_grad():
                cached = [features(model(*block)) for block in todo]
        for j, block in enumerate(todo):
            out = model(*block)
            fi, ft = features(out)
            if cached:
                fi, ft = (torch.cat([c[k] for c in cached[:j]] + [own]
                                    + [c[k] for c in cached[j + 1:]])
                          for k, own in ((0, fi), (1, ft)))
            loss = loss_obj(fi, ft, out["logit_scale"])
            loss.backward()
        if buckets is not None:
            buckets.all_reduce_mean(group)
        grads = grads_of()
        grads["logit_scale"] /= microbatches
        opt_state, grad_norm = optimizer.update(state.opt_state, grads)
        for p in params.values():
            p.grad = None
        clamp_logit_scale(model)
        metrics = {"loss": loss.detach(),
                   "logit_scale": out["logit_scale"].detach(),
                   "grad_norm": grad_norm}
        return TrainState(model=state.model, opt_state=opt_state,
                          step=state.step + 1), metrics

    return step


def make_gpt_train_step(model: GPTModel, optimizer: AdamW, *,
                        loss_seq_chunk: int = 0, fused_ce: bool = False,
                        remat: Optional[str] = None,
                        seed: Optional[int] = None) -> Callable:
    """Build `step(state, tokens) -> (state, metrics)` for `model`, whose
    parameters `optimizer` was made for: tokens [B, S+1] integer ids on the
    model's device, inputs tokens[:, :-1] predicting tokens[:, 1:]. The
    loss is `gpt_loss` with `loss_seq_chunk` or `fused_ce` (which wins when
    both are given, as in the JAX package), under activation recompute
    `remat` (none, selective, mlp, full; default the model's `cfg.remat`),
    resolved here once.
    `seed` turns dropout on at the config's rates: step i draws from
    `fold_in(seed, i)`, formed on the host from plain ints, as the JAX
    workload folds the step into its key; None trains without dropout.
    metrics: `loss` and `grad_norm` (the global norm before clipping), as
    0-d device tensors."""
    params = dict(model.named_parameters())
    remat = check_remat(model.cfg.remat if remat is None else remat)

    def step(state: TrainState, tokens):
        for p in params.values():
            p.grad = None
        loss = gpt_loss(model, tokens, loss_seq_chunk=loss_seq_chunk,
                        fused_ce=fused_ce, remat=remat,
                        seed=None if seed is None else fold_in(seed,
                                                               state.step))
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        opt_state, grad_norm = optimizer.update(state.opt_state, grads)
        for p in params.values():
            p.grad = None
        return TrainState(model=state.model, opt_state=opt_state,
                          step=state.step + 1), {"loss": loss.detach(),
                                                 "grad_norm": grad_norm}

    return step
