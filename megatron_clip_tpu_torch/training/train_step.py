"""The CLIP and GPT train steps for one process.

Counterpart of `megatron_clip_tpu/training/train_step.py` (`TrainState`,
`make_train_step`) without the mesh, teacher and CoCa, which come with their
slices. One CLIP step: the training forward of both towers (with patch
dropout where the vision config sets a rate), the contrastive loss, backward
through the attention and LayerNorm kernels, the optimizer update in place,
and the post-step clamp of logit_scale to [0, ln 100]. With `microbatches`
> 1, open_CLIP's --accum-freq as the JAX step does it: a pass without
gradients caches every block's features, then each block recomputes its
own with gradients inside the whole batch's loss, the other blocks' cached
features standing in, and the gradients are summed. One GPT step (`make_gpt_train_step`) is
bench.py's `bench_gpt_345m` step: `gpt_loss` (chunked, or through the fused
lm-head cross entropy of `pretrain_gpt.py --fused-ce`), its backward, the
clipped AdamW update in place; with a seed, dropout at the config's rates,
and activation recompute as `remat` says (the step of
examples/pretrain_gpt_pipeline.sh). The optimizer of `pretrain_gpt.py`'s own
runtime (`training/workload.py`: its schedules and decay masks) is not
ported yet (ROADMAP Queue A item 4); the GPT step takes bench.py's chain
(`make_gpt_optimizer`).

The metrics stay device tensors: the step itself never waits for the card.
"""
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from megatron_clip_tpu_torch.config import check_remat
from megatron_clip_tpu_torch.losses import ClipLoss
from megatron_clip_tpu_torch.models.clip import CLIPModel, clamp_logit_scale
from megatron_clip_tpu_torch.models.gpt import GPTModel, gpt_loss
from megatron_clip_tpu_torch.models.vit import patch_keep_ids
from megatron_clip_tpu_torch.ops.dropout import fold_in
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


def make_train_step(model: CLIPModel, optimizer: AdamW, *,
                    loss_obj: Optional[Callable] = None,
                    microbatches: int = 1, seed: int = 0) -> Callable:
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
    reference defect kept for parity)."""
    loss_obj = loss_obj or ClipLoss()
    params = dict(model.named_parameters())
    vision = model.cfg.vision
    rate = vision.patch_dropout
    patches = vision.grid * vision.grid

    def keep(step: int, i: Optional[int], rows: int):
        if rate <= 0.0:
            return None
        return patch_keep_ids(seed, step, i, rows, patches, rate)

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
        for p in params.values():
            p.grad = None
        todo = [(im, tx, keep(state.step, i, len(im)))
                for im, tx, i in blocks(images, texts)]
        cached = []  # the cache pass: every block's features, no gradients
        if microbatches > 1:
            with torch.no_grad():
                cached = [model(*block) for block in todo]
        for j, block in enumerate(todo):
            out = model(*block)
            fi, ft = out["image_features"], out["text_features"]
            if cached:
                fi, ft = (torch.cat([c[k] for c in cached[:j]] + [own]
                                    + [c[k] for c in cached[j + 1:]])
                          for k, own in (("image_features", fi),
                                         ("text_features", ft)))
            loss = loss_obj(fi, ft, out["logit_scale"])
            loss.backward()
        scale = params["logit_scale"]
        scale.grad = scale.grad / microbatches
        opt_state, grad_norm = optimizer.update(state.opt_state, grads_of())
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
    `remat` (none, selective, full; default the model's `cfg.remat`),
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
