"""Contrastive losses, on one process and across the data-parallel group.

Counterpart of `megatron_clip_tpu/losses.py::clip_loss`, `gather_features`,
`ClipLoss` and `SigLipLoss`. Without a group: the global-batch InfoNCE of
open_CLIP's ClipLoss on features that one process holds whole, logits
formed in fp32 with labels arange(B); and SigLIP's sigmoid pairwise loss
over the same batch. With a `torch.distributed` group, the JAX `axis_name`
forms: `gather_features` (the differentiable all-gather, or the local
shard reinserted into a detached one), `ClipLoss(local_loss=...)` with the
labels offset by rank x B_local, and SigLIP's ring exchange of the text
features; each rank's loss is averaged over the ranks (JAX `pmean`).

The gradient a rank's backward leaves is that of the sum of every rank's
loss, as under open_CLIP's DDP: W times the global loss's, which the
trainer's gradient all-reduce divides by W (`training/train_step.py`).
The trainer itself gathers the features and calls the loss without a group
(the JAX trainer's `loss_axis_name = None`). CoCa and distillation losses
come with their slices.
"""
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _AllGather(torch.autograd.Function):
    """x [b, ...] -> every rank's x, rank order, [W b, ...]; its backward,
    the transpose of `jax.lax.all_gather(tiled=True)`: the cotangents
    summed over ranks, this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        b = g.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * b:(r + 1) * b], None


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    out = x.new_empty((world * x.shape[0], *x.shape[1:]))
    dist.all_gather(list(out.chunk(world)), x.contiguous(), group=group)
    return out


def gather_features(image_features: torch.Tensor,
                    text_features: torch.Tensor, group,
                    gather_with_grad: bool = True) -> tuple:
    """Both feature tensors gathered over `group` in rank order (open_CLIP
    `gather_features`, loss.py:20-64). With `gather_with_grad` the gather
    is differentiable; without it the gathered copy is detached and this
    rank's own features are put back in their place, so only they carry a
    gradient."""
    def gather(x):
        if gather_with_grad:
            return _AllGather.apply(x, group)
        with torch.no_grad():
            g = _gather(x, group)
        b, r = x.shape[0], dist.get_rank(group)
        return torch.cat([g[:r * b], x, g[(r + 1) * b:]])
    return gather(image_features), gather(text_features)


class _MeanOverRanks(torch.autograd.Function):
    """The value: the mean of x over the group (JAX `pmean`). The backward
    passes the cotangent through: each rank's backward stands for its own
    term of the sum the trainer's gradient all-reduce forms."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    """x of rank r goes to rank r + 1; returns what rank r - 1 sent (JAX
    `ppermute` with perm i -> i + 1). The backward sends the cotangent the
    other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    if x.is_cuda and "nccl" not in dist.get_backend(group):
        # gloo's point-to-point reads a CUDA tensor's pointer as host
        # memory and aborts the process
        raise RuntimeError("SigLipLoss's ring exchange of CUDA tensors "
                           "needs the nccl backend; gloo sends only CPU "
                           "tensors point to point")
    world, r = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (r + step) % world)
    frm = dist.get_global_rank(group, (r - step) % world)
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                       dist.P2POp(dist.irecv, out, frm,
                                                  group)]):
        req.wait()
    return out


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Global InfoNCE. features: [N, D] L2-normalised; logit_scale: the
    temperature already exponentiated. Mean of the image->text and
    text->image cross entropies, logits in fp32, labels arange(N)."""
    logits = logit_scale * image_features.float() @ text_features.float().T
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


class ClipLoss:
    """open_CLIP's ClipLoss contract: called with (image features, text
    features, logit_scale). Without a group, `clip_loss` of them, whatever
    the flags. With one, the features are this rank's rows: they are
    gathered (`gather_features`); `local_loss` forms only this rank's rows
    of the logits against every rank's features, labels offset by rank x
    B_local, else every rank forms the whole [B W, B W] logits; the
    result is the mean over ranks. The defaults are the JAX package's."""

    def __init__(self, local_loss: bool = True, gather_with_grad: bool = True,
                 group=None):
        self.local_loss = local_loss
        self.gather_with_grad = gather_with_grad
        self.group = group

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor,
                 logit_scale: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return clip_loss(image_features, text_features, logit_scale)
        all_img, all_txt = gather_features(image_features, text_features,
                                           self.group, self.gather_with_grad)
        if not self.local_loss:
            loss = clip_loss(all_img, all_txt, logit_scale)
        else:
            b = image_features.shape[0]
            lpi = logit_scale * image_features.float() @ all_txt.float().T
            lpt = logit_scale * text_features.float() @ all_img.float().T
            labels = torch.arange(b, device=lpi.device) \
                + dist.get_rank(self.group) * b
            loss = 0.5 * (F.cross_entropy(lpi, labels)
                          + F.cross_entropy(lpt, labels))
        return _MeanOverRanks.apply(loss, self.group)


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None,
                positive: bool = True) -> torch.Tensor:
    """SigLIP's sigmoid loss over one batch of N pairs: logits = scale *
    img @ txt^T (+ bias), label +1 on the diagonal and -1 elsewhere,
    -sum(log sigmoid(label * logits)) / N, in fp32. `positive` False: the
    texts are another rank's, every label -1."""
    logits = logit_scale * image_features.float() @ text_features.float().T
    if logit_bias is not None:
        logits = logits + logit_bias
    n = image_features.shape[0]
    sign = (2.0 * torch.eye(n, device=logits.device) - 1.0) if positive \
        else -torch.ones_like(logits)
    return -F.logsigmoid(sign * logits).sum() / n


class SigLipLoss:
    """SigLIP's loss contract: called with (image features, text features,
    logit_scale[, logit_bias]). Without a group, `siglip_loss` of them.
    With one, the features are this rank's rows: the rank's own pairs, then
    W - 1 steps of the ring, each passing the text features one rank on
    (`batch_isend_irecv`, differentiable) and adding the negatives against
    them; the mean over ranks. The JAX train step calls the loss without
    the bias, and so does the port's (see `training/train_step.py`)."""

    def __init__(self, group=None):
        self.group = group

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = siglip_loss(image_features, text_features, logit_scale,
                           logit_bias)
        if self.group is None:
            return loss
        txt = text_features
        for _ in range(dist.get_world_size(self.group) - 1):
            txt = _RingShift.apply(txt, self.group)
            loss = loss + siglip_loss(image_features, txt, logit_scale,
                                      logit_bias, positive=False)
        return _MeanOverRanks.apply(loss, self.group)
