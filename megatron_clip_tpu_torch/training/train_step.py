"""The CLIP train step for one process and one microbatch.

Counterpart of `megatron_clip_tpu/training/train_step.py` (`TrainState`,
`make_train_step`) without the mesh, accum-freq, teacher, CoCa and patch
dropout, which come with their slices. One step: the training forward of
both towers, the contrastive loss, backward through the attention and
LayerNorm kernels, the optimizer update in place, and the post-step clamp of
logit_scale to [0, ln 100].

The metrics stay device tensors: the step itself never waits for the card.
"""
import dataclasses
from typing import Callable, Optional

from megatron_clip_tpu_torch.losses import ClipLoss
from megatron_clip_tpu_torch.models.clip import CLIPModel, clamp_logit_scale
from megatron_clip_tpu_torch.training.optim import AdamW, OptState


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer state
    and the number of steps taken."""
    model: CLIPModel
    opt_state: OptState
    step: int

    @classmethod
    def create(cls, model: CLIPModel, optimizer: AdamW) -> "TrainState":
        return cls(model=model, opt_state=optimizer.init(), step=0)


def make_train_step(model: CLIPModel, optimizer: AdamW, *,
                    loss_obj: Optional[Callable] = None) -> Callable:
    """Build `step(state, images, texts) -> (state, metrics)` for `model`,
    whose parameters `optimizer` was made for. images: [B, H, W, 3] float,
    texts: [B, S] token ids, numpy arrays or tensors. metrics: `loss`,
    `logit_scale` (exp of the clamped temperature the loss used) and
    `grad_norm` (the global norm before clipping), as 0-d device tensors."""
    loss_obj = loss_obj or ClipLoss()
    params = dict(model.named_parameters())

    def step(state: TrainState, images, texts):
        for p in params.values():
            p.grad = None
        out = model(images, texts)
        loss = loss_obj(out["image_features"], out["text_features"],
                        out["logit_scale"])
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
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
