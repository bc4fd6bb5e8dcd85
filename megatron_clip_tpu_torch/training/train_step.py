"""The CLIP and GPT train steps for one process and one microbatch.

Counterpart of `megatron_clip_tpu/training/train_step.py` (`TrainState`,
`make_train_step`) without the mesh, accum-freq, teacher, CoCa and patch
dropout, which come with their slices. One CLIP step: the training forward
of both towers, the contrastive loss, backward through the attention and
LayerNorm kernels, the optimizer update in place, and the post-step clamp of
logit_scale to [0, ln 100]. One GPT step (`make_gpt_train_step`) is
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

from torch import nn

from megatron_clip_tpu_torch.config import check_remat
from megatron_clip_tpu_torch.losses import ClipLoss
from megatron_clip_tpu_torch.models.clip import CLIPModel, clamp_logit_scale
from megatron_clip_tpu_torch.models.gpt import GPTModel, gpt_loss
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
