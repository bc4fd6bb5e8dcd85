"""Training: the optimizer, the learning-rate schedule and the train step."""
from megatron_clip_tpu_torch.training.optim import (  # noqa: F401
    const_lr, const_lr_cooldown, constant_lr, cosine_lr, make_gpt_optimizer,
    make_optimizer)
from megatron_clip_tpu_torch.training.train_step import (  # noqa: F401
    TrainState, make_gpt_train_step, make_train_step)
