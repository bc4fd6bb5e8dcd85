"""Training: the optimizer, the learning-rate schedule and the train step."""
from megatron_clip_tpu_torch.training.optim import (  # noqa: F401
    cosine_lr, make_optimizer)
from megatron_clip_tpu_torch.training.train_step import (  # noqa: F401
    TrainState, make_train_step)
