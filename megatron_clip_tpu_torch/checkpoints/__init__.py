"""Checkpoint save, load and pruning of the trainer's state."""
from megatron_clip_tpu_torch.checkpoints.io import (  # noqa: F401
    TRACKER_FILENAME, global_saver, latest_checkpoint_step, load_checkpoint,
    load_checkpoint_metadata, save_checkpoint)
