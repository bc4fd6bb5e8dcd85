"""Microbatch calculator with global-batch-size rampup.

A copy of `megatron_clip_tpu/training/microbatches.py` (plain Python), kept
so the port never imports the JAX package. megatron/microbatches.py:9-144
(`--rampup-batch-size start increment ramp_samples`): the global batch
grows linearly in `increment` steps as samples are consumed;
num_microbatches follows from the current global batch, the micro batch
size and the data-parallel size.
"""
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class ConstantMicroBatches:
    global_batch_size: int
    micro_batch_size: int
    data_parallel_size: int

    def __post_init__(self):
        per_step = self.micro_batch_size * self.data_parallel_size
        if self.global_batch_size % per_step:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by "
                f"micro_batch*dp = {per_step}")
        self._num = self.global_batch_size // per_step

    def update(self, consumed_samples: int):
        pass

    def get(self) -> int:
        return self._num

    def current_global_batch_size(self) -> int:
        return self.global_batch_size


class RampupMicroBatches:
    """Linear rampup: start -> final in steps of `increment` every
    ramp_samples/(num_increments) consumed samples (microbatches.py:83-144)."""

    def __init__(self, start: int, increment: int, ramp_samples: int,
                 global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        per_step = micro_batch_size * data_parallel_size
        for name, v in (("start", start), ("final", global_batch_size)):
            if v % per_step:
                raise ValueError(f"{name} batch {v} not divisible by {per_step}")
        if (global_batch_size - start) % increment:
            raise ValueError("(final - start) must be divisible by increment")
        self.start = start
        self.increment = increment
        self.final = global_batch_size
        self.per_step = per_step
        steps = (global_batch_size - start) // increment
        self.samples_per_increment = ramp_samples / max(steps, 1)
        self._current = start

    def update(self, consumed_samples: int):
        n_inc = int(consumed_samples / self.samples_per_increment)
        self._current = min(self.final, self.start + n_inc * self.increment)
        # keep divisible
        self._current -= self._current % self.per_step

    def get(self) -> int:
        return max(1, self._current // self.per_step)

    def current_global_batch_size(self) -> int:
        return self._current


def build_num_microbatches_calculator(
        global_batch_size: int, micro_batch_size: int,
        data_parallel_size: int,
        rampup_batch_size: Optional[Sequence[int]] = None):
    """rampup_batch_size: (start, increment, ramp_samples) or None —
    megatron arguments.py --rampup-batch-size."""
    if rampup_batch_size is None:
        return ConstantMicroBatches(global_batch_size, micro_batch_size,
                                    data_parallel_size)
    start, inc, samples = rampup_batch_size
    return RampupMicroBatches(start, inc, samples, global_batch_size,
                              micro_batch_size, data_parallel_size)
