"""SIGTERM latch of the training loop.

A copy of `megatron_clip_tpu/training/signals.py` (plain Python), kept so
the port never imports the JAX package. megatron's DistributedSignalHandler
(dist_signal_handler.py:50-81 + training.py:815-821) latches SIGTERM, the
loop saves a checkpoint and exits cleanly. Here the latch is a context
manager so the previous handler is restored on EVERY exit path, including
exceptions — a leaked handler in a long-lived host process (tests, a server
embedding a training run) would make the process unkillable by SIGTERM.
`agreed_stop` turns the latch and the wall-clock budget into one decision
of every rank of a data-parallel run (the CLIP and the GPT trainers').
"""
import contextlib
import signal
import time
from typing import Optional, Tuple

from megatron_clip_tpu_torch.parallel import mesh


@contextlib.contextmanager
def sigterm_latch():
    """Yields {"flag": bool}; the flag flips when SIGTERM arrives."""
    term = {"flag": False}
    prev = None

    def _on_term(signum, frame):
        term["flag"] = True

    try:
        prev = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not in the main thread (tests)
    try:
        yield term
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def agreed_stop(term: dict, run_t0: float,
                exit_duration_mins: Optional[float]) -> Tuple[bool, bool]:
    """(stop, out_of_time), the same on every rank of the data-parallel
    group, in one host collective (`parallel.mesh.agree`): SIGTERM latched
    on any rank (`term`, from `sigterm_latch`), and rank 0's clock past
    megatron's --exit-duration-in-mins since `run_t0` (perf_counter). In a
    one-process run, this process's own."""
    stop, out_of_time = mesh.agree([
        term["flag"], mesh.is_main() and exit_duration_mins is not None
        and time.perf_counter() - run_t0 > exit_duration_mins * 60])
    return bool(stop), bool(out_of_time)
