"""SIGTERM latch of the training loop.

A copy of `megatron_clip_tpu/training/signals.py` (plain Python), kept so
the port never imports the JAX package. megatron's DistributedSignalHandler
(dist_signal_handler.py:50-81 + training.py:815-821) latches SIGTERM, the
loop saves a checkpoint and exits cleanly. Here the latch is a context
manager so the previous handler is restored on EVERY exit path, including
exceptions — a leaked handler in a long-lived host process (tests, a server
embedding a training run) would make the process unkillable by SIGTERM.
"""
import contextlib
import signal


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
