"""Checkpoint save/load.

Counterpart of `megatron_clip_tpu/checkpoints/io.py` with the same
directory layout and files: `root/iter_{step:07d}/` per checkpoint,
`metadata.json` beside the state (the consumed-samples count that drives
the dataloader resume, megatron/training.py:1031-1038), and
`latest_checkpointed_iteration.txt`, written atomically (tmp, then
os.replace) and only after the checkpoint it names has committed. The
state is a tree of dicts, lists and tensors (the trainer's: the
parameters, the optimizer's moments and counts, the step) written with
`torch.save` to `state.pt` and read back with `torch.load(...,
weights_only=True)` onto the CPU. Orbax checkpoints of the JAX package are
not read (ROADMAP Queue A item 7, `checkpoints/torch_interop`).

`AsyncSaver` (and `save_checkpoint(block=False)`) first takes a host copy
of the state, synchronously, so that the next step cannot change what is
written; then it writes the state, the metadata and the tracker, and runs
`on_commit`, on a thread. One save is in flight at a time; a new save,
`wait()`, a load and the process's exit barrier on it.
"""
import atexit
import json
import os
import threading
from typing import Any, Callable, Optional, Tuple

import torch

TRACKER_FILENAME = "latest_checkpointed_iteration.txt"
STATE_FILENAME = "state.pt"


def _iter_dir(root: str, step: int) -> str:
    return os.path.join(root, f"iter_{step:07d}")


def _write_tracker(root: str, step: int) -> None:
    tmp = os.path.join(root, TRACKER_FILENAME + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(root, TRACKER_FILENAME))  # atomic, like
    # open_CLIP --save-most-recent tmp->replace (main.py:481-486)


def _host_copy(tree: Any) -> Any:
    """`tree` with every tensor copied to the CPU (a new tensor even for
    one that is on the CPU already)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


class AsyncSaver:
    """Checkpoint writes off the step loop (the reference hides checkpoint
    cost behind a background remote-sync process, open_CLIP
    main.py:176-196).

    - `save(..., block=False)` returns once the host copy is taken; the
      write runs on a thread.
    - Crash consistency: `metadata.json` and the tracker file are written
      only AFTER the state file, so the tracker never points at a torn
      checkpoint.
    - `on_commit` runs after the tracker write. Its exception is lost on a
      background save: the JAX package's finalize thread swallows it too
      (`megatron_clip_tpu/checkpoints/io.py:93`, a reference defect on
      record in ADVICE.md, matched for parity); a blocking save raises it.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def save(self, root: str, step: int, state: Any,
             metadata: Optional[dict] = None, block: bool = True,
             on_commit: Optional[Callable[[], None]] = None) -> str:
        with self._lock:
            self.wait()
            os.makedirs(root, exist_ok=True)
            path = os.path.abspath(_iter_dir(root, step))
            snapshot = _host_copy(state)

            def finalize():
                os.makedirs(path, exist_ok=True)
                tmp = os.path.join(path, STATE_FILENAME + ".tmp")
                torch.save(snapshot, tmp)
                os.replace(tmp, os.path.join(path, STATE_FILENAME))
                if metadata is not None:
                    with open(os.path.join(path, "metadata.json"), "w") as f:
                        json.dump(metadata, f, indent=1)
                _write_tracker(root, step)
                if on_commit is not None:
                    # post-commit work (e.g. --delete-previous-checkpoint
                    # pruning) runs only once the tracker points at this
                    # write: until then the previous checkpoint is the
                    # sole durable copy
                    on_commit()

            if block:
                finalize()
            else:
                self._thread = threading.Thread(
                    target=finalize, name=f"ckpt-finalize-{step}",
                    daemon=False)
                self._thread.start()
            return path

    def wait(self) -> None:
        """Barrier: block until any in-flight save has committed."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()


_SAVER = AsyncSaver()
atexit.register(_SAVER.wait)


def global_saver() -> AsyncSaver:
    return _SAVER


def save_checkpoint(root: str, step: int, state: Any,
                    metadata: Optional[dict] = None,
                    block: bool = True, on_commit=None) -> str:
    """Write `root/iter_XXXXXXX/` + tracker file. With block=False the write
    commits in background (see AsyncSaver); the tracker appears only after
    commit, and the next save/load/exit barriers on it. `on_commit` runs
    after the tracker write (both modes)."""
    return _SAVER.save(root, step, state, metadata, block=block,
                       on_commit=on_commit)


def latest_checkpoint_step(root: str) -> Optional[int]:
    _SAVER.wait()  # an in-flight async save may be about to move the tracker
    tracker = os.path.join(root, TRACKER_FILENAME)
    if not os.path.isfile(tracker):
        return None
    with open(tracker) as f:
        return int(f.read().strip())


def load_checkpoint(root: str, step: Optional[int] = None
                    ) -> Tuple[Any, dict, int]:
    """Restore (state, metadata, step), the state's tensors on the CPU;
    `step` None reads the tracker."""
    _SAVER.wait()
    if step is None:
        step = latest_checkpoint_step(root)
        if step is None:
            raise FileNotFoundError(f"no {TRACKER_FILENAME} under {root}")
    path = os.path.abspath(_iter_dir(root, step))
    state = torch.load(os.path.join(path, STATE_FILENAME),
                       map_location="cpu", weights_only=True)
    return state, load_checkpoint_metadata(root, step), step


def load_checkpoint_metadata(root: str, step: Optional[int] = None) -> dict:
    """Read only metadata.json of a checkpoint (no state restore)."""
    if step is None:
        step = latest_checkpoint_step(root)
        if step is None:
            raise FileNotFoundError(f"no {TRACKER_FILENAME} under {root}")
    meta_path = os.path.join(_iter_dir(root, step), "metadata.json")
    if not os.path.isfile(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)
