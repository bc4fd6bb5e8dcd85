"""The data-parallel process group of the trainer.

Counterpart of `megatron_clip_tpu/parallel/mesh.py`'s `data` axis
(`ParallelCfg`, `build_mesh`): where the JAX trainer shards the global
batch over every device it sees (`dp = devices // (tp pp fsdp dcn)`), the
port runs one process a card, launched by torchrun, in one flat default
group:

  # one node, 8 cards
  python -m torch.distributed.run --nproc-per-node 8 \\
      -m megatron_clip_tpu_torch.pretrain_clip --batch-size 2048 ...

`init_distributed` reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK (and
MASTER_ADDR / MASTER_PORT through the `env://` init method); under torchrun
it makes the group even for one rank, so that a one-rank launch runs the
data-parallel step. Without torchrun's environment there is no group:
`world_size()` is 1, `group()` None, and every collective below returns at
once, so a one-process run is the one-process trainer as it was.

Two groups. The default group (`--dist-backend`: nccl for the card, gloo
for the CPU) carries the tensors of the step: the feature gathers, the
gradient all-reduce, the weight broadcast. A gloo group on the CPU carries
the loop's host decisions (`agree`: the SIGTERM latch, the wall-clock
budget, the end of a rank's data) and its barriers, so that they never wait
for the card; over a gloo default group it is that group.
"""
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_state = {"group": None, "control": None}


def world_size() -> int:
    """Processes in the data-parallel group (1 without one)."""
    return dist.get_world_size() if _state["group"] is not None else 1


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if _state["group"] is not None else 0


def is_main() -> bool:
    return rank() == 0


def group() -> Optional[dist.ProcessGroup]:
    """The data-parallel group, or None in a one-process run."""
    return _state["group"]


def data_parallel_size(args, world: int) -> int:
    """dp = world // (tp pp fsdp dcn), as the JAX trainer divides its
    devices (`megatron_clip_tpu/training/loop.py:139-144`). The other
    factors are 1 while their flags stay refused (`training/loop.py`
    `_REFUSED`, ROADMAP Queue A item 5)."""
    other = (args.tensor_model_parallel_size
             * args.pipeline_model_parallel_size * args.fsdp_parallel_size
             * args.dcn_data_parallel_size)
    return max(1, world // other)


def init_distributed(args, device: torch.device,
                     timeout: Optional[datetime.timedelta] = None
                     ) -> torch.device:
    """Join torchrun's group when its environment (RANK and WORLD_SIZE)
    is set; returns the device of this rank.

    Rank r runs on `device`: a CUDA device with an index stays as given
    (two ranks on one card, over gloo), plain "cuda" becomes
    cuda:LOCAL_RANK; the CPU stays the CPU. The backend is `--dist-backend`
    (open_CLIP's flag; `args.dist_backend` set by a caller on the GPT
    entry), else nccl on the card and gloo on the CPU; the init method is
    `--dist-url`, else `env://` (MASTER_ADDR, MASTER_PORT).
    `timeout`: how long a collective of either group waits for a missing
    rank before it fails (default torch's, 30 minutes on gloo); tests pass
    one well under their own deadline."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank_)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = getattr(args, "dist_backend", None) or (
        "nccl" if device.type == "cuda" else "gloo")
    wait = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=getattr(args, "dist_url", None) or "env://",
        rank=rank_, world_size=world, **wait)
    _state["group"] = dist.group.WORLD
    _state["control"] = (dist.group.WORLD if backend == "gloo"
                         else dist.new_group(backend="gloo", **wait))
    # every rank has finished connecting before any may leave: a rank that
    # refuses its flags at once and closes its sockets would otherwise cut
    # a peer's connection mid-handshake, which then fails with gloo's error
    # in place of the refusal
    dist.barrier(group=_state["control"])
    return device


def destroy() -> None:
    """Leave the groups (every rank, on every exit path of the run); a
    no-op without them."""
    if _state["group"] is None:
        return
    _state.update(group=None, control=None)
    dist.destroy_process_group()


def barrier() -> None:
    """Every rank waits here for the others, on the host."""
    if _state["group"] is not None:
        dist.barrier(group=_state["control"])


def agree(flags: Sequence[int]) -> list:
    """The maximum over ranks of each of `flags` (host ints), one
    collective on the host group: a decision one rank takes (SIGTERM, the
    wall-clock budget, the end of its data) becomes every rank's at the
    same step."""
    if _state["group"] is None:
        return [int(f) for f in flags]
    t = torch.tensor([int(f) for f in flags], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_state["control"])
    return t.tolist()


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` as rank 0 holds it, in
    place, on the tensors' own device."""
    if _state["group"] is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def rank_rows(batch: int, microbatches: int, rank_: int,
              world: int) -> np.ndarray:
    """The rows of a global batch of `batch` that rank `rank_` of `world`
    holds, in the order its step takes them. The JAX step splits the
    global batch into `microbatches` blocks (`reshape(M, B/M)`) and the
    mesh shards each block over `data`, so in block i the rank holds global
    rows [i B/M + r B/(M W), i B/M + (r+1) B/(M W)); the local batch is
    those shares, block after block, and its own M chunks are the blocks'
    shares. With M = 1 it is the slice [r B/W, (r+1) B/W)."""
    if batch % (microbatches * world):
        raise ValueError(
            f"--batch-size {batch} does not split into {microbatches} "
            f"microbatches on each of {world} ranks: it must be a multiple "
            f"of {microbatches} x {world} = {microbatches * world}")
    block = batch // microbatches
    share = block // world
    return np.concatenate([np.arange(i * block + rank_ * share,
                                     i * block + (rank_ + 1) * share)
                           for i in range(microbatches)])
