"""The process groups of the trainers: data, fsdp and tensor parallelism.

Counterpart of `megatron_clip_tpu/parallel/mesh.py` (`ParallelCfg`,
`build_mesh`) for its `data`, `fsdp` and `tensor` axes: where the JAX
trainer lays every device it sees on a mesh (`dp = devices // (tp pp fsdp
dcn)`), the port runs one process a card, launched by torchrun, and
numbers the ranks in the JAX mesh's order (data, fsdp, stage, context,
tensor), tensor fastest: rank = (d fsdp + f) tp + t (`Layout`). Each rank
joins the groups of its axes: `tensor` (the tp ranks of one (d, f), which
hold the same rows and split the weights), `fsdp` (the fsdp ranks of one
(d, t)), `batch` (the dp fsdp ranks of one t: data x fsdp, over which the
JAX `batch_spec` shards the batch; each holds rows of its own), `data`
(one (f, t)) and `model` (the fsdp tp ranks of one d, which hold one copy
of the weights between them). A one-process run, or tp = fsdp = 1, is the
data-parallel layout of one flat group:

  # one node, 8 cards
  python -m torch.distributed.run --nproc-per-node 8 \\
      -m megatron_clip_tpu_torch.pretrain_clip --batch-size 2048 ...

`init_distributed` reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK (and
MASTER_ADDR / MASTER_PORT through the `env://` init method); under torchrun
it makes the group even for one rank, so that a one-rank launch runs the
data-parallel step. Without torchrun's environment there is no group:
`world_size()` is 1, `group()` None, and every collective below returns at
once, so a one-process run is the one-process trainer as it was.

The default group (`--dist-backend`: nccl for the card, gloo for the CPU)
and the layout's groups, of its backend, carry the tensors of the step: the
feature gathers, the gradient reductions, the weight broadcast, the tensor
and sequence parallelism's collectives (`parallel/collectives.py`). A gloo
group on the CPU carries the loop's host decisions (`agree`: the SIGTERM
latch, the wall-clock budget, the end of a rank's data) and its barriers,
so that they never wait for the card; over a gloo default group it is that
group.
"""
import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from megatron_clip_tpu_torch.ops.dropout import RankSeed

@dataclass(frozen=True)
class Layout:
    """dp x fsdp x tp ranks, this rank at (d, f, t), and its groups (None
    for an axis of one rank, `dist.group.WORLD` for one of every rank).
    `sequence_parallel`: megatron --sequence-parallel, the activations
    between the tensor-parallel products sharded on the sequence over the
    tensor group."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    d: int = 0
    f: int = 0
    t: int = 0
    sequence_parallel: bool = False
    tensor: Optional[dist.ProcessGroup] = None
    fsdp_group: Optional[dist.ProcessGroup] = None
    batch: Optional[dist.ProcessGroup] = None
    data: Optional[dist.ProcessGroup] = None
    model: Optional[dist.ProcessGroup] = None

    @property
    def batch_rank(self) -> int:
        """This rank's index on the batch axis (data x fsdp)."""
        return self.d * self.fsdp + self.f

    @property
    def batch_ranks(self) -> int:
        """Ranks that hold rows of their own: dp fsdp."""
        return self.dp * self.fsdp

    @property
    def sharded(self) -> bool:
        """Whether the weights are split (tp or fsdp above 1)."""
        return self.tp * self.fsdp > 1


ONE = Layout()

_state = {"group": None, "control": None, "layout": ONE}


def layout() -> Layout:
    """This process's layout (`ONE` without a group)."""
    return _state["layout"]


def rank_of(d: int, f: int, t: int, fsdp: int, tp: int) -> int:
    """The rank at mesh coordinates (d, f, t): the JAX mesh's device order,
    tensor fastest (`megatron_clip_tpu/parallel/mesh.py::build_mesh`)."""
    return (d * fsdp + f) * tp + t


def layout_sizes(args, world: int) -> tuple:
    """(dp, fsdp, tp) of `world` ranks under the flags'
    --fsdp-parallel-size and --tensor-model-parallel-size; dp = world /
    (tp fsdp), as `megatron_clip_tpu/training/workload.py::
    build_workload_mesh` divides its devices. A world they do not divide
    exits."""
    tp = getattr(args, "tensor_model_parallel_size", 1) or 1
    fsdp = getattr(args, "fsdp_parallel_size", 1) or 1
    if world % (tp * fsdp):
        raise SystemExit(
            f"--tensor-model-parallel-size {tp} x --fsdp-parallel-size "
            f"{fsdp} needs a multiple of {tp * fsdp} ranks (a torchrun "
            f"launch of that many processes); this launch has {world}")
    return world // (tp * fsdp), fsdp, tp


def axis_ranks(dp: int, fsdp: int, tp: int) -> dict:
    """The ranks of every group of each axis (`Layout`'s group fields), in
    the order the groups are made."""
    return {
        "tensor": [[rank_of(d, f, t, fsdp, tp) for t in range(tp)]
                   for d in range(dp) for f in range(fsdp)],
        "fsdp_group": [[rank_of(d, f, t, fsdp, tp) for f in range(fsdp)]
                       for d in range(dp) for t in range(tp)],
        "batch": [[rank_of(d, f, t, fsdp, tp) for d in range(dp)
                   for f in range(fsdp)] for t in range(tp)],
        "data": [[rank_of(d, f, t, fsdp, tp) for d in range(dp)]
                 for f in range(fsdp) for t in range(tp)],
        "model": [[rank_of(d, f, t, fsdp, tp) for f in range(fsdp)
                   for t in range(tp)] for d in range(dp)]}


def _groups(dp: int, fsdp: int, tp: int, rank_: int, wait: dict) -> dict:
    """Every rank makes every group of every axis, in one order (as
    `dist.new_group` requires), once for ranks two axes share, and keeps
    those it belongs to; only a group's members wait for its creation."""
    world = dp * fsdp * tp
    made, mine = {}, {}
    for axis, groups in axis_ranks(dp, fsdp, tp).items():
        for ranks in groups:
            key = tuple(ranks)
            if key not in made:
                made[key] = (dist.group.WORLD if len(ranks) == world
                             else None if len(ranks) == 1
                             else dist.new_group(
                                 ranks, use_local_synchronization=True,
                                 **wait))
            if rank_ in ranks:
                mine[axis] = made[key]
    return mine


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
    one well under their own deadline.

    The layout (`layout()`) follows the flags on `args`
    (--tensor-model-parallel-size, --fsdp-parallel-size,
    --sequence-parallel); tp or fsdp above 1 without torchrun's
    environment, or a world they do not divide, exits."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        layout_sizes(args, 1)
        return device
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dp, fsdp, tp = layout_sizes(args, world)
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
    _state["layout"] = Layout(
        dp=dp, fsdp=fsdp, tp=tp, d=rank_ // (fsdp * tp),
        f=rank_ // tp % fsdp, t=rank_ % tp,
        sequence_parallel=bool(getattr(args, "sequence_parallel", False))
        and tp > 1, **_groups(dp, fsdp, tp, rank_, wait))
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
    _state.update(group=None, control=None, layout=ONE)
    dist.destroy_process_group()


def control() -> Optional[dist.ProcessGroup]:
    """The gloo group of every rank on the host (None without a group)."""
    return _state["control"]


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


def batch_rank() -> int:
    """This rank's index among the ranks that hold rows of their own."""
    return _state["layout"].batch_rank


def batch_ranks() -> int:
    """How many ranks hold rows of their own (1 without a group)."""
    return _state["layout"].batch_ranks


def rank_seed(seed: Optional[int], rows: int):
    """The dropout seed `seed` of a step (or microbatch) placed on this
    rank, which holds `rows` consecutive rows of it from its batch index
    on (`ops/dropout.RankSeed`); `seed` itself with one rank, or None."""
    lay = _state["layout"]
    if seed is None or lay.batch_ranks * lay.tp == 1:
        return seed
    return RankSeed(seed, row_base=lay.batch_rank * rows, tp=lay.tp,
                    tp_rank=lay.t, batch_rank=lay.batch_rank)


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` as rank 0 holds it, in
    place, on the tensors' own device: one broadcast of a flat copy a dtype
    and device."""
    if _state["group"] is None:
        return
    by_kind = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in by_kind.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            torch._foreach_copy_(ts, [part.view_as(t) for part, t in zip(
                flat.split([t.numel() for t in ts]), ts)])


def rank_rows(batch: int, microbatches: int, rank_: int,
              world: int) -> np.ndarray:
    """The rows of a global batch of `batch` that rank `rank_` of `world`
    holds, in the order its step takes them. The JAX step splits the
    global batch into `microbatches` blocks (`reshape(M, B/M)`) and the
    mesh shards each block over `data`, so in block i the rank holds global
    rows [i B/M + r B/(M W), i B/M + (r+1) B/(M W)); the local batch is
    those shares, block after block, and its own M chunks are the blocks'
    shares. With M = 1 it is the slice [r B/W, (r+1) B/W). Over a layout,
    r and W are the batch axis's (`batch_rank`, `batch_ranks`): the
    tensor-parallel ranks of one (d, f) hold the same rows."""
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
