"""The collectives of tensor, sequence and fully sharded data parallelism.

The JAX package expresses these axes as weight and activation shardings,
and XLA's partitioner inserts the collectives
(`megatron_clip_tpu/parallel/sharding.py:1-22`): megatron's f and g
regions around the tensor-parallel products (mappings.py), the all-gather
and reduce-scatter of sequence parallelism, and FSDP's gather of a weight
before its use and the reduce-scatter of its gradient. The port writes
them as `torch.autograd.Function`s, each with its transpose as backward:

  function              forward                 backward
  copy_to_tensor        identity                all-reduce (tensor)
  reduce_from_tensor    all-reduce (tensor)     identity
  gather_seq            all-gather on S         reduce-scatter on S
  gather_seq, whole     all-gather on S         this rank's slice
  scatter_seq           this rank's slice       all-gather on S
  reduce_scatter_seq    reduce-scatter on S     all-gather on S
  gather_param          all-gather on a dim     reduce-scatter (fp32)

`TensorRegion` puts them around a column-parallel product and a
row-parallel one: without sequence parallelism the activations between
blocks are whole on every tensor-parallel rank (copy in, all-reduce out);
with it each rank holds S/tp of the rows (all-gather in, reduce-scatter
out).

Every collective is the backend's own: nccl's on the card, gloo's on the
CPU and for several ranks on one card (NCCL takes one rank a card), where
gloo runs `all_gather_into_tensor` and `reduce_scatter_tensor` on CUDA
tensors too (PyTorch 2.11), staging them through the host. No collective
writes into its input.
"""
from typing import Optional

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated on `dim`, in rank order."""
    world = size(group)
    if world == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks of `t`, this rank's 1/W of it on `dim`."""
    world = size(group)
    if world == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of `t`, in place."""
    if size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def own_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's 1/W of `t` on `dim`."""
    world = size(group)
    if world == 1:
        return t
    return t.chunk(world, dim=dim)[rank(group)].contiguous()


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, whole_grad):
        ctx.group, ctx.dim, ctx.whole_grad = group, dim, whole_grad
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole_grad:  # every rank holds the whole gradient
            return own_slice(g, ctx.group, ctx.dim), None, None, None
        return reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, shard.dtype
        return all_gather(shard.detach().to(dtype), group, dim)

    @staticmethod
    def backward(ctx, g):
        # summed in the parameter's dtype, as one process's gradient is
        # cast to it before its microbatches add
        return (reduce_scatter(g.to(ctx.dtype), ctx.group, ctx.dim), None,
                None, None)


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Into a tensor-parallel region: x as it is; its gradient summed over
    the tensor group (megatron's f)."""
    return x if size(group) == 1 else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Out of a tensor-parallel region: the partial results summed over the
    tensor group (megatron's g)."""
    return x if size(group) == 1 else _ReduceFromTensor.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int = 1,
               whole_grad: bool = False) -> torch.Tensor:
    """The ranks' rows gathered on `dim` (the sequence); the gradient
    reduce-scattered back, or with `whole_grad` (the gathered activation's
    gradient is whole on every rank) each rank's own slice of it."""
    if size(group) == 1:
        return x
    return _GatherSeq.apply(x, group, dim, whole_grad)


def scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's rows of an activation every rank holds whole; the
    gradient all-gathered."""
    return x if size(group) == 1 else _ScatterSeq.apply(x, group, dim)


def reduce_scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Partial results summed over the group, each rank keeping its rows;
    the gradient all-gathered."""
    return x if size(group) == 1 else _ReduceScatterSeq.apply(x, group, dim)


def gather_param(shard: torch.Tensor, group, dim: int,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A weight's shards gathered on `dim` in `dtype` (default the
    shard's); the gradient reduce-scattered onto the shard in the shard's
    dtype."""
    dtype = dtype or shard.dtype
    if size(group) == 1:
        return shard.to(dtype)
    return _GatherParam.apply(shard, group, dim, dtype)


class TensorRegion:
    """The collectives around a block's tensor-parallel products over
    `group`: `enter` before a column-parallel product (its input whole on
    every rank), `leave` after a row-parallel one (its partial sums
    reduced); with `sequence_parallel` the activations outside hold this
    rank's S/tp rows (on dim 1)."""

    def __init__(self, group, sequence_parallel: bool):
        self.group, self.sequence_parallel = group, sequence_parallel
        self.size, self.rank = size(group), rank(group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.sequence_parallel:
            return gather_seq(x, self.group)
        return copy_to_tensor(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        if self.sequence_parallel:
            return reduce_scatter_seq(x, self.group)
        return reduce_from_tensor(x, self.group)
