"""Parameter sharding over the tensor and fsdp axes.

Counterpart of `megatron_clip_tpu/parallel/sharding.py`
(`transformer_block_specs`, `clip_param_specs`) and
`megatron_clip_tpu/models/gpt.py::gpt_param_specs`: the same rules, as a
table over the port's parameter names, each a spec with one axis name (or
None) a dimension:

  attn.wqkv, mlp.w1      (fsdp, tensor)    column-parallel
  attn.bqkv, mlp.b1      (tensor,)
  attn.wo, mlp.w2        (tensor, fsdp)    row-parallel
  tok_embed              (tensor, fsdp)    vocab rows over tensor
  lm_head                (fsdp, tensor)
  CLIP patch_embed.w     (None, fsdp); proj, proj.w (fsdp, None)
  the rest               replicated

Where JAX splits a dimension into contiguous blocks, the port splits the
packed projections on their segments, as their columns are laid out:
wqkv and bqkv are [q | k | v] (`ops/attention.py`), so tensor rank t
takes heads [t H/tp, (t+1) H/tp) of q and kv heads [t Hkv/tp, ...) of k
and v; the swiglu w1 and b1 are [value | gate] (`ops/activations.py`), and
rank t takes the matching halves of each. The fsdp axis splits its
dimension into contiguous blocks, of the tensor rank's piece.

A sharded model (`shard_model`) holds only this rank's shard of each
parameter, under the parameter's own name. A block's weights stay split
over the tensor axis in its products (`nn/transformer.py`,
`parallel/collectives.TensorRegion`); every other use gathers what it
needs first (`full`): the fsdp axis always, the tensor axis for the
embedding and the lm head, gathered whole for the lookup and for the fused
cross entropy, which XLA too feeds whole. The gradients come back as the
gathers' reduce-scatters, and `reduction_plan` says which groups each
shard's gradient is still summed over. `split_state` and `gather_state`
carry a whole state (a checkpoint's, the JAX package's through
`bridge.py`) to one rank's shards and back; `whole_state` gathers a
checkpoint's onto rank 0's host alone, so that no rank's device holds more
than its shards when it saves.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from megatron_clip_tpu_torch.parallel import collectives, mesh
from megatron_clip_tpu_torch.parallel.mesh import Layout

FSDP, TENSOR = "fsdp", "tensor"


def transformer_block_specs(name: str, ndim: int) -> tuple:
    """The spec of one parameter of a transformer block, by its name
    within the block (the JAX rules' `attn/wqkv` is `attn.wqkv` here)."""
    if name.endswith(("attn.wqkv", "mlp.w1")):
        return (FSDP, TENSOR)
    if name.endswith(("attn.bqkv", "mlp.b1")):
        return (TENSOR,)
    if name.endswith(("attn.wo", "mlp.w2")):
        return (TENSOR, FSDP)
    return (None,) * ndim


def _in_blocks(name: str) -> bool:
    return "blocks" in name.split(".")


def clip_param_specs(params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Specs of a CLIP model's parameters (both towers, logit scale)."""
    def rule(name, p):
        if _in_blocks(name):
            return transformer_block_specs(name, p.dim())
        if name.endswith("tok_embed"):
            return (TENSOR, FSDP)
        if "patch_embed" in name and p.dim() == 2:
            return (None, FSDP)
        if name.endswith(("proj.w", "proj")) and p.dim() == 2:
            return (FSDP, None)
        return (None,) * p.dim()
    return {n: rule(n, p) for n, p in params.items()}


def gpt_param_specs(params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Specs of a GPT's parameters."""
    def rule(name, p):
        if _in_blocks(name):
            return transformer_block_specs(name, p.dim())
        if name.endswith("tok_embed"):
            return (TENSOR, FSDP)
        if name.endswith("lm_head"):
            return (FSDP, TENSOR)
        return (None,) * p.dim()
    return {n: rule(n, p) for n, p in params.items()}


@dataclass(frozen=True)
class Placement:
    """How one parameter lies on the ranks: its tensor dimension (None:
    replicated over the tensor axis) and that dimension's segments (each
    split over the tensor ranks in turn), its fsdp dimension, and whether
    its uses take it split over the tensor axis (a block's products)."""
    tensor_dim: Optional[int]
    segments: Tuple[int, ...]
    fsdp_dim: Optional[int]
    local: bool

    def replicas(self, layout: Layout) -> int:
        """Ranks of one data index holding the same elements."""
        return ((layout.tp if self.tensor_dim is None else 1)
                * (layout.fsdp if self.fsdp_dim is None else 1))


def _segments(name: str, p: torch.Tensor, dim: int, cfg) -> Tuple[int, ...]:
    """The segments of `p`'s tensor dimension (see the module's note)."""
    n = p.shape[dim]
    if cfg is None:
        return (n,)
    if name.endswith(("attn.wqkv", "attn.bqkv")):
        heads = cfg.heads
        hkv = cfg.kv_heads or heads
        d = n // (heads + 2 * hkv)
        return (heads * d, hkv * d, hkv * d)
    if name.endswith(("mlp.w1", "mlp.b1")) and cfg.act == "swiglu":
        return (n // 2, n // 2)
    return (n,)


def placements(model: nn.Module, specs: Dict[str, tuple],
               layout: Layout) -> Dict[str, Placement]:
    """Each parameter's `Placement` under `layout`; raises ValueError where
    a size does not divide (the heads, kv heads, vocab or a width)."""
    out = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        tdim = spec.index(TENSOR) if TENSOR in spec else None
        fdim = spec.index(FSDP) if FSDP in spec else None
        tdim = tdim if layout.tp > 1 else None
        fdim = fdim if layout.fsdp > 1 else None
        segs = ()
        if tdim is not None:
            cfg = _block_cfg(model, name) if _in_blocks(name) else None
            segs = _segments(name, p, tdim, cfg)
            if name.endswith(("attn.wqkv", "attn.bqkv")) and (
                    cfg.heads % layout.tp
                    or (cfg.kv_heads or cfg.heads) % layout.tp):
                raise ValueError(
                    f"{name}: {cfg.heads} heads and "
                    f"{cfg.kv_heads or cfg.heads} kv heads must each split "
                    f"over --tensor-model-parallel-size {layout.tp}")
            if any(s % layout.tp for s in segs):
                raise ValueError(f"{name} {tuple(p.shape)}: dimension "
                                 f"{tdim} does not split over "
                                 f"--tensor-model-parallel-size {layout.tp}")
        if fdim is not None and (p.shape[fdim] // (
                layout.tp if fdim == tdim else 1)) % layout.fsdp:
            raise ValueError(f"{name} {tuple(p.shape)}: dimension {fdim} "
                             f"does not split over --fsdp-parallel-size "
                             f"{layout.fsdp}")
        out[name] = Placement(tdim, segs, fdim, _in_blocks(name))
    return out


def _block_cfg(model: nn.Module, name: str):
    """The TransformerCfg of the block that holds parameter `name`."""
    parts = name.split(".")
    i = parts.index("blocks")
    return model.get_submodule(".".join(parts[:i + 2])).cfg


def _split(t: torch.Tensor, dim: int, segments, parts: int,
           index: int) -> torch.Tensor:
    segs = t.split(list(segments), dim) if segments else (t,)
    return torch.cat([s.chunk(parts, dim)[index] for s in segs], dim)


def _merge(pieces: list, dim: int, segments) -> torch.Tensor:
    parts = len(pieces)
    local = [s // parts for s in segments] if segments else None
    per = [p.split(local, dim) if local else (p,) for p in pieces]
    return torch.cat([torch.cat([per[i][j] for i in range(parts)], dim)
                      for j in range(len(per[0]))], dim)


def split_tensor(t: torch.Tensor, pl: Placement,
                 layout: Layout) -> torch.Tensor:
    """This rank's shard of the whole tensor `t`."""
    if pl.tensor_dim is not None:
        t = _split(t, pl.tensor_dim, pl.segments, layout.tp, layout.t)
    if pl.fsdp_dim is not None:
        t = t.chunk(layout.fsdp, pl.fsdp_dim)[layout.f]
    return t.contiguous()


def gather_tensor(shard: torch.Tensor, pl: Placement,
                  layout: Layout) -> torch.Tensor:
    """The whole tensor from every rank's shard (a collective over the
    fsdp and tensor groups)."""
    t = shard.detach()
    if pl.fsdp_dim is not None:
        t = collectives.all_gather(t, layout.fsdp_group, pl.fsdp_dim)
    if pl.tensor_dim is not None:
        pieces = collectives.all_gather(
            t.unsqueeze(0), layout.tensor, 0).unbind(0)
        t = _merge(list(pieces), pl.tensor_dim, pl.segments)
    return t


def split_state(whole: Dict[str, torch.Tensor],
                pls: Dict[str, Placement],
                layout: Layout) -> Dict[str, torch.Tensor]:
    """One rank's shards of a whole state by parameter name (parameters,
    or an optimizer's moments of them)."""
    return {n: split_tensor(t, pls[n], layout) for n, t in whole.items()}


def gather_state(shards: Dict[str, torch.Tensor],
                 pls: Dict[str, Placement],
                 layout: Layout) -> Dict[str, torch.Tensor]:
    """The whole state from every rank's shards (every rank calls it, in
    the same order)."""
    return {n: gather_tensor(t, pls[n], layout) for n, t in shards.items()}


def gather_to_main(shard: torch.Tensor, pl: Placement,
                   layout: Layout) -> Optional[torch.Tensor]:
    """The whole tensor on rank 0's host from every rank's shard (every
    rank calls it), None on the other ranks: each rank sends a host copy
    of its shard over the host group (`mesh.control`), and rank 0 puts
    the shards of data index 0 together. No device holds more than its
    shard."""
    host = shard.detach().cpu()
    world = dist.get_world_size()
    main = dist.get_rank() == 0
    got = [torch.empty_like(host) for _ in range(world)] if main else None
    dist.gather(host, got, dst=0, group=mesh.control())
    if not main:
        return None
    pieces = []
    for t in range(layout.tp):
        mine = [got[mesh.rank_of(0, f, t, layout.fsdp, layout.tp)]
                for f in range(layout.fsdp)]
        pieces.append(mine[0] if pl.fsdp_dim is None
                      else torch.cat(mine, pl.fsdp_dim))
    return (pieces[0] if pl.tensor_dim is None
            else _merge(pieces, pl.tensor_dim, pl.segments))


def whole_state(model: nn.Module, state: Dict[str, torch.Tensor]
                ) -> Optional[Dict[str, torch.Tensor]]:
    """`state` by parameter name (the parameters, or moments of them): of
    a sharded model, gathered whole onto rank 0's host (`gather_to_main`,
    every rank calls it; None on the other ranks), else itself."""
    pls = getattr(model, "placements", None)
    if pls is None:
        return state
    whole = {n: gather_to_main(t, pls[n], model.layout)
             for n, t in state.items()}
    return whole if dist.get_rank() == 0 else None


def rank_state(model: nn.Module,
               state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's shards of the whole `state` for a sharded model, else
    `state` itself."""
    pls = getattr(model, "placements", None)
    return state if pls is None else split_state(state, pls, model.layout)


def _owner(model: nn.Module, name: str):
    mod, _, attr = name.rpartition(".")
    return (model.get_submodule(mod) if mod else model), attr


def shard_model(model: nn.Module, specs: Dict[str, tuple],
                layout: Layout) -> Dict[str, Placement]:
    """Replace each parameter of `model` (whole, the same on every rank)
    by this rank's shard under the same name, and record on its module
    how a use gathers it (`full`); `model.layout` and each block's
    `layout` become `layout`. Returns the placements."""
    pls = placements(model, specs, layout)
    for name, p in list(model.named_parameters()):
        pl = pls[name]
        owner, attr = _owner(model, name)
        shard = nn.Parameter(split_tensor(p.detach(), pl, layout),
                             requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[attr] = shard
        else:
            setattr(owner, attr, shard)
        gathers = []
        if pl.fsdp_dim is not None:
            gathers.append((pl.fsdp_dim, layout.fsdp_group))
        if pl.tensor_dim is not None and not pl.local:
            gathers.append((pl.tensor_dim, layout.tensor))
        if gathers:
            owner.__dict__.setdefault("_gathers", {})[attr] = gathers
    for module in model.modules():
        if hasattr(module, "layout"):
            module.layout = layout
    model.layout, model.placements = layout, pls
    return pls


def full(module: nn.Module, attr: str,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Parameter `attr` of `module` as its uses take it: the parameter
    itself in a model that is not sharded (or one not split), else its
    shards gathered (in `dtype`, default the parameter's), the gradient
    reduce-scattered back onto the shard."""
    p = (module[attr] if isinstance(module, nn.ParameterDict)
         else getattr(module, attr))
    gathers = module.__dict__.get("_gathers", {}).get(attr)
    if not gathers:
        return p
    for dim, group in gathers:
        p = collectives.gather_param(p, group, dim, dtype)
    return p


def _tensor_partial(name: str, pl: Placement, layout: Layout) -> bool:
    """Whether a rank's gradient of `name` holds only its tensor rank's
    share: a parameter whole on every tensor rank whose use sees the
    rank's own rows, under sequence parallelism (the norms, the
    row-parallel biases, the final norm) and always at the embedding's
    slice (`pos_embed`)."""
    if layout.tp == 1 or pl.tensor_dim is not None:
        return False
    return layout.sequence_parallel or name.endswith("pos_embed")


def reduction_plan(model: nn.Module) -> Optional[Dict[str, tuple]]:
    """The groups each shard's gradient is summed over after the backward
    (the gathers' reduce-scatters have summed their axes already): data
    for an fsdp shard, else the batch axis (data x fsdp), and the tensor
    group first where a rank holds a partial sum (`_tensor_partial`).
    None for a model that is not sharded."""
    pls = getattr(model, "placements", None)
    if pls is None:
        return None
    layout, plan = model.layout, {}
    for name, pl in pls.items():
        groups = [layout.tensor] if _tensor_partial(name, pl, layout) else []
        groups.append(layout.data if pl.fsdp_dim is not None
                      else layout.batch)
        plan[name] = tuple(g for g in groups if g is not None)
    return plan


def norm_weights(model: nn.Module) -> Optional[Dict[str, float]]:
    """1 / the replicas of each shard among the ranks of one data index
    (`Layout.model`): summed over them, a global norm counts every element
    once. None for a model that is not sharded."""
    pls = getattr(model, "placements", None)
    if pls is None:
        return None
    return {n: 1.0 / pl.replicas(model.layout) for n, pl in pls.items()}
