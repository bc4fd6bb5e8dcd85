"""Pre-LN transformer stack as nn.Modules.

Counterpart of `megatron_clip_tpu/nn/transformer.py`. The JAX package stacks
each block's leaves on a leading layer axis and runs them with `lax.scan`;
here each layer is its own `ResidualBlock` in a `Transformer` (a ModuleList),
run by a Python loop. Parameter names mirror the JAX pytree
(`blocks.{i}.attn.wqkv`, `blocks.{i}.ln_1.scale`, ...) and weights keep its
[in, out] layout, applied as `x @ w` (see `bridge.py`).

Options of megatron's GPT (`cfg.norm`, `cfg.act`, `cfg.rope`,
`cfg.kv_heads`): RMSNorm blocks carry `scale` only; the swiglu `w1` is
[W, 2 * mlp_hidden] (value, then gate) and `b1` [2 * mlp_hidden]; the
packed `wqkv` is [W, (heads + 2 kv_heads) D]; the rotary tables are built
once per forward of the stack (at per-row positions when `position_ids`
are given) and passed to every block, as is an additive attention `bias`.

Initialisation follows open_CLIP's scheme: attn_std = width**-0.5,
proj_std = width**-0.5 * (2*layers)**-0.5, fc_std = (2*width)**-0.5, zero
biases; with `cfg.init_std` set, megatron's: attn_std = fc_std = init_std,
proj_std = init_std / sqrt(2*layers). Without `cfg.use_bias` the linears
have no biases. Each block's forward is ln_1 -> attn -> (+) -> ln_2 -> mlp
-> (+).

Dropout (`apply_block`'s three sites, megatron's): attention probabilities
in the attention kernels, and hidden dropout of the attention's and the
MLP's output before each residual add (`ops/dropout.py`), active when a
seed reaches the stack (training). Every site draws from the step's seed
and its own offset (`site_offset(layer, site)`), where the JAX package
splits its key per layer and site.

Activation recompute (the `remat` the stack is called with, which the
train step resolves from its argument or `cfg.remat`; megatron
--recompute-granularity), with `torch.utils.checkpoint` (non-reentrant) in
the place of the JAX package's `jax.checkpoint` policies:
- "full": the whole block is recomputed in the backward from its input,
  the attention kernels included (`jax.checkpoint(block_fn)`).
- "selective": the outputs of the matrix products with no batch dims
  (every projection) are saved, and so are the attention kernels'
  residuals (flash's out and lse, the fused route's row statistics); the
  norms, activations and dropout are recomputed (the JAX package's
  `_selective_policy`).
  The attention runs outside the recomputed segments, as its ctypes
  launches cannot be seen by a per-op policy: the segments are ln_1 ->
  qkv projection, and output projection -> ... -> residual add, each
  under `create_selective_checkpoint_contexts` saving aten.mm /
  aten.addmm (`multi_head_attention`'s `segment`).
- "mlp": selective without the MLP up-projection: its output ([*, 4W],
  [*, 2 ffn] with swiglu) is recomputed in the backward from ln_2's
  output, every other product's output is saved (the JAX package's
  `_dots_except_mlp_up_policy` with flash's residuals). The JAX package
  tells the up-projection by its weight's shape [W, mlp_in], as a nested
  checkpoint did not work there; here the segments' policy tells it the
  same way (`_recompute_up_projection`), one product of
  [W, mlp_in] a block, so the two agree on what is saved.
- "none": autograd keeps what it keeps.
Dropout replays the same bits in a recompute, as its seeds are inputs.

Tensor and sequence parallelism and FSDP (a block of a sharded model,
`parallel/sharding.shard_model`, whose `layout` has tp or fsdp above 1):
the block first gathers its fsdp-sharded weights (`weights`), in the
compute dtype for the matrices, then runs its products on the tensor
rank's columns of wqkv and w1 (its heads, its halves of the swiglu) and
rows of wo and w2, inside a `TensorRegion` (`parallel/collectives.py`):
the row-parallel partial sums are reduced, then bo and b2 added once.
Without sequence parallelism the residual stream is whole on every tensor
rank and its hidden dropout draws the same mask there; with it each rank
holds S/tp of its rows, the norms, residual adds and dropout run on those,
and the stack's rotary tables are built for the whole sequence.
"""
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from megatron_clip_tpu_torch.config import TransformerCfg
from megatron_clip_tpu_torch.ops import (get_act, layer_norm,
                                         multi_head_attention, rms_norm,
                                         swiglu)
from megatron_clip_tpu_torch.ops.dense import dense
from megatron_clip_tpu_torch.ops.dropout import dropout, site_offset
from megatron_clip_tpu_torch.ops.rope import rope_cos_sin
from megatron_clip_tpu_torch.parallel.collectives import TensorRegion
from megatron_clip_tpu_torch.parallel.sharding import full

_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# selective recompute: a segment that keeps the outputs of the
# projections' products
_selective = functools.partial(
    checkpoint, use_reentrant=False,
    context_fn=functools.partial(create_selective_checkpoint_contexts,
                                 list(_PRODUCTS)))


def _recompute_up_projection(up_shape):
    """A selective-checkpoint policy that saves the output of every matrix
    product but those whose weight (the last operand) is `up_shape`."""
    def policy(ctx, op, *args, **kwargs):
        if op in _PRODUCTS:
            if tuple(args[-1].shape) == up_shape:
                return CheckpointPolicy.PREFER_RECOMPUTE
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


@functools.lru_cache()
def _mlp_segment(up_shape):
    """remat="mlp"'s segment: `_selective` without the up-projection."""
    return functools.partial(
        checkpoint, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _recompute_up_projection(up_shape)))


def normal_param(shape, std: float, gen: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen).mul_(std))


def layer_norm_params(width: int, norm: str = "layernorm") -> nn.ParameterDict:
    """A norm's parameters: scale and bias, or scale alone for rmsnorm."""
    p = {"scale": nn.Parameter(torch.ones(width))}
    if norm == "layernorm":
        p["bias"] = nn.Parameter(torch.zeros(width))
    return nn.ParameterDict(p)


def apply_norm(p, x: torch.Tensor, norm: str = "layernorm") -> torch.Tensor:
    if norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


class ResidualBlock(nn.Module):
    """One pre-LN residual block."""

    def __init__(self, cfg: TransformerCfg,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w, hidden = cfg.width, cfg.mlp_hidden
        if cfg.init_std is not None:
            attn_std = fc_std = cfg.init_std
            proj_std = cfg.init_std * ((2 * cfg.layers) ** -0.5)
        else:
            proj_std = (w ** -0.5) * ((2 * cfg.layers) ** -0.5)
            attn_std = w ** -0.5
            fc_std = (2 * w) ** -0.5
        qkv_out = (cfg.heads + 2 * (cfg.kv_heads or cfg.heads)) * cfg.head_dim
        mlp_in = hidden * (2 if cfg.act == "swiglu" else 1)
        attn = {"wqkv": normal_param((w, qkv_out), attn_std, generator),
                "wo": normal_param((cfg.heads * cfg.head_dim, w), proj_std,
                                   generator)}
        mlp = {"w1": normal_param((w, mlp_in), fc_std, generator),
               "w2": normal_param((hidden, w), proj_std, generator)}
        if cfg.use_bias:
            attn.update(bqkv=nn.Parameter(torch.zeros(qkv_out)),
                        bo=nn.Parameter(torch.zeros(w)))
            mlp.update(b1=nn.Parameter(torch.zeros(mlp_in)),
                       b2=nn.Parameter(torch.zeros(w)))
        self.ln_1 = layer_norm_params(w, cfg.norm)
        self.attn = nn.ParameterDict(attn)
        self.ln_2 = layer_norm_params(w, cfg.norm)
        self.mlp = nn.ParameterDict(mlp)
        self.layout = None  # a sharded model's (`shard_model`)

    def weights(self, dtype: torch.dtype) -> dict:
        """The block's parameters as its forward takes them, by group:
        the parameters themselves, or a sharded block's fsdp shards
        gathered (the matrices in `dtype`, the compute dtype, as `dense`
        casts them)."""
        return {group: {k: full(mod, k, dtype if mod[k].dim() == 2
                                else None) for k in mod}
                for group, mod in (("attn", self.attn), ("mlp", self.mlp),
                                   ("ln_1", self.ln_1), ("ln_2", self.ln_2))}

    def region(self) -> Optional[TensorRegion]:
        """The collectives around the tensor-parallel products, or None."""
        lay = self.layout
        if lay is None or lay.tp == 1:
            return None
        return TensorRegion(lay.tensor, lay.sequence_parallel)

    def forward(self, x: torch.Tensor, causal: bool = False,
                save_probs: bool = True, rope=None,
                seed: Optional[int] = None, layer: int = 0,
                remat: str = "none",
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, S, W] in the compute dtype. `save_probs`: the attention's
        backward mode (see `ops.attention.multi_head_attention`); `rope`:
        the (cos, sin) tables when `cfg.rope`; `seed`: the step's dropout
        seed (None: no dropout) and `layer` this block's index, which picks
        its sites' offsets; `remat`: none, selective, mlp or full (see
        the module's note); `bias`: an additive attention mask (the
        attention then runs `sdpa_bshd`)."""
        cfg = self.cfg
        w, region = self.weights(x.dtype), self.region()

        def block(x, bias, segment=None):
            return multi_head_attention(
                x, w["attn"], cfg.heads, causal=causal, rope=rope, bias=bias,
                kv_heads=cfg.kv_heads, dropout_rate=cfg.attention_dropout,
                seed=seed, offset=site_offset(layer, 0),
                save_probs=save_probs,
                norm=lambda x: apply_norm(w["ln_1"], x, cfg.norm),
                after=lambda h: self._rest(x, h, w, region, seed, layer),
                segment=segment, region=region)
        if remat == "full":
            return checkpoint(block, x, bias, use_reentrant=False)
        if remat == "selective":
            return block(x, bias, _selective)
        if remat == "mlp":
            return block(x, bias, _mlp_segment(tuple(w["mlp"]["w1"].shape)))
        return block(x, bias)

    def _rest(self, x: torch.Tensor, h: torch.Tensor, w: dict,
              region: Optional[TensorRegion], seed: Optional[int],
              layer: int) -> torch.Tensor:
        """From the attention's projected output h [B, S, W] to the block's:
        hidden dropout, the residual add, ln_2, the MLP, hidden dropout, the
        residual add (inside `region` under tensor parallelism)."""
        cfg = self.cfg
        # under tensor parallelism without sequence parallelism every
        # tensor rank holds the residual stream whole
        sharded = region is None or region.sequence_parallel
        x = x + dropout(h, cfg.hidden_dropout, seed, site_offset(layer, 1),
                        sharded=sharded)
        h = apply_norm(w["ln_2"], x, cfg.norm)
        mlp = w["mlp"]
        if region is not None:
            h = region.enter(h)
        h = dense(h, mlp["w1"], mlp.get("b1"))
        h = swiglu(h) if cfg.act == "swiglu" else get_act(cfg.act)(h)
        if region is None:
            h = dense(h, mlp["w2"], mlp.get("b2"))
        else:
            h = region.leave(dense(h, mlp["w2"]))
            if "b2" in mlp:
                h = h + mlp["b2"].to(h.dtype)
        return x + dropout(h, cfg.hidden_dropout, seed, site_offset(layer, 2),
                           sharded=sharded)


class Transformer(nn.ModuleList):
    """`cfg.layers` residual blocks, run in order."""

    def __init__(self, cfg: TransformerCfg,
                 generator: Optional[torch.Generator] = None):
        super().__init__([ResidualBlock(cfg, generator)
                          for _ in range(cfg.layers)])

    def forward(self, x: torch.Tensor, causal: bool = False,
                save_probs: bool = True, seed: Optional[int] = None,
                remat: str = "none",
                position_ids: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`seed`: the step's dropout seed (None: no dropout); `remat`: none,
        selective, mlp or full (see the module's note); `position_ids`
        ([S] or per-row [B, S]): the positions the rotary tables are read
        at (megatron --reset-position-ids), else 0..S-1; `bias`: an
        additive attention mask for every block (megatron
        --reset-attention-mask)."""
        cfg = self[0].cfg
        rope = None
        if cfg.rope:
            lay = self[0].layout
            s = x.shape[1] * (lay.tp if lay is not None
                              and lay.sequence_parallel else 1)
            rope = rope_cos_sin(s, cfg.head_dim, cfg.rope_theta,
                                rotary_percent=cfg.rotary_percent,
                                seq_len_interpolation_factor=(
                                    cfg.rope_interpolation),
                                device=x.device)
            if position_ids is not None:
                rope = tuple(t[position_ids] for t in rope)
        for i, block in enumerate(self):
            x = block(x, causal=causal, save_probs=save_probs, rope=rope,
                      seed=seed, layer=i, remat=remat, bias=bias)
        return x
