"""Pre-LN transformer stack as nn.Modules.

Counterpart of `megatron_clip_tpu/nn/transformer.py`. The JAX package stacks
each block's leaves on a leading layer axis and runs them with `lax.scan`;
here each layer is its own `ResidualBlock` in a `Transformer` (a ModuleList),
run by a Python loop. Parameter names mirror the JAX pytree
(`blocks.{i}.attn.wqkv`, `blocks.{i}.ln_1.scale`, ...) and weights keep its
[in, out] layout, applied as `x @ w` (see `bridge.py`).

Initialisation follows open_CLIP's scheme: attn_std = width**-0.5,
proj_std = width**-0.5 * (2*layers)**-0.5, fc_std = (2*width)**-0.5, zero
biases; with `cfg.init_std` set, megatron's: attn_std = fc_std = init_std,
proj_std = init_std / sqrt(2*layers). Without `cfg.use_bias` the linears
have no biases. Each block's forward is ln_1 -> attn -> (+) -> ln_2 -> mlp
-> (+).
"""
from typing import Optional

import torch
from torch import nn

from megatron_clip_tpu_torch.config import TransformerCfg
from megatron_clip_tpu_torch.ops import get_act, layer_norm, multi_head_attention
from megatron_clip_tpu_torch.ops.dense import dense


def normal_param(shape, std: float, gen: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen) * std)


def layer_norm_params(width: int) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones(width)),
                             "bias": nn.Parameter(torch.zeros(width))})


def apply_norm(p, x: torch.Tensor) -> torch.Tensor:
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
        qkv_out = 3 * cfg.heads * cfg.head_dim
        attn = {"wqkv": normal_param((w, qkv_out), attn_std, generator),
                "wo": normal_param((cfg.heads * cfg.head_dim, w), proj_std,
                                   generator)}
        mlp = {"w1": normal_param((w, hidden), fc_std, generator),
               "w2": normal_param((hidden, w), proj_std, generator)}
        if cfg.use_bias:
            attn.update(bqkv=nn.Parameter(torch.zeros(qkv_out)),
                        bo=nn.Parameter(torch.zeros(w)))
            mlp.update(b1=nn.Parameter(torch.zeros(hidden)),
                       b2=nn.Parameter(torch.zeros(w)))
        self.ln_1 = layer_norm_params(w)
        self.attn = nn.ParameterDict(attn)
        self.ln_2 = layer_norm_params(w)
        self.mlp = nn.ParameterDict(mlp)

    def forward(self, x: torch.Tensor, causal: bool = False,
                save_probs: bool = True) -> torch.Tensor:
        """x: [B, S, W] in the compute dtype. `save_probs`: the attention's
        backward mode (see `ops.attention.multi_head_attention`)."""
        h = apply_norm(self.ln_1, x)
        x = x + multi_head_attention(h, self.attn, self.cfg.heads,
                                     causal=causal, save_probs=save_probs)
        h = apply_norm(self.ln_2, x)
        h = get_act(self.cfg.act)(dense(h, self.mlp["w1"],
                                        self.mlp.get("b1")))
        return x + dense(h, self.mlp["w2"], self.mlp.get("b2"))


class Transformer(nn.ModuleList):
    """`cfg.layers` residual blocks, run in order."""

    def __init__(self, cfg: TransformerCfg,
                 generator: Optional[torch.Generator] = None):
        super().__init__([ResidualBlock(cfg, generator)
                          for _ in range(cfg.layers)])

    def forward(self, x: torch.Tensor, causal: bool = False,
                save_probs: bool = True) -> torch.Tensor:
        for block in self:
            x = block(x, causal=causal, save_probs=save_probs)
        return x
