"""GPT decoder-only language model.

Counterpart of `megatron_clip_tpu/models/gpt.py` (`GPTCfg`, `init_gpt`,
`apply_gpt`, `gpt_loss`) for megatron's default GPT: token embedding plus
learned positions, causal pre-LN blocks (LayerNorm, gelu_tanh MLP, biases
optional), a final LayerNorm and logits through the tied embedding or an
untied lm head. Weights follow megatron's init (`init_std`); parameter names
mirror the JAX pytree (`tok_embed`, `pos_embed`, `blocks.{i}.attn.wqkv`,
`ln_f.scale`, `lm_head`) with the stacked layer axis unstacked (see
`bridge.gpt_params_from_jax`).

Not ported yet, refused with NotImplementedError (ROADMAP Queue A item 4):
rotary positions, swiglu and squared_relu MLPs, rmsnorm, grouped-query
attention, `kv_channels`, MoE, the fused lm-head cross entropy (`fused_ce`,
ROADMAP Queue B), per-row `position_ids`, `attn_bias` document masks and
pre-shifted `targets`. Dropout is 0, as GPT trains in bench.py.
"""
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from megatron_clip_tpu_torch.config import BF16, Precision, TransformerCfg
from megatron_clip_tpu_torch.nn.transformer import (
    Transformer, apply_norm, layer_norm_params, normal_param)
from megatron_clip_tpu_torch.ops.cross_entropy import cross_entropy

_ITEM = "ROADMAP Queue A item 4"


def _refuse(what: str, item: str = _ITEM):
    raise NotImplementedError(f"GPT: {what} is not ported yet ({item})")


@dataclass(frozen=True)
class GPTCfg:
    num_layers: int = 12
    hidden_size: int = 768
    num_heads: int = 12
    vocab_size: int = 50304        # megatron pads vocab to a friendly multiple
    seq_length: int = 1024
    mlp_ratio: float = 4.0
    position_embedding: str = "learned"  # learned | rope
    swiglu: bool = False
    squared_relu: bool = False
    normalization: str = "layernorm"     # layernorm | rmsnorm
    use_bias: bool = True
    kv_heads: Optional[int] = None       # GQA
    kv_channels: Optional[int] = None    # per-head dim override
    max_position_embeddings: Optional[int] = None  # learned-pos table length
    num_experts: int = 0
    tie_embeddings: bool = True
    init_std: float = 0.02

    def transformer(self) -> TransformerCfg:
        """The blocks' config, as the JAX `GPTCfg.transformer()` sets it on
        this path; options of the unported paths raise."""
        refused = {
            "rotary position embeddings": self.position_embedding != "learned",
            "swiglu": self.swiglu, "squared_relu": self.squared_relu,
            "rmsnorm": self.normalization != "layernorm",
            "grouped-query attention": self.kv_heads not in (
                None, self.num_heads),
            "kv_channels": self.kv_channels is not None,
            "MoE (num_experts)": self.num_experts > 0,
        }
        bad = [what for what, on in refused.items() if on]
        if bad:
            _refuse(", ".join(bad))
        return TransformerCfg(layers=self.num_layers, width=self.hidden_size,
                              heads=self.num_heads, mlp_ratio=self.mlp_ratio,
                              act="gelu_tanh", norm="layernorm",
                              use_bias=self.use_bias, init_std=self.init_std)


class GPTModel(nn.Module):
    """`init_gpt`'s parameters as a module; `forward` is `apply_gpt`."""

    def __init__(self, cfg: GPTCfg, precision: Precision = BF16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        tcfg = cfg.transformer()
        n_pos = cfg.max_position_embeddings or cfg.seq_length
        if n_pos < cfg.seq_length:
            raise ValueError(f"max_position_embeddings {n_pos} < "
                             f"seq_length {cfg.seq_length}")
        std, w = cfg.init_std, cfg.hidden_size
        self.tok_embed = normal_param((cfg.vocab_size, w), std, generator)
        self.pos_embed = normal_param((n_pos, w), std, generator)
        self.blocks = Transformer(tcfg, generator)
        self.ln_f = layer_norm_params(w)
        if not cfg.tie_embeddings:
            self.lm_head = normal_param((w, cfg.vocab_size), std, generator)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> the final LayerNorm's output [B, S, W] in the
        compute dtype (`apply_gpt(..., return_hidden=True)`)."""
        dt = self.precision.compute_torch
        s = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embed).to(dt)
        x = x + self.pos_embed[:s].to(dt)
        x = self.blocks(x, causal=True)
        return apply_norm(self.ln_f, x)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The lm head: h [..., W] -> fp32 logits [..., V], the product
        rounded to h's dtype first, as the JAX einsum does."""
        if self.cfg.tie_embeddings:
            return torch.matmul(h, self.tok_embed.to(h.dtype).t()).float()
        return torch.matmul(h, self.lm_head.to(h.dtype)).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] fp32."""
        return self.logits(self.hidden(tokens))


def create_gpt(cfg: GPTCfg, precision: Union[str, Precision] = "bf16",
               device: Union[str, torch.device, None] = None,
               seed: int = 0) -> GPTModel:
    """A GPT with random weights drawn in fp32 from `seed` on the CPU
    generator (so every device gets the same weights), stored in the
    precision's parameter dtype (`pure_bf16`: bf16, as bench.py's
    `init_gpt(..., dtype=bfloat16)`), on `device`. `device=None` means the
    CUDA device; without one this raises, it does not fall back to the CPU:
    pass device="cpu" to run there."""
    from megatron_clip_tpu_torch.factory import _precision_from_str
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_gpt: no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    prec = (precision if isinstance(precision, Precision)
            else _precision_from_str(precision))
    model = GPTModel(cfg, prec, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=prec.param_torch)


def _chunk_loss(model: GPTModel, h, targets, mask):
    per = cross_entropy(model.logits(h), targets)
    return (per * mask).sum(), mask.sum()


def gpt_loss(model: GPTModel, tokens: torch.Tensor, *,
             loss_mask: Optional[torch.Tensor] = None,
             loss_seq_chunk: int = 0, fused_ce: bool = False,
             position_ids=None, attn_bias=None,
             targets=None) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1], with
    loss-mask averaging (`loss_mask` [B, S+1] aligned to the inputs, 0
    where the input token is EOD). A 0-d fp32 tensor.

    `loss_seq_chunk` > 0 runs the lm head and cross entropy on sequence
    chunks of that size, each under `torch.utils.checkpoint`: one chunk's
    [B, C, V] fp32 logits are live at a time, recomputed in the backward, as
    the JAX package's `jax.checkpoint` scan. The chunk sums add in order, in
    fp32; a short last chunk stands for the JAX package's zero padding,
    whose terms are 0."""
    if fused_ce:
        _refuse("fused_ce", "ROADMAP Queue B: fused_ce")
    if position_ids is not None or attn_bias is not None \
            or targets is not None:
        _refuse("position_ids, attn_bias and pre-shifted targets")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = None if loss_mask is None else loss_mask[:, :-1].float()
    if loss_seq_chunk:
        h = model.hidden(inputs)
        b, s, _ = h.shape
        c = min(loss_seq_chunk, s)
        m = torch.ones(b, s, device=h.device) if mask is None else mask
        tot = cnt = torch.zeros((), device=h.device)
        for i in range(0, s, c):
            t, n = checkpoint(_chunk_loss, model, h[:, i:i + c],
                              targets[:, i:i + c], m[:, i:i + c],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + n
        return tot / torch.clamp(cnt, min=1.0)
    per = cross_entropy(model(inputs), targets)
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
