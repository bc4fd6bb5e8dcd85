"""GPT decoder-only language model.

Counterpart of `megatron_clip_tpu/models/gpt.py` (`GPTCfg`, `init_gpt`,
`apply_gpt`, `gpt_loss`): token embedding plus learned positions or rotary
embeddings (`position_embedding="rope"`, no `pos_embed`), causal pre-norm
blocks (LayerNorm or RMSNorm, gelu_tanh or swiglu MLP, biases optional,
grouped-query attention with `kv_heads`), a final norm and logits through
the tied embedding or an untied lm head. Weights follow megatron's init
(`init_std`); parameter names mirror the JAX pytree (`tok_embed`,
`pos_embed`, `blocks.{i}.attn.wqkv`, `ln_f.scale`, `lm_head`) with the
stacked layer axis unstacked (see `bridge.gpt_params_from_jax`).

`gpt_loss` takes the loss over full logits, over sequence chunks
(`loss_seq_chunk`) or through the fused lm-head cross entropy
(`fused_ce=True`, `ops/kernels/fused_ce.py`), which never forms the logits.

Dropout (megatron --attention-dropout / --hidden-dropout, on `GPTCfg` here
where the JAX package sets them on its TransformerCfg): with a `seed`
(the step's; the JAX package's `rng`) the embedding output, the attention
probabilities and the blocks' hidden states are dropped; `seed=None` is
eval. Activation recompute: `remat` (none, selective, mlp, full; megatron
--recompute-granularity), which `make_gpt_train_step` takes, by default
`GPTCfg.remat`, and passes to the loss.

Not ported yet, refused with NotImplementedError (ROADMAP Queue A item 4):
squared_relu MLPs, `kv_channels`, MoE, per-row `position_ids`, `attn_bias`
document masks and pre-shifted `targets`.
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
from megatron_clip_tpu_torch.ops.dropout import EMBED_OFFSET, dropout
from megatron_clip_tpu_torch.ops.kernels.fused_ce import (
    fused_linear_cross_entropy)

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
    rope_theta: float = 10000.0
    rotary_percent: float = 1.0          # megatron --rotary-percent
    rope_interpolation: Optional[float] = None  # megatron --rotary-seq-len-
                                                # interpolation-factor
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
    attention_dropout: float = 0.0       # megatron --attention-dropout
    hidden_dropout: float = 0.0          # megatron --hidden-dropout
    remat: str = "none"                  # --recompute-granularity

    def transformer(self) -> TransformerCfg:
        """The blocks' config, as the JAX `GPTCfg.transformer()` sets it on
        this path; options of the unported paths raise."""
        refused = {
            "squared_relu": self.squared_relu,
            "kv_channels": self.kv_channels is not None,
            "MoE (num_experts)": self.num_experts > 0,
        }
        bad = [what for what, on in refused.items() if on]
        if bad:
            _refuse(", ".join(bad))
        if self.position_embedding not in ("learned", "rope"):
            raise ValueError(f"position_embedding="
                             f"{self.position_embedding!r}: learned or rope")
        return TransformerCfg(
            layers=self.num_layers, width=self.hidden_size,
            heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            act="swiglu" if self.swiglu else "gelu_tanh",
            norm=self.normalization, use_bias=self.use_bias,
            rope=self.position_embedding == "rope",
            rope_theta=self.rope_theta, rotary_percent=self.rotary_percent,
            rope_interpolation=self.rope_interpolation,
            kv_heads=self.kv_heads, init_std=self.init_std,
            attention_dropout=self.attention_dropout,
            hidden_dropout=self.hidden_dropout, remat=self.remat)


class GPTModel(nn.Module):
    """`init_gpt`'s parameters as a module; `forward` is `apply_gpt`."""

    def __init__(self, cfg: GPTCfg, precision: Precision = BF16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        tcfg = cfg.transformer()
        std, w = cfg.init_std, cfg.hidden_size
        self.tok_embed = normal_param((cfg.vocab_size, w), std, generator)
        if not tcfg.rope:
            n_pos = cfg.max_position_embeddings or cfg.seq_length
            if n_pos < cfg.seq_length:
                raise ValueError(f"max_position_embeddings {n_pos} < "
                                 f"seq_length {cfg.seq_length}")
            self.pos_embed = normal_param((n_pos, w), std, generator)
        self.blocks = Transformer(tcfg, generator)
        self.ln_f = layer_norm_params(w, cfg.normalization)
        if not cfg.tie_embeddings:
            self.lm_head = normal_param((w, cfg.vocab_size), std, generator)

    def hidden(self, tokens: torch.Tensor, seed: Optional[int] = None,
               remat: str = "none") -> torch.Tensor:
        """tokens [B, S] -> the final norm's output [B, S, W] in the compute
        dtype (`apply_gpt(..., return_hidden=True)`). `seed`: the step's
        dropout seed (None: no dropout); `remat`: the blocks' recompute."""
        dt = self.precision.compute_torch
        s = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embed).to(dt)
        if hasattr(self, "pos_embed"):
            x = x + self.pos_embed[:s].to(dt)
        x = dropout(x, self.cfg.hidden_dropout, seed, EMBED_OFFSET)
        x = self.blocks(x, causal=True, seed=seed, remat=remat)
        return apply_norm(self.ln_f, x, self.cfg.normalization)

    def head(self, dtype: torch.dtype) -> torch.Tensor:
        """The lm head as [W, V] in `dtype`: the tied embedding's transposed
        view (its storage stays [V, W]) or the untied `lm_head`."""
        if self.cfg.tie_embeddings:
            return self.tok_embed.t().to(dtype)
        return self.lm_head.to(dtype)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The lm head: h [..., W] -> fp32 logits [..., V], the product
        rounded to h's dtype first, as the JAX einsum does."""
        return torch.matmul(h, self.head(h.dtype)).float()

    def forward(self, tokens: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] fp32."""
        return self.logits(self.hidden(tokens, seed))


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
             seed: Optional[int] = None, remat: str = "none",
             position_ids=None, attn_bias=None,
             targets=None) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1], with
    loss-mask averaging (`loss_mask` [B, S+1] aligned to the inputs, 0
    where the input token is EOD). A 0-d fp32 tensor. `seed` turns on
    dropout at the config's rates (the JAX package's `rng`); `remat` is
    the activation recompute, none, selective, mlp or full
    (`make_gpt_train_step` resolves it from its argument or
    `GPTCfg.remat`).

    `fused_ce` runs the lm head and cross entropy as one fused kernel on
    the hidden states [B*S, W] and the head cast to their dtype (bf16 under
    bf16 compute), `fused_linear_cross_entropy`: no logits are formed; the
    loss is the masked mean of its per-token loss. It wins over
    `loss_seq_chunk`, as in the JAX package.

    `loss_seq_chunk` > 0 runs the lm head and cross entropy on sequence
    chunks of that size, each under `torch.utils.checkpoint`: one chunk's
    [B, C, V] fp32 logits are live at a time, recomputed in the backward, as
    the JAX package's `jax.checkpoint` scan. The chunk sums add in order, in
    fp32; a short last chunk stands for the JAX package's zero padding,
    whose terms are 0."""
    if position_ids is not None or attn_bias is not None \
            or targets is not None:
        _refuse("position_ids, attn_bias and pre-shifted targets")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = None if loss_mask is None else loss_mask[:, :-1].float()
    if fused_ce:
        h = model.hidden(inputs, seed, remat)
        b, s, w = h.shape
        per = fused_linear_cross_entropy(h.reshape(b * s, w),
                                         model.head(h.dtype),
                                         targets.reshape(-1))
        m = (torch.ones(b * s, device=h.device) if mask is None
             else mask.reshape(-1))
        return (per * m).sum() / torch.clamp(m.sum(), min=1.0)
    if loss_seq_chunk:
        h = model.hidden(inputs, seed, remat)
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
    per = cross_entropy(model.logits(model.hidden(inputs, seed, remat)),
                        targets)
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
