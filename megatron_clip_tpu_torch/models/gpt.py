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

The document masks of megatron's --eod-mask-loss, --reset-position-ids
and --reset-attention-mask: `get_ltor_masks_and_position_ids` gives the
loss mask, the per-row positions and the additive attention mask of the
input tokens, which `gpt_loss` takes with pre-shifted `targets`; the
attention mask sends every layer's attention to `sdpa_bshd`, as in the JAX
package. Over a data-parallel group (`gpt_loss(group=...)`) the masked
mean's denominator is the whole batch's count.

Tensor parallelism, sequence parallelism and FSDP (a model sharded by
`parallel/sharding.shard_model`; the JAX `gpt_param_specs` rules): the
tied embedding is held as P(tensor, fsdp) shards and gathered whole for
the lookup and the head (`embedding`); each tensor rank looks up its
S/tp slice of the inputs and drops it (its own mask), which is the
sequence-parallel stream, or, without sequence parallelism, gathered
whole for the blocks and sliced again after the final norm. So every rank
computes the loss of its own rows and S/tp slice, none twice: `gpt_loss`
returns the rank's share over the tensor ranks too (divided by tp, the
masked mean's count summed over every rank), and the gradients are sums
over the ranks (`training/train_step.GradBuckets`).

Not ported yet, refused with NotImplementedError (ROADMAP Queue A item 4):
squared_relu MLPs, `kv_channels` and MoE.
"""
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist
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
from megatron_clip_tpu_torch.parallel.collectives import (gather_seq,
                                                          own_slice,
                                                          scatter_seq)
from megatron_clip_tpu_torch.parallel.sharding import full

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
        self.layout = None  # a sharded model's (`shard_model`)

    @property
    def tp(self) -> int:
        return 1 if self.layout is None else self.layout.tp

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This tensor rank's S/tp slice of x [B, S, ...] (x itself without
        tensor parallelism): the rows whose loss it computes."""
        return x if self.tp == 1 else own_slice(x, self.layout.tensor, 1)

    def embedding(self) -> torch.Tensor:
        """The token embedding [V, W] whole (a sharded model's shards
        gathered; the gradient reduce-scattered back)."""
        return full(self, "tok_embed")

    def hidden(self, tokens: torch.Tensor, seed: Optional[int] = None,
               remat: str = "none",
               position_ids: Optional[torch.Tensor] = None,
               attn_bias: Optional[torch.Tensor] = None,
               embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> the final norm's output [B, S, W] in the compute
        dtype (`apply_gpt(..., return_hidden=True)`); under tensor
        parallelism this rank's rows of it, [B, S/tp, W] (`own_rows`).
        `seed`: the step's dropout seed (None: no dropout); `remat`: the
        blocks' recompute; `position_ids` ([S] or per-row [B, S]): the
        positions the learned table or the rotary tables are read at;
        `attn_bias` [B, 1, S, S]: an additive attention mask composed with
        the causal one; `embed`: `embedding()`, when the caller has it."""
        dt = self.precision.compute_torch
        s = tokens.shape[1]
        embed = self.embedding() if embed is None else embed
        x = F.embedding(self.own_rows(tokens), embed).to(dt)
        if hasattr(self, "pos_embed"):
            pos = (self.pos_embed[:s] if position_ids is None
                   else self.pos_embed[position_ids])
            if pos.dim() == 2:  # [S, W]: the rows' positions are shared
                pos = pos[None]
            x = x + self.own_rows(pos).to(dt)
        x = dropout(x, self.cfg.hidden_dropout, seed, EMBED_OFFSET)
        lay = self.layout
        whole = self.tp > 1 and not lay.sequence_parallel
        if whole:  # the blocks hold the stream whole on every tensor rank
            x = gather_seq(x, lay.tensor, whole_grad=True)
        x = self.blocks(x, causal=True, seed=seed, remat=remat,
                        position_ids=position_ids, bias=attn_bias)
        x = apply_norm(self.ln_f, x, self.cfg.normalization)
        return scatter_seq(x, lay.tensor) if whole else x

    def head(self, dtype: torch.dtype,
             embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The lm head as [W, V] in `dtype`: the tied embedding's transposed
        view (its storage stays [V, W]; `embed` where the caller has it)
        or the untied `lm_head`, whole."""
        if self.cfg.tie_embeddings:
            embed = self.embedding() if embed is None else embed
            return embed.t().to(dtype)
        return full(self, "lm_head").to(dtype)

    def logits(self, h: torch.Tensor,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The lm head: h [..., W] -> fp32 logits [..., V], the product
        rounded to h's dtype first, as the JAX einsum does."""
        head = self.head(h.dtype) if head is None else head
        return torch.matmul(h, head).float()

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


def get_ltor_masks_and_position_ids(tokens: torch.Tensor, eod_token: int, *,
                                    reset_position_ids: bool = False,
                                    reset_attention_mask: bool = False,
                                    eod_mask_loss: bool = False):
    """megatron's get_ltor_masks_and_position_ids (utils.py) over packed
    token streams, as the JAX package vectorises it. tokens: [B, S], the
    model's INPUTS. Returns (attn_bias, loss_mask, position_ids), each None
    when its flag is off:
      - attn_bias [B, 1, S, S] fp32: 0 where query and key fall in the same
        document, -1e30 across (composed with the causal mask):
        --reset-attention-mask. The token after an EOD starts a document;
        the EOD closes its own.
      - loss_mask [B, S] fp32 over the input positions: 0 where the input
        is EOD: --eod-mask-loss.
      - position_ids [B, S] int64, restarting at 0 after each EOD:
        --reset-position-ids."""
    b, s = tokens.shape
    e = tokens == eod_token
    loss_mask = (torch.where(e, 0.0, 1.0).to(torch.float32)
                 if eod_mask_loss else None)
    attn_bias = None
    if reset_attention_mask:
        ei = e.to(torch.int64)
        doc = torch.cumsum(ei, dim=1) - ei
        same = doc[:, :, None] == doc[:, None, :]
        attn_bias = torch.where(same, 0.0, -1e30).to(torch.float32)[:, None]
    position_ids = None
    if reset_position_ids:
        idx = torch.arange(s, device=tokens.device)
        boundary = torch.where(e, idx[None] + 1, 0)
        last = torch.cummax(boundary, dim=1).values
        last = F.pad(last[:, :-1], (1, 0))          # exclusive
        position_ids = idx[None] - last
    return attn_bias, loss_mask, position_ids


def _chunk_loss(model: GPTModel, head, h, targets, mask):
    per = cross_entropy(model.logits(h, head), targets)
    return (per * mask).sum(), mask.sum()


def _masked_mean(total: torch.Tensor, count: torch.Tensor, group
                 ) -> torch.Tensor:
    """total / max(count, 1), or over a group of W ranks W total /
    max(count summed over the ranks, 1): W times this rank's share of the
    whole batch's masked mean, so that the mean over the ranks (the
    gradient all-reduce's) is that mean."""
    if group is None:
        return total / torch.clamp(count, min=1.0)
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return total * dist.get_world_size(group) / torch.clamp(count, min=1.0)


def gpt_loss(model: GPTModel, tokens: torch.Tensor, *,
             loss_mask: Optional[torch.Tensor] = None,
             loss_seq_chunk: int = 0, fused_ce: bool = False,
             seed: Optional[int] = None, remat: str = "none",
             position_ids: Optional[torch.Tensor] = None,
             attn_bias: Optional[torch.Tensor] = None,
             targets: Optional[torch.Tensor] = None,
             group=None) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1], with
    loss-mask averaging (`loss_mask` [B, S+1] aligned to the inputs, 0
    where the input token is EOD). A 0-d fp32 tensor. `seed` turns on
    dropout at the config's rates (the JAX package's `rng`); `remat` is
    the activation recompute, none, selective, mlp or full
    (`make_gpt_train_step` resolves it from its argument or
    `GPTCfg.remat`).

    `targets` [B, S]: pre-shifted targets; `tokens` are then the inputs
    [B, S] and `loss_mask` [B, S] is aligned to them (the JAX entry's
    document-flag path). `position_ids` ([S] or [B, S]) and `attn_bias`
    ([B, 1, S, S]) reach the model (`GPTModel.hidden`).

    `group`: the group whose ranks hold the batch's other rows (and under
    tensor parallelism the rows' other slices: every rank of the
    layout). With a loss mask, the denominator of the masked mean is then
    the count over every rank, as the JAX loss over the sharded batch
    counts it, and the loss is W times this rank's share (`_masked_mean`),
    whose mean over the ranks is the whole batch's loss. Without a mask
    every rank counts the same tokens and the loss is the rank's mean.
    Under tensor parallelism (a sharded model) each rank takes the loss of
    its rows' S/tp slice and returns it divided by tp: the sum over the
    tensor ranks is their rows' loss.

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
    if targets is None:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = None if loss_mask is None else loss_mask[:, :-1].float()
    else:
        inputs = tokens
        mask = None if loss_mask is None else loss_mask.float()
    if mask is None:
        group = None  # every rank counts the same tokens
    tp = model.tp
    targets = model.own_rows(targets)
    mask = None if mask is None else model.own_rows(mask)
    embed = model.embedding() if model.cfg.tie_embeddings else None

    def hidden():
        return model.hidden(inputs, seed, remat, position_ids=position_ids,
                            attn_bias=attn_bias, embed=embed)
    if fused_ce:
        h = hidden()
        b, s, w = h.shape
        per = fused_linear_cross_entropy(h.reshape(b * s, w),
                                         model.head(h.dtype, embed),
                                         targets.reshape(-1))
        m = (torch.ones(b * s, device=h.device) if mask is None
             else mask.reshape(-1))
        return _masked_mean((per * m).sum(), m.sum(), group) / tp
    if loss_seq_chunk:
        h = hidden()
        head = model.head(h.dtype, embed)
        b, s, _ = h.shape
        c = min(loss_seq_chunk, s)
        m = torch.ones(b, s, device=h.device) if mask is None else mask
        tot = cnt = torch.zeros((), device=h.device)
        for i in range(0, s, c):
            t, n = checkpoint(_chunk_loss, model, head, h[:, i:i + c],
                              targets[:, i:i + c], m[:, i:i + c],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + n
        return _masked_mean(tot, cnt, group) / tp
    h = hidden()
    per = cross_entropy(model.logits(h, model.head(h.dtype, embed)), targets)
    if mask is None:
        return per.mean() / tp
    return _masked_mean((per * mask).sum(), mask.sum(), group) / tp
