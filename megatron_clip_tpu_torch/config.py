"""Model configuration for the PyTorch port.

Mirrors `megatron_clip_tpu/config.py` (Precision, TransformerCfg, VisionCfg,
TextCfg, CLIPCfg) with torch dtypes in place of jnp ones. Only the fields the
ported paths read are kept: the ViT CLIP towers with the text tower's
causal-mask switch and pooling, the vision tower's patch dropout and the
learned logit bias (SigLIP), but no layer scale, no vision pooling choice, no
ln_pre switch and no text-projection bias (`create_model` rejects those keys
until the slice that needs them), and what
`GPTCfg.transformer()` sets on the GPT paths (megatron's init, the bias
switch, gelu_tanh or swiglu, LayerNorm or RMSNorm, rotary embeddings,
grouped-query attention, the dropout rates and activation recompute; not
`kv_channels`, squared_relu or MoE); the mesh
configs (ParallelCfg, BranchParallelCfg) come
with the parallelism slice.
"""
from dataclasses import dataclass, field
from typing import Optional

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Precision:
    """Mixed-precision policy. Params live in `param_dtype`; matmuls and
    activations run in `compute_dtype`; layernorm, softmax and the final
    feature normalisation are computed in fp32."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def param_torch(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def compute_torch(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


FP32 = Precision(param_dtype="float32", compute_dtype="float32")
BF16 = Precision(param_dtype="float32", compute_dtype="bfloat16")
# open_CLIP --precision pure_bf16: the weights themselves in bf16
PURE_BF16 = Precision(param_dtype="bfloat16", compute_dtype="bfloat16")


REMAT_MODES = ("none", "selective", "full")


def check_remat(remat: str) -> str:
    """`remat` if the port has it: none, selective or full; the JAX
    package's "mlp" is not ported yet."""
    if remat == "mlp":
        raise NotImplementedError("remat='mlp' is not ported yet (ROADMAP "
                                  "Queue A item 1)")
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
    return remat


@dataclass(frozen=True)
class TransformerCfg:
    """Hyperparameters of one pre-LN transformer stack."""

    layers: int
    width: int
    heads: int
    mlp_ratio: float = 4.0
    act: str = "gelu"  # gelu | gelu_tanh | quick_gelu | swiglu
    norm: str = "layernorm"  # layernorm | rmsnorm (megatron --normalization)
    use_bias: bool = True    # linear biases (megatron --disable-bias-linear)
    rope: bool = False       # rotary embeddings (megatron
                             # --use-rotary-position-embeddings)
    rope_theta: float = 10000.0
    rotary_percent: float = 1.0  # rotate only the first D*percent channels
                                 # (megatron --rotary-percent)
    rope_interpolation: Optional[float] = None  # divide positions (megatron
                                 # --rotary-seq-len-interpolation-factor)
    kv_heads: Optional[int] = None  # grouped-query attention (megatron
                                    # --group-query-attention)
    # weight init: None = the open_CLIP width-derived scheme; a float =
    # megatron --init-method-std (inputs at std, residual outputs at
    # std/sqrt(2L))
    init_std: Optional[float] = None
    # dropout (megatron --attention-dropout / --hidden-dropout), active only
    # when a seed reaches the stack (training), as the JAX package's rng
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    # activation recompute (megatron --recompute-granularity)
    remat: str = "none"  # none | selective | full

    def __post_init__(self):
        check_remat(self.remat)
        if self.act not in ("gelu", "gelu_tanh", "quick_gelu", "swiglu"):
            raise NotImplementedError(f"act={self.act!r} is not ported yet "
                                      "(ROADMAP Queue A item 4)")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm={self.norm!r}: layernorm or rmsnorm")
        if self.kv_heads is not None and self.heads % self.kv_heads:
            raise ValueError(f"heads {self.heads} not a multiple of kv_heads "
                             f"{self.kv_heads}")

    @property
    def head_dim(self) -> int:
        if self.width % self.heads:
            raise ValueError(f"width {self.width} not divisible by heads "
                             f"{self.heads}")
        return self.width // self.heads

    @property
    def mlp_hidden(self) -> int:
        return int(round(self.width * self.mlp_ratio))


@dataclass(frozen=True)
class VisionCfg:
    """Vision tower; field names match open_CLIP's CLIPVisionCfg."""

    layers: int = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: int = 224
    # open_CLIP PatchDropout (FLIP): the share of patches dropped in the
    # train step, never in eval forwards
    patch_dropout: float = 0.0

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} not divisible by "
                             f"patch_size {self.patch_size}")
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # +1 class token

    def transformer(self, act: str) -> TransformerCfg:
        return TransformerCfg(layers=self.layers, width=self.width,
                              heads=self.heads, mlp_ratio=self.mlp_ratio,
                              act=act)


@dataclass(frozen=True)
class TextCfg:
    """Text tower; field names match open_CLIP's CLIPTextCfg."""

    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    no_causal_mask: bool = False  # SigLIP text towers attend both ways
    pool_type: str = "argmax"  # argmax (EOT) | first | last | none

    def __post_init__(self):
        if self.pool_type not in TEXT_POOL_TYPES:
            raise ValueError(f"text pool_type={self.pool_type!r}: one of "
                             f"{TEXT_POOL_TYPES}")

    def transformer(self, act: str) -> TransformerCfg:
        return TransformerCfg(layers=self.layers, width=self.width,
                              heads=self.heads, mlp_ratio=self.mlp_ratio,
                              act=act)


TEXT_POOL_TYPES = ("argmax", "first", "last", "none")


@dataclass(frozen=True)
class CLIPCfg:
    """Two-tower model config (open_CLIP model_configs/*.json schema)."""

    embed_dim: int = 512
    vision: VisionCfg = field(default_factory=VisionCfg)
    text: TextCfg = field(default_factory=TextCfg)
    quick_gelu: bool = False  # OpenAI checkpoints use x*sigmoid(1.702x)
    init_logit_scale: float = 2.659260036932778  # ln(1/0.07)
    # a learned logit bias (SigLIP's, -10 in ViT-B-16-SigLIP); None: none
    init_logit_bias: Optional[float] = None

    @property
    def act(self) -> str:
        return "quick_gelu" if self.quick_gelu else "gelu"
