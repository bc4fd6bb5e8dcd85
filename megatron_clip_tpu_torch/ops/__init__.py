"""Compute ops of the port. Each op with a TPU kernel in the JAX package has a
hand-written CUDA kernel here (`ops/kernels/`) and a plain PyTorch version;
the device of the input picks between them.
"""
from megatron_clip_tpu_torch.ops.activations import bias_act, get_act  # noqa: F401
from megatron_clip_tpu_torch.ops.attention import multi_head_attention, sdpa  # noqa: F401
from megatron_clip_tpu_torch.ops.normalization import layer_norm  # noqa: F401
