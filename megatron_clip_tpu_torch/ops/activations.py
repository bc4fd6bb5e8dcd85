"""Activation functions and the bias-add + activation op.

Mirrors `megatron_clip_tpu/ops/activations.py`. Elementwise work stays plain
PyTorch: it is not a TPU kernel there either (XLA fuses it into the GEMM).
"""
import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


_ACTS = {
    "gelu": gelu_exact,        # torch nn.GELU default: the exact erf form
    "gelu_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
}


def get_act(name: str):
    return _ACTS[name]


def bias_act(x: torch.Tensor, bias, act: str) -> torch.Tensor:
    """bias-add, then activation."""
    if bias is not None:
        x = x + bias
    return get_act(act)(x)
