"""PyTorch/CUDA port of megatron_clip_tpu.

A second package beside the JAX one, which stays the reference. Entry points
run on the CUDA device unless the caller asks for the CPU; every TPU kernel
on a ported path is a hand-written Hopper kernel under `csrc/`.
"""
from megatron_clip_tpu_torch.factory import create_model  # noqa: F401
from megatron_clip_tpu_torch.tokenizer import get_tokenizer, tokenize  # noqa: F401
