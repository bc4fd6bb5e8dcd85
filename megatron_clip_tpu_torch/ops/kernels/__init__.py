"""Hand-written CUDA kernels (sources in `megatron_clip_tpu_torch/csrc/`),
each with its wrapper, plain PyTorch version and launch counter."""
