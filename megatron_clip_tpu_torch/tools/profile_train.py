"""Where the time of one CLIP train step goes on the GPU.

    python -m megatron_clip_tpu_torch.tools.profile_train

Builds ViT-B-32 (pure_bf16, random weights from seed 0) with the recipe of
bench.py's primary leg (batch 384, AdamW b=(0.9, 0.98), eps 1e-6, weight
decay 0.2, bf16 first moments, cosine_lr(1e-3, 100, 10000), clip 1.0),
takes 3 warm-up steps on one seeded batch already on the card, then traces
3 steps with torch.profiler. Prints one JSON line: wall time, device-busy
time (the union of kernel and copy intervals), the idle share, and device
time by category (GEMMs, elementwise, the port's attention and LayerNorm
kernels forward and backward, the optimizer's multi-tensor kernels, copies,
other) with the top kernels. Needs a CUDA device; exits non-zero without
one.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from megatron_clip_tpu_torch.tools.profile_serving import _window

BATCH = 384
SEED = 0
WARMUP = 3  # kernel builds, cuBLAS heuristics
REPS = 3


def _category(name: str) -> str:
    n = name.lower()
    if "bwd_dq" in n or "bwd_dkdv" in n:
        return "attention bwd (fused_mha.cu)"
    if "tc::fwd" in n or "simt::fwd" in n:
        return "attention fwd (fused_mha.cu)"
    if "ln_bwd" in n:
        return "layernorm bwd (layernorm.cu)"
    if "ln_fwd" in n:
        return "layernorm fwd (layernorm.cu)"
    if "multi_tensor_apply" in n:
        return "optimizer (multi-tensor)"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise"
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = port.create_model("ViT-B-32", precision="pure_bf16",
                              seed=SEED).train()
    opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                         grad_clip_norm=1.0, moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.standard_normal(
        (BATCH, cfg.vision.image_size, cfg.vision.image_size, 3),
        dtype=np.float32)).cuda()
    texts = torch.from_numpy(rng.integers(
        1, cfg.text.vocab_size - 2, (BATCH, cfg.text.context_length))).cuda()
    for _ in range(WARMUP):
        state, _ = step(state, images, texts)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            state, metrics = step(state, images, texts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    window = _window(prof, wall, _category)
    print(json.dumps({"card": card, "batch": BATCH,
                      "precision": "pure_bf16",
                      "window": f"{REPS} train steps, batch on the card",
                      "loss": float(metrics["loss"]), **window}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
