"""Where the time of one CLIP or GPT train step goes on the GPU.

    python -m megatron_clip_tpu_torch.tools.profile_train \
        [--model ViT-B-32] [--batch 384] [--recompute]
    python -m megatron_clip_tpu_torch.tools.profile_train \
        --model gpt-345m [--batch 6] [--seq 2048]

Builds the model (pure_bf16, random weights from seed 0) with the recipe of
bench.py's CLIP legs (AdamW b=(0.9, 0.98), eps 1e-6, weight decay 0.2, bf16
first moments, cosine_lr(1e-3, 100, 10000), clip 1.0; the defaults are its
primary leg, `--model ViT-L-14 --batch 64 --recompute` and `--model
ViT-H-14 --batch 24 --recompute` its two larger legs, whose attention
backward recomputes the probabilities) or of its GPT-345m leg (clip 1.0,
AdamW(1e-4, b=(0.9, 0.95)) with bf16 first moments, loss chunks of 1024;
batch 6 at S = 2048 by default, `--seq 8192 --batch 1` for the split flash
backward), takes 3 warm-up steps on one seeded batch already on the card,
then traces 3 steps with torch.profiler. Prints one JSON line: wall time,
device-busy time (the union of kernel and copy intervals), the idle share,
and device time by category (GEMMs, elementwise, the port's attention and
LayerNorm kernels forward and backward, the optimizer's multi-tensor
kernels, copies, other) with the top kernels. Needs a CUDA device; exits
non-zero without one.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from megatron_clip_tpu_torch.tools.profile_serving import _window

SEED = 0
WARMUP = 3  # kernel builds, cuBLAS heuristics
REPS = 3


GPT_345M = {"num_layers": 24, "hidden_size": 1024, "num_heads": 16,
            "vocab_size": 50304}


def _category(name: str) -> str:
    n = name.lower()
    if "view<" in n:  # flash_attention.cu's kernels take View operands
        return ("attention bwd (flash_attention.cu)" if "bwd_" in n
                else "attention fwd (flash_attention.cu)")
    if "bwd_dq" in n or "bwd_dkdv" in n:  # saved-P and recompute (_rc)
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
def _clip_step(args):
    """(step on the seeded batch, what the JSON line says of the run)."""
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    batch = args.batch or 384
    model = port.create_model(args.model, precision="pure_bf16", seed=SEED,
                              attn_save_probs=not args.recompute).train()
    opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                         grad_clip_norm=1.0, moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.standard_normal(
        (batch, cfg.vision.image_size, cfg.vision.image_size, 3),
        dtype=np.float32)).cuda()
    texts = torch.from_numpy(rng.integers(
        1, cfg.text.vocab_size - 2, (batch, cfg.text.context_length))).cuda()

    def run():
        nonlocal state
        state, metrics = step(state, images, texts)
        return metrics
    return run, {"batch": batch, "attention_backward":
                 "recompute" if args.recompute else "saved P"}


def _gpt_step(args):
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, create_gpt
    from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
        uses_fused_bwd)
    from megatron_clip_tpu_torch.training import (TrainState,
                                                  make_gpt_optimizer,
                                                  make_gpt_train_step)
    batch, seq = args.batch or 6, args.seq
    cfg = GPTCfg(**GPT_345M, seq_length=seq)
    model = create_gpt(cfg, precision="pure_bf16", seed=SEED).train()
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(model, opt, loss_seq_chunk=1024)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab_size - 1, (batch, seq + 1))).cuda()

    def run():
        nonlocal state
        state, metrics = step(state, tokens)
        return metrics
    return run, {"batch": batch, "seq": seq, "attention_backward":
                 "fused" if uses_fused_bwd(seq) else "split dQ / dKV"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-B-32",
                    help="a CLIP model name or gpt-345m")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 384 (CLIP) or 6 (gpt-345m)")
    ap.add_argument("--seq", type=int, default=2048,
                    help="gpt-345m's sequence length")
    ap.add_argument("--recompute", action="store_true",
                    help="recompute the attention probabilities in the "
                         "backward (MCT_MHA_SAVE_PROBS=0) instead of saving "
                         "them (CLIP)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    run, about = (_gpt_step if args.model == "gpt-345m"
                  else _clip_step)(args)
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            metrics = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    window = _window(prof, wall, _category)
    print(json.dumps({"card": card, "model": args.model, **about,
                      "precision": "pure_bf16",
                      "window": f"{REPS} train steps, batch on the card",
                      "loss": float(metrics["loss"]), **window}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
