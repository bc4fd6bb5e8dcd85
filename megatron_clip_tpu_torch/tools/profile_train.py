"""Where the time of one CLIP or GPT train step goes on the GPU.

    python -m megatron_clip_tpu_torch.tools.profile_train \
        [--model ViT-B-32] [--batch 384] [--recompute]
    python -m megatron_clip_tpu_torch.tools.profile_train \
        --model gpt-345m [--batch 6] [--seq 2048] [--fused-ce]
    python -m megatron_clip_tpu_torch.tools.profile_train \
        --model gpt-rope-swiglu --fused-ce [--batch 8]
    python -m megatron_clip_tpu_torch.tools.profile_train \
        --model gpt-pipeline [--seq 512]
    python -m torch.distributed.run --standalone --nproc-per-node 1 \
        -m megatron_clip_tpu_torch.tools.profile_train [--model ViT-B-32]

Builds the model (pure_bf16, random weights from seed 0) with the recipe of
bench.py's CLIP legs (AdamW b=(0.9, 0.98), eps 1e-6, weight decay 0.2, bf16
first moments, cosine_lr(1e-3, 100, 10000), clip 1.0; the defaults are its
primary leg, `--model ViT-L-14 --batch 64 --recompute` and `--model
ViT-H-14 --batch 24 --recompute` its two larger legs, whose attention
backward recomputes the probabilities) or of its GPT-345m leg (pure_bf16,
clip 1.0, AdamW(1e-4, b=(0.9, 0.95)) with bf16 first moments, loss chunks
of 1024 or with `--fused-ce` the fused lm-head cross entropy; batch 6 at
S = 2048 by default, `--seq 8192 --batch 1` for the split flash backward),
or the GPT of examples/pretrain_gpt_dist.sh (`gpt-rope-swiglu`: GPT-345m's
widths with rope, swiglu and rmsnorm, bf16 compute on fp32 weights, batch 8
by default, the same optimizer chain), or the GPT of
examples/pretrain_gpt_pipeline.sh (`gpt-pipeline`: 32 x 2048, 16 heads,
learned positions, attention and hidden dropout 0.1 from seed 1234, the
fused CE, bf16 compute on fp32 weights, the example's selective
recompute; batch 8 at S = 2048, the flash dropout kernels,
or batch 32 at `--seq 512`, the fused-MHA dropout kernels; the same
optimizer chain), takes 3 warm-up steps on one seeded
batch already on the card, then traces 3 steps with torch.profiler. Prints
one JSON line: wall time, device-busy time (the union of kernel and copy
intervals), the idle share, and device time by category (GEMMs,
elementwise, the port's attention, LayerNorm, RMSNorm and fused-CE kernels
forward and backward, the optimizer's multi-tensor kernels, copies, other)
with the top kernels, each of the port's kernels by name and template
arguments (`port_kernels_ms`: which instantiation ran, e.g. the attention
kernels' head dim), and the PyTorch ops whose own kernels took the most
device time. Needs a CUDA device; exits non-zero without one. Under
torchrun the CLIP step is the data-parallel one over torchrun's group
(`parallel/mesh.py`; `--batch` rows a rank, NCCL), its feature gathers and
gradient all-reduce under the category "collective (nccl)"; rank 0 prints.
"""
import argparse
import json
import re
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
# examples/pretrain_gpt_dist.sh's options on GPT-345m's widths
ROPE_SWIGLU = {"position_embedding": "rope", "swiglu": True,
               "normalization": "rmsnorm"}
# examples/pretrain_gpt_pipeline.sh's GPT: megatron's dropout defaults
PIPELINE = {"num_layers": 32, "hidden_size": 2048, "num_heads": 16,
            "vocab_size": 50304, "attention_dropout": 0.1,
            "hidden_dropout": 0.1}
PIPELINE_SEED = 1234


def _category(name: str) -> str:
    n = name.lower()
    if "fused_ce_" in n:  # fused_ce_bwd_gemm<P>: the backward's products;
        # fused_ce_fwd_gemm, simt::fused_ce_fwd, fused_ce_combine: the forward
        return ("fused CE bwd (fused_ce.cu)" if "fused_ce_bwd" in n
                else "fused CE fwd (fused_ce.cu)")
    if "hop::bwd_" in n:  # the flash backward on wgmma: bwd_fused, and the
        # split pair bwd_dq / bwd_dkv, which "bwd_dq" below would send to
        # fused_mha.cu
        return "attention bwd (flash_attention.cu)"
    if "attn_bwd::" in n:  # the fused-MHA recompute backward on wgmma
        return "attention bwd (fused_mha.cu)"
    if "attn_short_bwd::" in n:  # the one-pass backward: bwd<keys, saved>
        return "attention bwd (fused_mha.cu)"
    if "attn_short::fwd<" in n:  # the one-pass forward: fwd<keys, mode>
        return "attention fwd (fused_mha.cu)"
    if "attn_fwd::fwd<" in n:  # the wgmma forward: fwd<D, two-pass, drop>
        return ("attention fwd (fused_mha.cu)"
                if re.search(r"attn_fwd::fwd<\d+, true", n)
                else "attention fwd (flash_attention.cu)")
    if "view<" in n:  # flash_attention.cu's other kernels take View operands
        return ("attention bwd (flash_attention.cu)" if "bwd_" in n
                else "attention fwd (flash_attention.cu)")
    if "bwd_dq" in n or "bwd_dkdv" in n:  # saved-P and recompute (_rc)
        return "attention bwd (fused_mha.cu)"
    if "tc::fwd" in n or "simt::fwd" in n:
        return "attention fwd (fused_mha.cu)"
    norm = re.search(r"ln_\w+<([^<>()]*)>", n)
    if norm and norm.group(1).split(", ")[-1] == "true":
        # the RMS variants: RMS is every norm kernel's last template argument
        return ("rmsnorm bwd (layernorm.cu)" if "ln_bwd" in n
                else "rmsnorm fwd (layernorm.cu)")
    if "ln_bwd" in n:
        return "layernorm bwd (layernorm.cu)"
    if "ln_fwd" in n:
        return "layernorm fwd (layernorm.cu)"
    if "nccl" in n:
        return "collective (nccl)"
    if "multi_tensor_apply" in n:
        return "optimizer (multi-tensor)"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise"
    return "other"


def _kernel_label(name: str) -> str:
    """A kernel's demangled name without its parameter list: the function
    and its template arguments."""
    return re.sub(r"\((?!anonymous namespace\)).*$", "", name)


def _port_kernels(prof) -> dict:
    """Device ms of each of the port's kernels in the window (the columns
    of csrc/*.cu), by `_kernel_label`, largest first."""
    by = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and _category(e.name).endswith(".cu)")):
            key = _kernel_label(e.name)
            by[key] = by.get(key, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _top_ops(prof, n: int = 16) -> list:
    """The `n` PyTorch ops whose own kernels took the most device time in
    the window ([op name, ms]): where the elementwise time comes from."""
    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    return sorted(ops, key=lambda kv: -kv[1])[:n]


def _clip_step(args):
    """(step on the seeded batch, what the JSON line says of the run)."""
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.parallel import mesh
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    batch = args.batch or 384
    device = mesh.init_distributed(args, torch.device("cuda"))
    model = port.create_model(args.model, precision="pure_bf16", seed=SEED,
                              attn_save_probs=not args.recompute,
                              device=device).train()
    mesh.broadcast_module(model)
    opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                         grad_clip_norm=1.0, moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, group=mesh.group())
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
    return run, {"batch": batch, "precision": "pure_bf16",
                 "attention_backward": "recompute" if args.recompute
                 else "saved P", "ranks": mesh.world_size(),
                 "group": mesh.group() is not None}


def _gpt_step(args):
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, create_gpt
    from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
        uses_fused_bwd)
    from megatron_clip_tpu_torch.training import (TrainState,
                                                  make_gpt_optimizer,
                                                  make_gpt_train_step)
    example = args.model == "gpt-rope-swiglu"
    pipeline = args.model == "gpt-pipeline"
    seq = args.seq
    batch = args.batch or (8 if example else 6)
    if pipeline:
        batch = args.batch or 8 * 2048 // seq
        cfg = GPTCfg(**PIPELINE, seq_length=seq)
    else:
        cfg = GPTCfg(**GPT_345M, **(ROPE_SWIGLU if example else {}),
                     seq_length=seq)
    precision = "bf16" if example or pipeline else "pure_bf16"
    fused_ce = args.fused_ce or pipeline
    model = create_gpt(cfg, precision=precision, seed=SEED).train()
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(
        model, opt, loss_seq_chunk=1024, fused_ce=fused_ce,
        remat="selective" if pipeline else "none",
        seed=PIPELINE_SEED if pipeline else None)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab_size - 1, (batch, seq + 1))).cuda()

    def run():
        nonlocal state
        state, metrics = step(state, tokens)
        return metrics
    return run, {"batch": batch, "seq": seq, "precision": precision,
                 "loss": "fused_ce" if fused_ce else "chunks of 1024",
                 "attention_backward": "fused" if uses_fused_bwd(seq)
                 else "split dQ / dKV",
                 "remat": "selective" if pipeline else "none",
                 "dropout": pipeline}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-B-32",
                    help="a CLIP model name, gpt-345m, gpt-rope-swiglu or "
                         "gpt-pipeline")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 384 (CLIP), 6 (gpt-345m), 8 "
                         "(gpt-rope-swiglu) or 16384 tokens (gpt-pipeline)")
    ap.add_argument("--seq", type=int, default=2048,
                    help="the GPT's sequence length")
    ap.add_argument("--fused-ce", action="store_true",
                    help="the GPT loss through the fused lm-head cross "
                         "entropy instead of loss chunks of 1024")
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
    run, about = (_gpt_step if args.model.startswith("gpt-")
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
    from megatron_clip_tpu_torch.parallel import mesh
    if mesh.is_main():
        print(json.dumps({"card": card, "model": args.model, **about,
                          "window": f"{REPS} train steps, batch on the card",
                          "loss": float(metrics["loss"]), **window,
                          "port_kernels_ms": _port_kernels(prof),
                          "top_ops_device_ms": _top_ops(prof)}))
    mesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
