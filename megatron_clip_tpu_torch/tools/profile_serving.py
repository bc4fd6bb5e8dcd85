"""Where the time of one zero-shot serving request goes on the GPU.

    python -m megatron_clip_tpu_torch.tools.profile_serving [--batch 256]

Builds ViT-B-32 (bf16, random weights from --seed) and a zero-shot
classifier over 100 ImageNet classes x the 7 simple templates, then traces
with torch.profiler: (a) --reps requests on a batch already on the card,
(b) one request from a host numpy batch, copy included. Prints one JSON line
per window: wall time, device-busy time (the union of kernel and copy
intervals), the idle share, and device time by category (the port's
attention and LayerNorm kernels, GEMMs, elementwise, copies, other) with the
top kernels. Needs a CUDA device; exits non-zero without one.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _category(name: str) -> str:
    n = name.lower()
    if "tc::fwd" in n or "simt::fwd" in n:
        return "attention (fused_mha.cu)"
    if "ln_fwd" in n:
        return "layernorm (layernorm.cu)"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise"
    return "other"


def _window(prof, wall_ms: float, category=_category) -> dict:
    """Device spans of a profiler window: busy time (their union), idle
    share of `wall_ms`, time by `category(kernel name)`, top kernels."""
    spans, by_cat, by_name = [], {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end  # microseconds
        spans.append((start, end))
        ms = (end - start) / 1e3
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_category": by_cat,
            "top_kernels_ms": [[name[:90], ms] for name, ms in top]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.evaluation import zero_shot as zs
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = port.create_model("ViT-B-32", precision="bf16", seed=args.seed)
    names, _ = zs.load_imagenet_metadata()
    classifier = zs.build_zero_shot_classifier(
        model, names[:100], zs.SIMPLE_IMAGENET_TEMPLATES, port.get_tokenizer())
    host = np.random.default_rng(args.seed).standard_normal(
        (args.batch, 224, 224, 3), dtype=np.float32)
    on_card = torch.from_numpy(host).cuda()
    for _ in range(2):  # warm-up: kernel builds, cuBLAS heuristics
        zs.zero_shot_classification(model, classifier, on_card)
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    windows = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            zs.zero_shot_classification(model, classifier, on_card)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    windows[f"{args.reps} requests, batch on the card"] = _window(prof, wall)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        zs.zero_shot_classification(model, classifier, host).topk(5).indices.cpu()
        wall = (time.perf_counter() - t0) * 1e3
    windows["1 request from host numpy"] = _window(prof, wall)
    for label, w in windows.items():
        print(json.dumps({"card": card, "batch": args.batch, "window": label,
                          **w}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
