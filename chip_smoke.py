#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (megatron_clip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc ($CUDA_HOME/bin or /usr/local/cuda/bin). It
imports nothing of JAX or of the JAX package. Phases, each of which raises
(and so exits non-zero) on failure:

  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: every CUDA kernel of the port from csrc/, one nvcc per source,
     all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes and at the fused-MHA gate's edge: on the
     same inputs in fp32 (MHA 2e-5, LN 1e-5) and in bf16 (one bf16 ulp:
     4e-3 abs + 8e-3 rel), and the bf16 kernel against the plain version
     run in fp32 on the same bf16 inputs (2e-2 abs + 2e-2 rel);
  4. goldens: full-width ViT-B-32-quickgelu in fp32, weights rebuilt from
     tests/goldens/full/vitb32.npz's manifest, against open_CLIP's features
     (atol 1e-4);
  5. serving: ViT-B-32 bf16 with random weights from seed 0, a zero-shot
     classifier over the 1000 ImageNet classes x 7 templates, then 8
     requests of 256 seeded NHWC images answered with top-5 classes. The
     kernels' launch counters are zeroed just before and read just after,
     and must show exactly 12 attention launches per tower forward and 26
     (image) / 25 (text) LayerNorm launches; bf16 features must agree with
     an fp32 run of the same weights at per-row cosine >= 0.999. Images per
     second are all the window's images over its wall time, the first
     request included; the median request latency is reported beside it;
  6. timings: each kernel, its plain version and one PyTorch library call
     for the same function, at the ViT-B/32 batch-256 shapes, with the
     bound from bytes and operations.

The last three lines of standard output are the card's name and power
limit, the {"kernels": [...]} line and {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_BATCH = 256
SERVE_REQUESTS = 8
CLASSES_PER_TEXT_BATCH = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere; returns
    the largest absolute difference."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max())
    excess = float((err - (atol + rtol * want.abs())).max())
    log(f"  {label}: max_abs_err={worst:.3e} (atol {atol:g}, rtol {rtol:g})")
    if excess > 0:
        raise AssertionError(f"{label}: max_abs_err {worst:.3e} exceeds the "
                             "tolerance")
    return worst


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mha_cost(b: int, s: int, h: int, d: int, causal: bool, itemsize: int):
    """Bytes: qkv read once, output written once. Operations: the QK^T and
    PV multiply-adds over the (query, key) pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return b * s * 4 * h * d * itemsize, 4 * b * h * d * pairs


def ln_cost(rows: int, w: int, itemsize: int):
    """Bytes: x read and y written once, fp32 scale and bias read once.
    Operations: ~8 fp32 operations per element (mean, centring, variance,
    normalise, scale, shift)."""
    return 2 * rows * w * itemsize + 2 * w * 4, 8 * rows * w


def phase_build(kernels_build):
    log("[2] build")
    t0 = time.perf_counter()
    took = kernels_build.build()
    log(f"  built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in took.items()})})")
    for name in took:
        for line in kernels_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# (atol, rtol) of each comparison, by kernel: the kernel against its plain
# version on the same inputs, fp32 and bf16, and the bf16 kernel against the
# plain version run in fp32 on the same bf16 inputs. In bf16 the plain
# version rounds where the kernel rounds (the attention probabilities before
# P.V, every output), so the two must agree within one bf16 ulp; against
# fp32 the bf16 roundings themselves are allowed for.
TOLERANCES = {
    "fused_mha_fwd": {"fp32": (2e-5, 0.0), "bf16": (4e-3, 8e-3),
                      "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "layer_norm_fwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                       "bf16_vs_fp32_plain": (2e-2, 2e-2)},
}


def check_kernel(errs: dict, name: str, label: str, got: torch.Tensor,
                 plain) -> None:
    """Hold `got` against plain(inputs in got's dtype) and, for bf16, also
    against plain(inputs in fp32); keep the worst error of each kind."""
    key = "bf16" if got.dtype == torch.bfloat16 else "fp32"
    checks = [(key, plain(got.dtype))]
    if key == "bf16":
        checks.append(("bf16_vs_fp32_plain", plain(torch.float32)))
    for kind, want in checks:
        e = compare(f"{name} {label} {kind}", got, want,
                    *TOLERANCES[name][kind])
        errs[name][kind] = max(errs[name].get(kind, 0.0), e)


def phase_kernels(mha, ln):
    """Kernel vs plain version; returns the worst errors per kernel and
    kind of comparison."""
    log("[3] kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"fused_mha_fwd": {}, "layer_norm_fwd": {}}
    for b, s, h, d, causal in [(256, 50, 12, 64, False),
                               (256, 77, 8, 64, True),
                               (2, 1024, 2, 128, False),
                               (2, 1024, 2, 128, True),
                               (4, 197, 12, 64, False),
                               (2, 300, 4, 64, True),
                               (2, 257, 16, 80, False),
                               (3, 33, 2, 40, True),
                               (2, 45, 3, 36, True)]:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            check_kernel(
                errs, "fused_mha_fwd",
                f"B={b} S={s} H={h} D={d} causal={causal}",
                mha.fused_mha_fwd(x, h, causal=causal),
                lambda dt: mha.fused_mha_plain(x.to(dt), h, d ** -0.5, causal))
    for rows, w in [(SERVE_BATCH * 50, 768), (SERVE_BATCH * 77, 512),
                    (1000, 768), (5, 100), (3, 4100)]:
        x = torch.randn(rows, w, device="cuda", generator=gen) * 3 + 1
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            check_kernel(
                errs, "layer_norm_fwd", f"rows={rows} W={w}",
                ln.layer_norm_fwd(xd, scale, bias),
                lambda dt: ln.layer_norm_plain(xd.to(dt), scale, bias))
    return errs


def phase_goldens(port):
    log("[4] goldens: ViT-B-32-quickgelu fp32 vs open_CLIP features")
    from megatron_clip_tpu_torch.bridge import params_from_openclip_state_dict
    from megatron_clip_tpu_torch.utils.det_weights import (det_images,
                                                           det_state_dict,
                                                           det_texts)
    z = np.load(REPO / "tests" / "goldens" / "full" / "vitb32.npz")
    manifest = json.loads(bytes(z["manifest"]).decode())
    model = port.create_model("ViT-B-32-quickgelu", precision="fp32")
    sd = det_state_dict("vitb32", [(k, tuple(s)) for k, s in manifest])
    model.load_state_dict(params_from_openclip_state_dict(sd, model.cfg))
    img = model.encode_image(det_images("vitb32", 4, 224))
    txt = model.encode_text(det_texts("vitb32", 4, 77, 49408, sot=49406,
                                      eot=49407, pad_tail=2))
    return {
        "image_features": compare("image_features", img,
                                  torch.from_numpy(z["image_features"]).cuda(),
                                  1e-4, 0.0),
        "text_features": compare("text_features", txt,
                                 torch.from_numpy(z["text_features"]).cuda(),
                                 1e-4, 0.0),
    }


def phase_serving(port, mha, ln, card: str):
    log("[5] serving: ViT-B-32 bf16 zero-shot, 1000 classes x 7 templates, "
        f"{SERVE_REQUESTS} requests of {SERVE_BATCH} images")
    from megatron_clip_tpu_torch.evaluation import zero_shot as zs
    model = port.create_model("ViT-B-32", precision="bf16", seed=0)
    tokenizer = port.get_tokenizer("ViT-B-32")
    classnames, _ = zs.load_imagenet_metadata()
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((SERVE_BATCH, 224, 224, 3),
                                    dtype=np.float32)
                for _ in range(SERVE_REQUESTS)]
    vlayers = model.cfg.vision.layers
    tlayers = model.cfg.text.layers

    mha.fused_mha_fwd.launches = 0
    ln.layer_norm_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    classifier = zs.build_zero_shot_classifier(
        model, classnames, zs.SIMPLE_IMAGENET_TEMPLATES, tokenizer,
        batch_size=CLASSES_PER_TEXT_BATCH)
    torch.cuda.synchronize()
    classifier_s = time.perf_counter() - t0
    latencies, answers = [], []
    window0 = time.perf_counter()
    for images in requests:
        t0 = time.perf_counter()
        logits = zs.zero_shot_classification(model, classifier, images)
        top5 = logits.topk(5, dim=-1).indices.cpu()
        latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append((logits, top5))
    window_s = time.perf_counter() - window0
    n_mha, n_ln = mha.fused_mha_fwd.launches, ln.layer_norm_fwd.launches

    text_fwd = math.ceil(len(classnames) / CLASSES_PER_TEXT_BATCH)
    image_fwd = SERVE_REQUESTS
    want_mha = vlayers * image_fwd + tlayers * text_fwd
    want_ln = (2 * vlayers + 2) * image_fwd + (2 * tlayers + 1) * text_fwd
    log(f"  launches: fused_mha_fwd {n_mha} (expected {want_mha} = "
        f"{vlayers}x{image_fwd} image + {tlayers}x{text_fwd} text forwards), "
        f"layer_norm_fwd {n_ln} (expected {want_ln} = "
        f"{2 * vlayers + 2}x{image_fwd} + {2 * tlayers + 1}x{text_fwd})")
    if (n_mha, n_ln) != (want_mha, want_ln):
        raise AssertionError("serving path launch counts differ from the "
                             "expected kernel launches")
    if classifier.shape != (model.cfg.embed_dim, len(classnames)):
        raise AssertionError(f"classifier shape {tuple(classifier.shape)}")
    if not torch.isfinite(classifier).all():
        raise AssertionError("classifier has non-finite values")
    for logits, top5 in answers:
        if logits.shape != (SERVE_BATCH, len(classnames)) or \
                not torch.isfinite(logits).all():
            raise AssertionError("bad logits")
        if top5.shape != (SERVE_BATCH, 5) or int(top5.min()) < 0 or \
                int(top5.max()) >= len(classnames):
            raise AssertionError("bad top-5 answers")

    fp32 = port.create_model("ViT-B-32", precision="fp32", seed=0)
    fp32.load_state_dict(model.state_dict())
    cos = (model.encode_image(requests[0])
           * fp32.encode_image(requests[0])).sum(-1)
    min_cos = float(cos.min())
    log(f"  bf16 vs fp32 image features: min per-row cosine {min_cos:.6f}")
    if min_cos < 0.999:
        raise AssertionError("bf16 features disagree with fp32 (cosine < "
                             "0.999)")

    on_card = torch.from_numpy(requests[0]).cuda()
    model_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zs.zero_shot_classification(model, classifier, on_card)
        torch.cuda.synchronize()
        model_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(latencies))
    result = {
        "card": card,
        "classifier_build_s": classifier_s,
        "request_latency_ms_median": median,
        "request_latency_ms": latencies,
        "window_s": window_s,
        "images_per_s": SERVE_REQUESTS * SERVE_BATCH / window_s,
        "on_card_batch_ms_median": float(np.median(model_ms)),
        "min_cosine_bf16_vs_fp32": min_cos,
        "launches": {"fused_mha_fwd": n_mha, "layer_norm_fwd": n_ln},
    }
    log(f"  serving: {json.dumps(result)}")
    return result


def phase_timings(mha, ln, launches, errs):
    log(f"[6] timings at the ViT-B/32 batch-{SERVE_BATCH} shapes, bf16")
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for tower, s, h, causal in (("vision", 50, 12, False),
                                ("text", 77, 8, True)):
        b, d = SERVE_BATCH, 64
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        q, k, v = (t.contiguous() for t in
                   qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        nbytes, ops = mha_cost(b, s, h, d, causal, 2)
        bms, by = bound_ms(nbytes, ops, dt)
        rows.append({
            "shape": f"{tower} B={b} S={s} H={h} D={d} causal={causal} bf16",
            "ms": cuda_ms(lambda: mha.fused_mha_fwd(qkv, h, causal=causal)),
            "plain_ms": cuda_ms(lambda: mha.fused_mha_plain(
                qkv, h, d ** -0.5, causal)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "kernel": "fused_mha_fwd"})
    for tower, s, w in (("vision", 50, 768), ("text", 77, 512)):
        n = SERVE_BATCH * s
        x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        scale_bf, bias_bf = scale.to(dt), bias.to(dt)
        nbytes, ops = ln_cost(n, w, 2)
        bms, by = bound_ms(nbytes, ops, torch.float32)
        rows.append({
            "shape": f"{tower} rows={n} W={w} bf16",
            "ms": cuda_ms(lambda: ln.layer_norm_fwd(x, scale, bias)),
            "plain_ms": cuda_ms(lambda: ln.layer_norm_plain(x, scale, bias)),
            "library_ms": cuda_ms(lambda: F.layer_norm(x, (w,), scale_bf,
                                                       bias_bf, 1e-5)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "kernel": "layer_norm_fwd"})
    for r in rows:
        log(f"  {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    meta = {
        "fused_mha_fwd": ("megatron_clip_tpu_torch/csrc/fused_mha.cu",
                          "megatron_clip_tpu/ops/pallas/fused_mha.py:80"),
        "layer_norm_fwd": ("megatron_clip_tpu_torch/csrc/layernorm.cu",
                           "megatron_clip_tpu/ops/pallas/layernorm.py:25"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main, other = [r for r in rows if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name]["bf16"],
            "max_abs_err_fp32": errs[name]["fp32"],
            "max_abs_err_bf16_vs_fp32_plain":
                errs[name]["bf16_vs_fp32_plain"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "text_tower": {k: other[k] for k in ("shape", "ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "library_ms")},
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_name_and_power_limit()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    phase_build(_build)
    errs = phase_kernels(mha, ln)
    phase_goldens(port)
    serving = phase_serving(port, mha, ln, card)
    kernels = phase_timings(mha, ln, serving["launches"], errs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
