#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (megatron_clip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc ($CUDA_HOME/bin or /usr/local/cuda/bin). It
imports nothing of JAX or of the JAX package. Phases, each of which raises
(and so exits non-zero) on failure:

  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: every CUDA kernel of the port from csrc/, one nvcc per source,
     all at once, and each kernel's registers and spills;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving and training paths' shapes (ViT-B/32; ViT-L/14 and
     ViT-H/14's S=257 vision towers at D=64 and D=80 and S=77 text towers,
     at batch 4 and at the legs' own batches, 64 and 24, with their
     LayerNorms at widths 768 to 1280) and at the fused-MHA gate's edge
     (2, 1024, H=2, D=128, both masks): the
     attention forward with and without the probabilities P or the row
     statistics, the attention backward from P and the recompute backward,
     the LayerNorm forward and backward, on the same inputs in fp32 and in
     bf16, and the bf16 kernel against the plain version run in fp32 on the
     same bf16 inputs (tolerances in TOLERANCES, with their reasons); then
     every attention kernel on the [B, S, *] view of S-major storage, which
     must give exactly what the contiguous tensor gives;
  4. goldens: full-width ViT-B-32-quickgelu in fp32, weights rebuilt from
     tests/goldens/full/vitb32.npz's manifest, against open_CLIP's features
     (atol 1e-4);
  5. serving: ViT-B-32 bf16 with random weights from seed 0, a zero-shot
     classifier over the 1000 ImageNet classes x 7 templates, then 8
     requests of 256 seeded NHWC images answered with top-5 classes. The
     kernels' launch counters are zeroed just before and read just after,
     and must show exactly 12 attention launches per tower forward and 26
     (image) / 25 (text) LayerNorm launches, and no backward launch; bf16
     features must agree with an fp32 run of the same weights at per-row
     cosine >= 0.999. Images per second are all the window's images over
     its wall time, the first request included; the median request latency
     is reported beside it;
  6. timings: each kernel, its plain version and one PyTorch library call
     for the same function, at the ViT-B/32 batch-256 serving shapes and
     batch-384 training shapes (the recompute backward there too, beside
     the saved-P one) and at the attention shapes of the ViT-L/14
     (batch 64) and ViT-H/14 (batch 24) legs, S-major view included, with
     the bound from bytes and operations;
  7. train: the ViT-B-32 contrastive train step of bench.py's primary leg
     (pure_bf16, batch 384, AdamW b=(0.9, 0.98) eps 1e-6 wd 0.2 with bf16
     first moments, cosine_lr(1e-3, 100, 10000), clip 1.0), 3 warm-up and
     20 timed steps on one seeded batch. The counters are zeroed just before
     and read after every step: each step must launch the attention forward
     and backward 24 times and the LayerNorm forward and backward 51 times,
     and every loss must be finite. Then one full-width fp32 step at batch 8
     on the card against the same step on the CPU (plain versions) from the
     same weights, and 10 steps in bf16 (fp32 master weights) whose loss on
     one batch must fall;
  8. legs: bench.py's ViT-L/14 (batch 64) and ViT-H/14 (batch 24) train
     legs in their recipe (pure_bf16, the step of phase 7, the recompute
     attention backward of MCT_MHA_SAVE_PROBS=0), 2 warm-up and 10 timed
     steps on one seeded batch each, the counters checked on every step
     (attention forward and recompute backward once per layer, no saved-P
     backward, LayerNorm 75 / 115 times); then ViT-L/14 with saved
     probabilities for 2 + 5 steps from the same weights and batch, whose
     first loss must equal the recompute run's and whose peak memory must
     lie above it by the bytes of every layer's P less the row statistics
     (within 2%); one more ViT-L/14 step in each mode takes the peak memory
     per stage (forward, backward, update); then one fp32 recompute step at
     full ViT-H/14 width (2 layers per tower, batch 4), card against CPU.

The last three lines of standard output are the card's name and power
limit, the {"kernels": [...]} line and {"ok": true, "device": {...}}.
"""
import json
import math
import re
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
TRAIN_BATCH = 384
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
PARITY_BATCH = 8
# the fp32 parity step: each gradient, card against CPU, within this share
# of its norm (see train_parity)
GRAD_REL_TOL = 1e-4
LEARN_STEPS = 10
# the learning check: the recipe's schedule (lr 1e-5 to 1e-4 over the 10
# steps), and the loss after LEARN_STEPS updates at most this share of the
# first. The recipe's peak reached in 10 steps instead of 100 (lr up to
# 1e-3) left the loss where it started, 5.997 -> 5.950 with a spike to 7.2
# (NVIDIA H100 80GB HBM3, 700.00 W).
LEARN_LR = (1e-3, 100, 10000)
LEARN_MAX_RATIO = 0.9
# phase 8: bench.py's legs (bench.py:190-212), in its step counts
LEGS = (("ViT-L-14", 64), ("ViT-H-14", 24))
LEG_WARMUP, LEG_STEPS = 2, 10
SAVED_P_WARMUP, SAVED_P_STEPS = 2, 5
H_PARITY_LAYERS, H_PARITY_BATCH = 2, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, atol_of_max: float = 0.0) -> float:
    """Raise unless |got - want| <= atol + atol_of_max*max|want| +
    rtol*|want| everywhere; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    atol = atol + atol_of_max * float(want.abs().max())
    err = (got - want).abs()
    worst = float(err.max())
    tol = atol + rtol * want.abs()
    excess = float((err - tol).max())
    used = float((err / tol).nan_to_num(nan=0.0).max())
    log(f"  {label}: max_abs_err={worst:.3e} (atol {atol:g}, rtol {rtol:g}; "
        f"{used:.3f} of the tolerance)")
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


def mha_cost(b: int, s: int, h: int, d: int, causal: bool, itemsize: int,
             with_probs: bool = False, with_stats: bool = False):
    """Bytes: qkv read once, output written once, and with_probs P [B, H,
    S, S] or with_stats the fp32 row max and sum written once. Operations:
    the QK^T and PV multiply-adds over the (query, key) pairs the mask
    keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = b * s * 4 * h * d * itemsize
    if with_probs:
        nbytes += b * h * s * s * itemsize
    if with_stats:
        nbytes += b * h * s * 8
    return nbytes, 4 * b * h * d * pairs


def mha_bwd_cost(b: int, s: int, h: int, d: int, causal: bool,
                 itemsize: int, recompute: bool = False):
    """Bytes: qkv, dO and P (recompute: the fp32 row max and sum instead)
    read once, dqkv written once. Operations: the dV = P^T dO, dP = dO V^T,
    dQ = dS K and dK = dS^T Q multiply-adds over the kept pairs, 8 D per
    pair, and for the recompute S = Q K^T too, 10 D per pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = b * s * 7 * h * d * itemsize
    nbytes += b * h * s * 8 if recompute else b * h * s * s * itemsize
    return nbytes, (10 if recompute else 8) * b * h * d * pairs


def ln_cost(rows: int, w: int, itemsize: int):
    """Bytes: x read and y written once, fp32 scale and bias read once.
    Operations: ~8 fp32 operations per element (mean, centring, variance,
    normalise, scale, shift)."""
    return 2 * rows * w * itemsize + 2 * w * 4, 8 * rows * w


def ln_bwd_cost(rows: int, w: int, itemsize: int):
    """Bytes: x and dy read and dx written once, fp32 scale read and dscale,
    dbias written once. Operations: ~16 fp32 operations per element (the
    statistics, xhat, the two row sums and two column sums, dx)."""
    return 3 * rows * w * itemsize + 3 * w * 4, 16 * rows * w


def kernel_fns(mha, ln) -> dict:
    return {"fused_mha_fwd": mha.fused_mha_fwd,
            "fused_mha_bwd": mha.fused_mha_bwd,
            "fused_mha_bwd_recompute": mha.fused_mha_bwd_recompute,
            "layer_norm_fwd": ln.layer_norm_fwd,
            "layer_norm_bwd": ln.layer_norm_bwd}


def zero_counts(mha, ln) -> None:
    for fn in kernel_fns(mha, ln).values():
        fn.launches = 0


def read_counts(mha, ln) -> dict:
    return {name: fn.launches for name, fn in kernel_fns(mha, ln).items()}


def phase_build(kernels_build):
    """Build every kernel, then log each one's registers and spills from
    ptxas's report, its name demangled by the CUDA toolkit's cu++filt."""
    log("[2] build")
    t0 = time.perf_counter()
    took = kernels_build.build()
    log(f"  built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in took.items()})})")
    demangle = Path(kernels_build._nvcc()).with_name("cu++filt")
    for name in took:
        report, kernel, spill = [], None, ""
        for line in kernels_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                report.append((kernel, f"{regs} registers, {spill}"))
        names = subprocess.run(
            [str(demangle), "-p", *(k for k, _ in report)],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
        for label, (_, regs) in zip(names, report):
            label = label.replace("<unnamed>::", "")
            log(f"  {name} {label}: {regs}")


# (atol, rtol[, atol as a share of max|want|]) of each comparison, by
# kernel: the kernel against its plain version on the same inputs, fp32 and
# bf16, and the bf16 kernel against the plain version run in fp32 on the
# same bf16 inputs. In bf16 the plain versions round where the kernels round
# (the attention probabilities before P.V, dS before dS.K and dS^T.Q, every
# output), so a forward must agree within one bf16 ulp; against fp32 the
# bf16 roundings themselves are allowed for.
# - fused_mha_bwd fp32: 2e-4, as tests/test_fused_mha.py holds the TPU
#   kernel's gradients. bf16: the kernel sums dP in another order than the
#   plain version, so a dS near a rounding boundary can round the other way,
#   which moves one term of dQ or dK by 2^-8 |dS K|: two bf16 ulps (rtol
#   1.6e-2) plus 2^-7 of the largest |gradient|; against fp32 the roundings
#   of P, dS and the outputs, 2e-2 relative plus 2^-5 of the largest.
# - fused_mha_bwd_recompute: the same bounds and reasons; its P is fp32 on
#   both sides, rounded only for dV, where a flip moves one term by an ulp.
# - fused_mha_fwd stats, each row's max scaled score and softmax sum: fp32
#   sums of up to 1,024 exponentials in another order than the plain
#   version's, rescaled once per 64-key tile: 1e-4 relative plus 1e-5.
# - fused_mha_fwd P, the saved probabilities: relative, as P's typical
#   value is 1/S. fp32: 1e-5 (the scores' fp32 rounding, carried by exp)
#   plus 1e-7. bf16: both sides round the same fp32 softmax to bf16, so
#   where their fp32 values straddle a rounding boundary they differ by one
#   bf16 ulp, at most 2^-7 = 7.8e-3 of the value; against fp32 the rounding
#   itself, half an ulp. Both held to rtol 8e-3 plus 1e-6.
# - layer_norm_bwd: dx as the forward's output; dscale and dbias are fp32
#   sums over up to 29,568 rows in another order than the plain version's.
#   Their rounding error follows the partial sums, not the result, so a
#   column whose sum is near 0 can be off by ulps of its neighbours'
#   hundreds: 1e-4 absolute plus 2e-6 of the largest |sum| (~16 fp32 ulps
#   of it) plus 1e-5 relative.
TOLERANCES = {
    "fused_mha_fwd": {"fp32": (2e-5, 0.0), "bf16": (4e-3, 8e-3),
                      "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "fused_mha_fwd P": {"fp32": (1e-7, 1e-5), "bf16": (1e-6, 8e-3),
                        "bf16_vs_fp32_plain": (1e-6, 8e-3)},
    "fused_mha_fwd stats": {"fp32": (1e-5, 1e-4), "bf16": (1e-5, 1e-4),
                            "bf16_vs_fp32_plain": (1e-5, 1e-4)},
    "fused_mha_bwd": {"fp32": (2e-4, 2e-4), "bf16": (0.0, 1.6e-2, 2 ** -7),
                      "bf16_vs_fp32_plain": (0.0, 2e-2, 2 ** -5)},
    "fused_mha_bwd_recompute": {
        "fp32": (2e-4, 2e-4), "bf16": (0.0, 1.6e-2, 2 ** -7),
        "bf16_vs_fp32_plain": (0.0, 2e-2, 2 ** -5)},
    "layer_norm_fwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                       "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "layer_norm_bwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                       "bf16_vs_fp32_plain": (2e-2, 2e-2),
                       "sums": (1e-4, 1e-5, 2e-6)},
}
KERNELS = tuple(TOLERANCES)


def check_kernel(errs: dict, name: str, label: str, got: torch.Tensor,
                 plain, dtype=None) -> None:
    """Hold `got` against plain(inputs in their dtype, `dtype`, by default
    got's) and, for bf16, also against plain(inputs in fp32); keep the
    worst error of each kind."""
    key = "bf16" if (dtype or got.dtype) == torch.bfloat16 else "fp32"
    checks = [(key, plain(got.dtype))]
    if key == "bf16":
        checks.append(("bf16_vs_fp32_plain", plain(torch.float32)))
    for kind, want in checks:
        e = compare(f"{name} {label} {kind}", got, want,
                    *TOLERANCES[name][kind])
        errs[name][kind] = max(errs[name].get(kind, 0.0), e)


# the attention shapes of phase 8's legs: (leg, tower, B, S, H, D, causal)
LEG_ATTENTION = (("ViT-L/14", "vision", 64, 257, 16, 64, False),
                 ("ViT-L/14", "text", 64, 77, 12, 64, True),
                 ("ViT-H/14", "vision", 24, 257, 16, 80, False),
                 ("ViT-H/14", "text", 24, 77, 16, 64, True))


def smajor_views(mha, gen) -> None:
    """Every attention kernel on the [B, S, *] view of [S, B, *] storage,
    the layout of fused_mha_packed_sm, against the same kernel on the
    contiguous tensor: the arithmetic is the same, so the results must be
    equal, and the outputs come back S-major."""
    for b, s, h, d, causal in [(8, 257, 16, 80, False), (8, 77, 16, 64, True),
                               (3, 33, 2, 40, True)]:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                              dtype=dtype)
            do = torch.randn(b, s, h * d, device="cuda", generator=gen,
                             dtype=dtype)
            qkv_v, do_v = (t.transpose(0, 1).contiguous().transpose(0, 1)
                           for t in (qkv, do))
            kw = {"causal": causal}
            out, p = mha.fused_mha_fwd(qkv, h, with_probs=True, **kw)
            _, stats = mha.fused_mha_fwd(qkv, h, with_stats=True, **kw)
            out_v, p_v = mha.fused_mha_fwd(qkv_v, h, with_probs=True, **kw)
            out_v2, stats_v = mha.fused_mha_fwd(qkv_v, h, with_stats=True,
                                                **kw)
            pairs = {
                "fwd": (mha.fused_mha_fwd(qkv_v, h, **kw), out),
                "fwd with P: out": (out_v, out), "fwd P": (p_v, p),
                "fwd with stats: out": (out_v2, out),
                "fwd stats": (stats_v, stats),
                "bwd": (mha.fused_mha_bwd(qkv_v, do_v, p, h, **kw),
                        mha.fused_mha_bwd(qkv, do, p, h, **kw)),
                "bwd_recompute": (
                    mha.fused_mha_bwd_recompute(qkv_v, do_v, stats, h, **kw),
                    mha.fused_mha_bwd_recompute(qkv, do, stats, h, **kw)),
            }
            torch.cuda.synchronize()
            for what, (got, want) in pairs.items():
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"S-major view B={b} S={s} H={h} D={d} {dtype} "
                        f"{what}: differs from the contiguous run")
            for what in ("fwd", "bwd", "bwd_recompute"):
                if pairs[what][0].stride(0) > pairs[what][0].stride(1):
                    raise AssertionError(f"S-major view: {what} output is "
                                         "not S-major")
            log(f"  S-major view B={b} S={s} H={h} D={d} causal={causal} "
                f"{dtype}: every kernel equal to its contiguous run")


def phase_kernels(mha, ln):
    """Kernel vs plain version; returns the worst errors per kernel and
    kind of comparison."""
    log("[3] kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: {} for name in KERNELS}
    for b, s, h, d, causal in [(TRAIN_BATCH, 50, 12, 64, False),
                               (TRAIN_BATCH, 77, 8, 64, True),
                               (SERVE_BATCH, 50, 12, 64, False),
                               (SERVE_BATCH, 77, 8, 64, True),
                               (4, 257, 16, 64, False),   # ViT-L vision
                               (4, 257, 16, 80, False),   # ViT-H vision
                               (4, 77, 16, 64, True),     # L/H text
                               *(leg[2:] for leg in LEG_ATTENTION),
                               (2, 1024, 2, 128, False),
                               (2, 1024, 2, 128, True),
                               (4, 197, 12, 64, False),
                               (2, 300, 4, 64, True),
                               (2, 257, 16, 80, False),
                               (3, 33, 2, 40, True),
                               (2, 45, 3, 36, True)]:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        do = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        label = f"B={b} S={s} H={h} D={d} causal={causal}"
        for dtype in (torch.float32, torch.bfloat16):
            x, g = qkv.to(dtype), do.to(dtype)

            def plain(dt, probs=False, stats=False):
                return mha.fused_mha_plain(x.to(dt), h, scale, causal,
                                           with_probs=probs, with_stats=stats)
            check_kernel(errs, "fused_mha_fwd", label,
                         mha.fused_mha_fwd(x, h, causal=causal), plain)
            out, p = mha.fused_mha_fwd(x, h, causal=causal, with_probs=True)
            check_kernel(errs, "fused_mha_fwd", label + " with P: out", out,
                         plain)
            check_kernel(errs, "fused_mha_fwd P", label, p,
                         lambda dt: plain(dt, True)[1])
            out, stats = mha.fused_mha_fwd(x, h, causal=causal,
                                           with_stats=True)
            check_kernel(errs, "fused_mha_fwd", label + " with stats: out",
                         out, plain)
            check_kernel(errs, "fused_mha_fwd stats", label, stats,
                         lambda dt: plain(dt, stats=True)[1], dtype)
            # the backward from the plain version's P, so that it alone is
            # compared; the recompute from the kernel's own statistics
            p = plain(dtype, True)[1]
            check_kernel(errs, "fused_mha_bwd", label,
                         mha.fused_mha_bwd(x, g, p, h, causal=causal),
                         lambda dt: mha.fused_mha_bwd_plain(
                             x.to(dt), g.to(dt), p.to(dt), h, scale))
            check_kernel(errs, "fused_mha_bwd_recompute", label,
                         mha.fused_mha_bwd_recompute(x, g, stats, h,
                                                     causal=causal),
                         lambda dt: mha.fused_mha_bwd_recompute_plain(
                             x.to(dt), g.to(dt), h, scale, causal))
    smajor_views(mha, gen)
    # the legs' LayerNorms: rows B*S at the tower's width H*D
    legs_ln = [(b * s, h * d) for _, _, b, s, h, d, _ in LEG_ATTENTION]
    for rows, w in [(TRAIN_BATCH * 50, 768), (TRAIN_BATCH * 77, 512),
                    (SERVE_BATCH * 50, 768), (SERVE_BATCH * 77, 512),
                    *legs_ln, (1000, 768), (5, 100), (3, 4100)]:
        x = torch.randn(rows, w, device="cuda", generator=gen) * 3 + 1
        dy = torch.randn(rows, w, device="cuda", generator=gen)
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        label = f"rows={rows} W={w}"
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), dy.to(dtype)
            check_kernel(
                errs, "layer_norm_fwd", label,
                ln.layer_norm_fwd(xd, scale, bias),
                lambda dt: ln.layer_norm_plain(xd.to(dt), scale, bias))
            dx, dscale, dbias = ln.layer_norm_bwd(xd, scale, gd)
            check_kernel(
                errs, "layer_norm_bwd", label + " dx", dx,
                lambda dt: ln.layer_norm_bwd_plain(xd.to(dt), scale,
                                                   gd.to(dt))[0])
            _, want_scale, want_bias = ln.layer_norm_bwd_plain(xd, scale, gd)
            for part, got, want in (("dscale", dscale, want_scale),
                                    ("dbias", dbias, want_bias)):
                e = compare(f"layer_norm_bwd {label} {dtype} {part}", got,
                            want, *TOLERANCES["layer_norm_bwd"]["sums"])
                errs["layer_norm_bwd"]["sums"] = max(
                    errs["layer_norm_bwd"].get("sums", 0.0), e)
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

    zero_counts(mha, ln)
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
    counts = read_counts(mha, ln)
    n_mha, n_ln = counts["fused_mha_fwd"], counts["layer_norm_fwd"]

    text_fwd = math.ceil(len(classnames) / CLASSES_PER_TEXT_BATCH)
    image_fwd = SERVE_REQUESTS
    want_mha = vlayers * image_fwd + tlayers * text_fwd
    want_ln = (2 * vlayers + 2) * image_fwd + (2 * tlayers + 1) * text_fwd
    log(f"  launches: fused_mha_fwd {n_mha} (expected {want_mha} = "
        f"{vlayers}x{image_fwd} image + {tlayers}x{text_fwd} text forwards), "
        f"layer_norm_fwd {n_ln} (expected {want_ln} = "
        f"{2 * vlayers + 2}x{image_fwd} + {2 * tlayers + 1}x{text_fwd})")
    log(f"  backward launches: fused_mha_bwd {counts['fused_mha_bwd']}, "
        f"fused_mha_bwd_recompute {counts['fused_mha_bwd_recompute']}, "
        f"layer_norm_bwd {counts['layer_norm_bwd']} (expected 0)")
    if counts != {"fused_mha_fwd": want_mha, "fused_mha_bwd": 0,
                  "fused_mha_bwd_recompute": 0,
                  "layer_norm_fwd": want_ln, "layer_norm_bwd": 0}:
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
        "launches": counts,
    }
    log(f"  serving: {json.dumps(result)}")
    return result


def timing_row(kernel: str, shape: str, fn, plain, library, cost,
               ops_dtype: torch.dtype) -> dict:
    nbytes, ops = cost
    bms, by = bound_ms(nbytes, ops, ops_dtype)
    row = {"kernel": kernel, "shape": shape, "ms": cuda_ms(fn),
           "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
           "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}
    log(f"  {kernel} {shape}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return row


def leg_attention_rows(mha, gen, leg, tower, b, s, h, d, causal) -> list:
    """bf16 rows of one leg's attention: the forward with row statistics
    and the recompute backward (at ViT-L/14 vision also the saved-P
    backward, and both on the S-major view), each beside SDPA's forward or
    backward on pre-split q, k, v."""
    dt = torch.bfloat16
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen, dtype=dt)
    do = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
    q, k, v = (t.contiguous() for t in qkv.reshape(
        b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    ldo = do.reshape(b, s, h, d).transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    shape = f"{leg} {tower} B={b} S={s} H={h} D={d} causal={causal} bf16"
    views = [("", qkv, do)]
    if leg == "ViT-L/14" and tower == "vision":
        views.append((" S-major view", *(t.transpose(0, 1).contiguous()
                                         .transpose(0, 1) for t in (qkv, do))))
    rows = []
    for tag, x, g in views:
        _, stats = mha.fused_mha_fwd(x, h, causal=causal, with_stats=True)
        rows.append(timing_row(
            "fused_mha_fwd", shape + " with stats" + tag,
            lambda: mha.fused_mha_fwd(x, h, causal=causal, with_stats=True),
            lambda: mha.fused_mha_plain(x, h, d ** -0.5, causal,
                                        with_stats=True),
            sdpa_fwd, mha_cost(b, s, h, d, causal, 2, with_stats=True), dt))
        rows.append(timing_row(
            "fused_mha_bwd_recompute", shape + tag,
            lambda: mha.fused_mha_bwd_recompute(x, g, stats, h,
                                                causal=causal),
            lambda: mha.fused_mha_bwd_recompute_plain(x, g, h, d ** -0.5,
                                                      causal),
            sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2, recompute=True),
            dt))
        if len(views) == 2 and not tag:
            _, p = mha.fused_mha_fwd(x, h, causal=causal, with_probs=True)
            rows.append(timing_row(
                "fused_mha_bwd", shape,
                lambda: mha.fused_mha_bwd(x, g, p, h, causal=causal),
                lambda: mha.fused_mha_bwd_plain(x, g, p, h, d ** -0.5),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2), dt))
            del p
    return rows


def phase_timings(mha, ln):
    """bf16 timings at the serving (batch 256) and training (batch 384)
    shapes. The library calls are yardsticks the port never calls:
    F.scaled_dot_product_attention on pre-split q/k/v and its backward, and
    F.layer_norm and its backward, the backwards by torch.autograd.grad on a
    kept graph."""
    log(f"[6] timings at the ViT-B/32 batch-{SERVE_BATCH} serving and "
        f"batch-{TRAIN_BATCH} training shapes and the ViT-L/14 and ViT-H/14 "
        "legs' attention shapes, bf16")
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for tower, s, h, causal in (("vision", 50, 12, False),
                                ("text", 77, 8, True)):
        d = 64
        for b in (SERVE_BATCH, TRAIN_BATCH):
            train = b == TRAIN_BATCH
            qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                              dtype=dt)
            q, k, v = (t.contiguous() for t in qkv.reshape(
                b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
            shape = f"{tower} B={b} S={s} H={h} D={d} causal={causal} bf16"
            rows.append(timing_row(
                "fused_mha_fwd", shape + (" with P" if train else ""),
                lambda: mha.fused_mha_fwd(qkv, h, causal=causal,
                                          with_probs=train),
                lambda: mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                            with_probs=train),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                mha_cost(b, s, h, d, causal, 2, with_probs=train), dt))
            if not train:
                continue
            do = torch.randn(b, s, h * d, device="cuda", generator=gen,
                             dtype=dt)
            _, p = mha.fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
            ldo = do.reshape(b, s, h, d).transpose(1, 2).contiguous()
            sdpa_bwd = (lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                                    retain_graph=True))
            rows.append(timing_row(
                "fused_mha_bwd", shape,
                lambda: mha.fused_mha_bwd(qkv, do, p, h, causal=causal),
                lambda: mha.fused_mha_bwd_plain(qkv, do, p, h, d ** -0.5),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2), dt))
            # the recompute backward at the same shape, for comparison
            _, stats = mha.fused_mha_fwd(qkv, h, causal=causal,
                                         with_stats=True)
            rows.append(timing_row(
                "fused_mha_bwd_recompute", shape,
                lambda: mha.fused_mha_bwd_recompute(qkv, do, stats, h,
                                                    causal=causal),
                lambda: mha.fused_mha_bwd_recompute_plain(
                    qkv, do, h, d ** -0.5, causal),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2,
                                       recompute=True), dt))
    for leg, tower, b, s, h, d, causal in LEG_ATTENTION:
        rows.extend(leg_attention_rows(mha, gen, leg, tower, b, s, h, d,
                                       causal))
    for tower, s, w in (("vision", 50, 768), ("text", 77, 512)):
        for b in (SERVE_BATCH, TRAIN_BATCH):
            n = b * s
            x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
            scale = torch.randn(w, device="cuda", generator=gen)
            bias = torch.randn(w, device="cuda", generator=gen)
            scale_bf, bias_bf = scale.to(dt), bias.to(dt)
            shape = f"{tower} rows={n} W={w} bf16"
            rows.append(timing_row(
                "layer_norm_fwd", shape,
                lambda: ln.layer_norm_fwd(x, scale, bias),
                lambda: ln.layer_norm_plain(x, scale, bias),
                lambda: F.layer_norm(x, (w,), scale_bf, bias_bf, 1e-5),
                ln_cost(n, w, 2), torch.float32))
            if b != TRAIN_BATCH:
                continue
            dy = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
            lx, ls, lb = (t.detach().requires_grad_(True)
                          for t in (x, scale_bf, bias_bf))
            ly = F.layer_norm(lx, (w,), ls, lb, 1e-5)
            rows.append(timing_row(
                "layer_norm_bwd", shape,
                lambda: ln.layer_norm_bwd(x, scale, dy),
                lambda: ln.layer_norm_bwd_plain(x, scale, dy),
                lambda: torch.autograd.grad(ly, (lx, ls, lb), dy,
                                            retain_graph=True),
                ln_bwd_cost(n, w, 2), torch.float32))
    return rows


# kernel -> (source, the TPU kernel it replaces, the TPU kernels its
# strided (S-major) launches also stand for, the shape of its headline row)
MHA_CU = "megatron_clip_tpu_torch/csrc/fused_mha.cu"
LN_CU = "megatron_clip_tpu_torch/csrc/layernorm.cu"
TPU_MHA = "megatron_clip_tpu/ops/pallas/fused_mha.py"
TPU_LN = "megatron_clip_tpu/ops/pallas/layernorm.py"
KERNEL_META = {
    "fused_mha_fwd": (MHA_CU, f"{TPU_MHA}:80", [f"{TPU_MHA}:149"],
                      f"B={TRAIN_BATCH} "),
    "fused_mha_bwd": (MHA_CU, f"{TPU_MHA}:118", [], f"B={TRAIN_BATCH} "),
    "fused_mha_bwd_recompute": (MHA_CU, f"{TPU_MHA}:131",
                                [f"{TPU_MHA}:171"],
                                "ViT-L/14 vision B=64 "),
    "layer_norm_fwd": (LN_CU, f"{TPU_LN}:25", [], f"rows={TRAIN_BATCH * 50} "),
    "layer_norm_bwd": (LN_CU, f"{TPU_LN}:82", [], f"rows={TRAIN_BATCH * 50} "),
}


def kernels_line(rows, launches_by_path, errs) -> list:
    """One entry per kernel: its launches on the main paths (the serving
    run, the ViT-B/32 train run and the ViT-L/14 and ViT-H/14 recompute
    runs, each zeroed before and read after; `launches_by_path` splits
    them), the worst error of phase 3, and the timings of its headline row,
    every timed shape listed under `shapes`."""
    kernels = []
    for name, (source, replaces, also, headline) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if headline in r["shape"])
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name]["bf16"],
            "max_abs_err_fp32": errs[name]["fp32"],
            "max_abs_err_bf16_vs_fp32_plain":
                errs[name]["bf16_vs_fp32_plain"],
            **({"max_abs_err_column_sums": errs[name]["sums"]}
               if "sums" in errs[name] else {}),
            **{f"max_abs_err_{part}": errs[f"{name} {part}"]
               for part in ("P", "stats") if f"{name} {part}" in errs},
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")} for r in mine],
        })
    return kernels


def clip_train_flops_per_image(cfg) -> float:
    """bench.py's count (clip_train_flops_per_image and
    transformer_flops_per_token): forward matmul FLOPs of both towers and
    the patch embed, times 3 for forward plus backward."""
    def per_token(layers, width, mlp_hidden, seq):
        proj = 2 * width * (3 * width) + 2 * width * width
        attn = 2 * seq * width * 2
        mlp = 2 * width * mlp_hidden * 2
        return layers * (proj + attn + mlp)
    v, t = cfg.vision, cfg.text
    sv, st = v.seq_len, t.context_length
    fv = per_token(v.layers, v.width, int(v.width * 4), sv) * sv
    fv += 2 * sv * (v.patch_size ** 2 * 3) * v.width
    ft = per_token(t.layers, t.width, int(t.width * 4), st) * st
    return 3 * (fv + ft)


def train_batch(cfg, batch: int, seed: int):
    """Images as bench.py makes them (standard normal NHWC) and token ids
    in [1, vocab - 2], from numpy with `seed`, on the card."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, cfg.vision.image_size, cfg.vision.image_size, 3),
        dtype=np.float32)
    texts = rng.integers(1, cfg.text.vocab_size - 2,
                         (batch, cfg.text.context_length))
    return torch.from_numpy(images).cuda(), torch.from_numpy(texts).cuda()


def per_step_launches(cfg, save_probs: bool) -> dict:
    """Kernel launches of one train step: one attention forward and one
    backward (from P or recomputing) per layer, LayerNorm forward and
    backward 2 per block plus ln_pre, ln_post and ln_final."""
    layers = cfg.vision.layers + cfg.text.layers
    return {"fused_mha_fwd": layers,
            "fused_mha_bwd": layers if save_probs else 0,
            "fused_mha_bwd_recompute": 0 if save_probs else layers,
            "layer_norm_fwd": 2 * layers + 3,
            "layer_norm_bwd": 2 * layers + 3}


def stage_memory(model, opt, step, state, images, texts) -> dict:
    """One more step, with the allocator's peak taken per stage (GiB): the
    forward (to the model's output), the backward (to the optimizer's
    update) and the update; and what is allocated when the forward ends:
    weights, optimizer state and every tensor saved for the backward."""
    gib = 2 ** -30
    marks = {}

    def end_of_forward(*_):
        marks["forward_peak"] = torch.cuda.max_memory_allocated() * gib
        marks["after_forward"] = torch.cuda.memory_allocated() * gib
        torch.cuda.reset_peak_memory_stats()

    def start_of_update(*args, update=opt.update):
        marks["backward_peak"] = torch.cuda.max_memory_allocated() * gib
        torch.cuda.reset_peak_memory_stats()
        return update(*args)
    hook = model.register_forward_hook(end_of_forward)
    opt.update = start_of_update
    torch.cuda.synchronize()
    marks["before_step"] = torch.cuda.memory_allocated() * gib
    torch.cuda.reset_peak_memory_stats()
    step(state, images, texts)
    torch.cuda.synchronize()
    marks["update_peak"] = torch.cuda.max_memory_allocated() * gib
    hook.remove()
    del opt.update
    return marks


def train_run(port, mha, ln, card: str, name: str, batch: int, warmup: int,
              steps: int, save_probs: bool = True,
              with_stage_memory: bool = False) -> dict:
    """`warmup` + `steps` pure_bf16 steps of `name` in bench.py's recipe
    (AdamW b=(0.9, 0.98) eps 1e-6 wd 0.2, bf16 first moments,
    cosine_lr(1e-3, 100, 10000), clip 1.0) on one batch from numpy seed 0,
    random weights from seed 0. The counters are zeroed before the first
    step and read after every step, which must launch each kernel exactly
    as per_step_launches says; every loss must be finite. Step times are
    CUDA-event intervals between step starts; images/s is the timed steps'
    images over the window's wall time; peak memory is taken over the
    steps, the weights included, and over each step on its own.
    with_stage_memory: then stage_memory."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    model = port.create_model(name, precision="pure_bf16", seed=0,
                              attn_save_probs=save_probs).train()
    opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                         grad_clip_norm=1.0, moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    images, texts = train_batch(model.cfg, batch, seed=0)
    per_step = per_step_launches(model.cfg, save_probs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events, step_peaks = [], [], []
    zero_counts(mha, ln)
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            window0 = time.perf_counter()
        before = read_counts(mha, ln)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        state, metrics = step(state, images, texts)
        losses.append(metrics["loss"])
        step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        got = {k: v - before[k] for k, v in read_counts(mha, ln).items()}
        if got != per_step:
            raise AssertionError(f"{name} step {i}: launches {got}, "
                                 f"expected {per_step}")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    window_s = time.perf_counter() - window0
    launches = read_counts(mha, ln)
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warmup:-1],
                                                 events[warmup + 1:])]
    losses = torch.stack(losses).float().tolist()
    log(f"  {name} launches per step {per_step}; total {launches}")
    log(f"  {name} losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite training loss")
    ips = batch * steps / window_s
    flops = clip_train_flops_per_image(model.cfg)
    result = {
        "card": card, "model": name, "batch": batch,
        "precision": "pure_bf16",
        "attention_backward": "saved P" if save_probs else "recompute",
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_mean": float(np.mean(step_ms)),
        "step_ms_min": float(np.min(step_ms)), "step_ms": step_ms,
        "window_s": window_s, "images_per_s": ips,
        "flops_per_image": flops,
        "mfu": ips * flops / PEAK_OPS_PER_S[torch.bfloat16],
        "peak_memory_gib": max(step_peaks),
        "step_peak_memory_gib": step_peaks,
        "losses": losses, "launches": launches,
        "launches_per_step": per_step,
    }
    if with_stage_memory:
        result["stage_memory_gib"] = stage_memory(model, opt, step, state,
                                                  images, texts)
    del model, opt, state, step, metrics
    torch.cuda.empty_cache()
    return result


def phase_train(port, mha, ln, card: str):
    log(f"[7] train: ViT-B-32 pure_bf16, batch {TRAIN_BATCH}, "
        f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps")
    result = train_run(port, mha, ln, card, "ViT-B-32", TRAIN_BATCH,
                       TRAIN_WARMUP, TRAIN_STEPS)
    result["parity"] = train_parity(port, "ViT-B-32", PARITY_BATCH)
    result["learning"] = train_learns(port)
    log(f"  train: {json.dumps(result)}")
    return result


def phase_legs(port, mha, ln, card: str) -> dict:
    log(f"[8] legs: {', '.join(f'{n} batch {b}' for n, b in LEGS)}, "
        f"pure_bf16, recompute attention backward, {LEG_WARMUP} warm-up + "
        f"{LEG_STEPS} timed steps")
    name, batch = LEGS[0]
    runs = {leg: train_run(port, mha, ln, card, leg, b, LEG_WARMUP,
                           LEG_STEPS, save_probs=False,
                           with_stage_memory=leg == name)
            for leg, b in LEGS}
    log(f"  {name} with saved probabilities, {SAVED_P_WARMUP} + "
        f"{SAVED_P_STEPS} steps")
    saved = train_run(port, mha, ln, card, name, batch, SAVED_P_WARMUP,
                      SAVED_P_STEPS, save_probs=True, with_stage_memory=True)
    rec = runs[name]
    spared = saved["peak_memory_gib"] - rec["peak_memory_gib"]
    log(f"  {name} first loss: recompute {rec['losses'][0]!r}, saved P "
        f"{saved['losses'][0]!r}; peak memory recompute "
        f"{rec['peak_memory_gib']:.3f} GiB, saved P "
        f"{saved['peak_memory_gib']:.3f} GiB ({spared:.3f} GiB apart)")
    if saved["losses"][0] != rec["losses"][0]:
        raise AssertionError("the first loss depends on the attention's "
                             "backward mode")
    # Both runs peak early in the backward, when every tensor saved for it
    # is held (stage_memory), so their peaks must lie apart by what the
    # saved-P run saves beyond the recompute run: every layer's P [B, H, S,
    # S] in bf16, less the fp32 row statistics [2, B, H, S] that the
    # recompute run saves instead (3.07 GiB at ViT-L/14 batch 64). Within
    # 2%: the caching allocator counts a whole cached block when what would
    # be left of it is under 1 MiB, so equal requests can count a little
    # more in one run than in the other.
    from megatron_clip_tpu_torch.factory import get_model_config
    cfg = get_model_config(name)
    p_bytes = sum(cfg[f"{tower}_cfg"]["layers"] * b * h * s * (2 * s - 8)
                  for leg, tower, b, s, h, _, _ in LEG_ATTENTION
                  if leg.replace("/", "-") == name)
    log(f"  {name} memory by stage, recompute {rec['stage_memory_gib']}, "
        f"saved P {saved['stage_memory_gib']}; P less the statistics "
        f"{p_bytes / 2 ** 30:.4f} GiB")
    if abs(spared * 2 ** 30 - p_bytes) > 0.02 * p_bytes:
        raise AssertionError(f"the peaks lie {spared:.3f} GiB apart, not "
                             f"P's {p_bytes / 2 ** 30:.3f} GiB less the "
                             "statistics")
    h = get_model_config("ViT-H-14")
    overrides = {tower: dict(h[tower], layers=H_PARITY_LAYERS)
                 for tower in ("vision_cfg", "text_cfg")}
    result = {"runs": runs, "saved_p": saved, "spared_gib": spared,
              "parity": train_parity(port, "ViT-H-14", H_PARITY_BATCH,
                                     save_probs=False, **overrides)}
    log(f"  legs: {json.dumps(result)}")
    return result


def train_parity(port, name: str, batch: int, save_probs: bool = True,
                 **overrides) -> dict:
    """One fp32 step of `name` (full width; `overrides` may cut its depth)
    at `batch`, on the card (the kernels) and on the CPU (their plain
    versions), from the same weights and batch. Loss and grad_norm within
    1e-5 relative. Each parameter's gradient, before the update, within
    GRAD_REL_TOL of its norm: sums in another order move a gradient by
    ~1e-6 of its norm, a leaf whose sum cancels by more, and a fault in one
    layer's backward by far more (Adam's first update, lr sign(g), cannot
    show it). Every parameter within 1e-6 absolute after the step, a tenth
    of the step's lr (1e-5): Adam moves an element by lr g/(|g| + eps), and
    gradients that differ by ~1e-6 relative move it by at most lr 1e-6 / 4,
    except where a gradient is rounding noise, whose update, g/eps lr, stays
    far below the bound."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    out, data = {}, None
    for device in ("cuda", "cpu"):
        model = port.create_model(name, precision="fp32", seed=0,
                                  device=device, attn_save_probs=save_probs,
                                  **overrides).train()
        if data is None:
            data = train_batch(model.cfg, batch, seed=1)
        images, texts = data
        opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                             grad_clip_norm=1.0)
        grads, update = {}, opt.update

        def keep_grads(state, g, update=update, grads=grads):
            grads.update({n: t.detach().cpu() for n, t in g.items()})
            return update(state, g)
        opt.update = keep_grads
        t0 = time.perf_counter()
        _, m = make_train_step(model, opt)(TrainState.create(model, opt),
                                           images.to(device),
                                           texts.to(device))
        out[device] = (float(m["loss"]), float(m["grad_norm"]), grads,
                       {n: p.detach().cpu()
                        for n, p in model.named_parameters()},
                       time.perf_counter() - t0)
        # opt.update -> keep_grads -> update (bound to opt) is a reference
        # cycle: left to the garbage collector, the card's model stays
        # allocated into the next phase and lifts its peak memory
        del opt.update
        del model, opt
    (lc, gc, dc, pc, tc), (lp, gp, dp, pp, tp) = out["cuda"], out["cpu"]
    grad_errs = {n: float((dc[n] - dp[n]).norm() / dp[n].norm())
                 for n in dp}
    worst_leaf = max(grad_errs, key=grad_errs.get)
    worst = max(float((pc[n] - pp[n]).abs().max()) for n in pp)
    res = {"loss_cuda": lc, "loss_cpu": lp, "grad_norm_cuda": gc,
           "grad_norm_cpu": gp, "loss_rel_err": abs(lc - lp) / abs(lp),
           "grad_norm_rel_err": abs(gc - gp) / abs(gp),
           "grad_worst_leaf": worst_leaf,
           "grad_worst_leaf_rel_err": grad_errs[worst_leaf],
           "param_max_abs_err": worst, "step_s_cuda": tc, "step_s_cpu": tp}
    log(f"  fp32 step of {name} ({'saved P' if save_probs else 'recompute'}"
        f"), card vs CPU: {json.dumps(res)}")
    if res["loss_rel_err"] > 1e-5 or res["grad_norm_rel_err"] > 1e-5 \
            or grad_errs[worst_leaf] > GRAD_REL_TOL or worst > 1e-6:
        raise AssertionError("the fp32 step on the card disagrees with the "
                             "CPU")
    torch.cuda.empty_cache()
    return res


def train_learns(port) -> dict:
    """LEARN_STEPS updates under `bf16` (fp32 master weights, bf16 compute
    and first moments) on phase 7's batch at cosine_lr(*LEARN_LR); the loss
    after them must be at most LEARN_MAX_RATIO of the first."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    model = port.create_model("ViT-B-32", precision="bf16", seed=0).train()
    opt = make_optimizer(model, cosine_lr(*LEARN_LR), grad_clip_norm=1.0,
                         moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    images, texts = train_batch(model.cfg, TRAIN_BATCH, seed=0)
    losses = []
    for _ in range(LEARN_STEPS + 1):  # the last loss is after the updates
        state, m = step(state, images, texts)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().tolist()
    res = {"lr": LEARN_LR, "losses": losses,
           "ratio": losses[-1] / losses[0]}
    log(f"  bf16 learning: {json.dumps(res)}")
    if not all(math.isfinite(v) for v in losses) or \
            res["ratio"] > LEARN_MAX_RATIO:
        raise AssertionError(f"bf16 loss did not fall to "
                             f"{LEARN_MAX_RATIO} of its first value")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return res


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
    rows = phase_timings(mha, ln)
    train = phase_train(port, mha, ln, card)
    legs = phase_legs(port, mha, ln, card)
    paths = {"serving ViT-B-32": serving["launches"],
             "train ViT-B-32": train["launches"],
             **{f"train {name} recompute": run["launches"]
                for name, run in legs["runs"].items()}}
    kernels = kernels_line(rows, paths, errs)
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
