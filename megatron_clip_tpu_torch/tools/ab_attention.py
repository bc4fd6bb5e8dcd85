"""Time the bf16 attention kernels of two checkouts of this repo on one card.

    python megatron_clip_tpu_torch/tools/ab_attention.py --other DIR

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. One process per run, in the
order other, this, this, other, so that a drift of the card over the call
shows as a difference between the two runs of one checkout. Each process
imports the port from its checkout, builds that checkout's `fused_mha.cu`,
`flash_attention.cu` and `layernorm.cu` and, with the API both checkouts
share, times (mean of 20 launches after 3 by CUDA events, warm L2, the launches queued
behind a device-side wait so that they run back to back):
- the forward with P and the saved-P backward (`fused_mha_fwd(...,
  with_probs=True)`, `fused_mha_bwd`) at the ViT-B/32 train shapes (batch
  384) and the ViT-L/14 and ViT-H/14 vision shapes (batch 64 and 24);
- the forwards of the recompute and GPT paths, beside SDPA's forward on
  contiguous q, k, v (`dropout_p` alike), with each port call's host ms
  (the wall time of issuing the calls, the device left to lag): the fused
  forward with row statistics (`fused_mha_fwd(..., with_stats=True)`,
  `fused_mha_dropout_fwd`) at the pipeline GPT's B = 32, S = 512, H = 16,
  D = 128, causal, rate 0 and 0.1, at ViT-L/14's vision and text towers
  and at ViT-H/14's vision tower (B = 24, S = 257, H = 16, D = 80); the
  flash forward (`flash_fwd`, `flash_fwd_dropout`) on the packed
  projection's head views at the pipeline GPT's B = 8, S = 2048, D = 128,
  rate 0 and 0.1, and GPT-345m's B = 6, D = 64; the fused forward alone
  (no P, no statistics) at the ViT-B/32 serving shapes (batch 256), and
  with statistics at ViT-H/14's text tower (B = 24, S = 77, H = 16);
- the LayerNorm and RMSNorm forwards (`layer_norm_fwd`, `rms_norm_fwd`)
  at the paths' rows and widths, beside `F.layer_norm` / `F.rms_norm`.
Inputs come from a seeded generator, so the two checkouts get the same
ones; a hash of each output's bytes says whether they give the same bits.
Prints the card, each run's register report (ptxas) for the saved-P
kernels, then one JSON line per shape and, last, one JSON object with every
run. Needs a CUDA device and nvcc.
"""
import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# (label, B, S, H, D, causal)
SHAPES = (("ViT-B/32 vision", 384, 50, 12, 64, False),
          ("ViT-B/32 text", 384, 77, 8, 64, True),
          ("ViT-L/14 vision", 64, 257, 16, 64, False),
          ("ViT-H/14 vision", 24, 257, 16, 80, False))
# the forwards' rows: (kernel, label, B, S, H, D, causal, rate)
FORWARDS = (("fused_mha_fwd with stats", "pipeline GPT", 32, 512, 16, 128,
             True, 0.0),
            ("fused_mha_fwd with stats", "pipeline GPT", 32, 512, 16, 128,
             True, 0.1),
            ("fused_mha_fwd with stats", "ViT-L/14 vision", 64, 257, 16, 64,
             False, 0.0),
            ("fused_mha_fwd with stats", "ViT-L/14 text", 64, 77, 12, 64,
             True, 0.0),
            ("fused_mha_fwd with stats", "ViT-H/14 vision", 24, 257, 16, 80,
             False, 0.0),
            ("fused_mha_fwd with stats", "ViT-H/14 text", 24, 77, 16, 64,
             True, 0.0),
            ("fused_mha_fwd", "ViT-B/32 serving vision", 256, 50, 12, 64,
             False, 0.0),
            ("fused_mha_fwd", "ViT-B/32 serving text", 256, 77, 8, 64, True,
             0.0),
            ("flash_fwd", "pipeline GPT", 8, 2048, 16, 128, True, 0.0),
            ("flash_fwd", "pipeline GPT", 8, 2048, 16, 128, True, 0.1),
            ("flash_fwd", "GPT-345m", 6, 2048, 16, 64, True, 0.0))
# the norms' forwards: (kernel, label, rows, width); rows B S of each
# tower or GPT at its batch
NORMS = (("layer_norm_fwd", "ViT-B/32 vision", 384 * 50, 768),
         ("layer_norm_fwd", "ViT-B/32 text", 384 * 77, 512),
         ("layer_norm_fwd", "ViT-B/32 serving vision", 256 * 50, 768),
         ("layer_norm_fwd", "ViT-B/32 serving text", 256 * 77, 512),
         ("layer_norm_fwd", "ViT-L/14 vision", 64 * 257, 1024),
         ("layer_norm_fwd", "ViT-H/14 vision", 24 * 257, 1280),
         ("layer_norm_fwd", "GPT-345m", 6 * 2048, 1024),
         ("layer_norm_fwd", "pipeline GPT", 8 * 2048, 2048),
         ("rms_norm_fwd", "example GPT", 8 * 2048, 1024))
REPS, WARMUP = 20, 3
QUEUE_CYCLES = 4_000_000


def time_checkout(repo: str) -> dict:
    """This process's run: the kernels of the checkout at `repo`."""
    sys.path.insert(0, repo)
    import torch
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    if not Path(mha.__file__).resolve().is_relative_to(Path(repo).resolve()):
        raise RuntimeError(f"imported {mha.__file__}, not from {repo}")
    _build.build(["fused_mha", "flash_attention", "layernorm"])
    regs = [line.strip() for line in
            _build.build_log("fused_mha").splitlines()
            if "registers" in line or "Compiling entry" in line]

    def ms(fn) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the window behind a device-side wait (~2 ms) while the host
        # enqueues its calls: they run back to back, timed by the device
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    def digest(t) -> str:
        return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    rows = []
    for label, b, s, h, d, causal in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        do = torch.randn(b, s, h * d, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        out, p = mha.fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
        dqkv = mha.fused_mha_bwd(qkv, do, p, h, causal=causal)
        rows.append({
            "shape": f"{label} B={b} S={s} H={h} D={d} causal={causal}",
            "fwd_with_p_ms": ms(lambda: mha.fused_mha_fwd(
                qkv, h, causal=causal, with_probs=True)),
            "bwd_ms": ms(lambda: mha.fused_mha_bwd(qkv, do, p, h,
                                                   causal=causal)),
            "bits": {"out": digest(out), "p": digest(p),
                     "dqkv": digest(dqkv)}})
        del qkv, do, out, p, dqkv
    return {"repo": repo, "registers": regs, "rows": rows,
            "forwards": time_forwards(ms, digest),
            "norms": time_norms(ms, digest)}


def time_norms(ms, digest) -> list:
    """The NORMS rows of the checkout imported: kernel and library ms."""
    import torch
    import torch.nn.functional as F
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    rows = []
    for kernel, label, n, w in NORMS:
        gen = torch.Generator(device="cuda").manual_seed(n + w)
        x = torch.randn(n, w, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        scale, bias = (torch.randn(w, device="cuda", generator=gen)
                       for _ in range(2))
        sb, bb = scale.bfloat16(), bias.bfloat16()
        if kernel == "rms_norm_fwd":
            def fn():
                return ln.rms_norm_fwd(x, scale)

            def lib():
                return F.rms_norm(x, (w,), sb, 1e-6)
        else:
            def fn():
                return ln.layer_norm_fwd(x, scale, bias)

            def lib():
                return F.layer_norm(x, (w,), sb, bb, 1e-5)
        rows.append({"row": f"{kernel} {label} rows={n} W={w} bf16",
                     "ms": ms(fn), "library_ms": ms(lib),
                     "bits": {"out": digest(fn())}})
        del x
    return rows


def time_forwards(ms, digest) -> list:
    """The FORWARDS rows of the checkout imported: kernel, host and SDPA
    ms."""
    import torch
    import torch.nn.functional as F
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        took = time.perf_counter() - t0
        torch.cuda.synchronize()
        return took * 1e3 / REPS

    rows = []
    for kernel, label, b, s, h, d, causal, rate in FORWARDS:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                       4).unbind(0)
        drop = AttentionDropout(rate, 1234, 1) if rate else None
        if kernel == "flash_fwd":
            fn = ((lambda: fa.flash_fwd(q, k, v, causal=causal))
                  if drop is None else
                  (lambda: fa.flash_fwd_dropout(q, k, v, drop,
                                                causal=causal)))
        elif kernel == "fused_mha_fwd":
            def fn():
                return mha.fused_mha_fwd(qkv, h, causal=causal), None
        else:
            fn = ((lambda: mha.fused_mha_fwd(qkv, h, causal=causal,
                                             with_stats=True))
                  if drop is None else
                  (lambda: mha.fused_mha_dropout_fwd(qkv, h, drop,
                                                     causal=causal)))
        out, res = fn()
        lq, lk, lv = (t.contiguous() for t in (q, k, v))
        rows.append({
            "row": f"{kernel} {label} B={b} S={s} H={h} D={d} "
                   f"causal={causal} rate={rate} bf16",
            "ms": ms(fn), "host_ms": host_ms(fn),
            "library_ms": ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, dropout_p=rate)),
            "bits": {"out": digest(out),
                     "residual": "" if res is None
                     else digest(res.view(torch.bfloat16))}})
        del qkv, q, k, v, lq, lk, lv, out, res
        torch.cuda.empty_cache()
    return rows


def saved_p_registers(report: list) -> list:
    """'kernel: N registers' for the saved-P tensor-core kernels at D=64 and
    D=80 from a ptxas report (mangled names kept as ptxas prints them)."""
    out, kernel = [], None
    for line in report:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and re.search(r"(bwd_dq|bwd_dkdv)ILi(64|80)E", kernel):
            out.append(f"{kernel}: {line}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_checkout(args.time)))
        return 0
    if not args.other:
        ap.error("--other is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    runs = []
    for repo in (args.other, str(HERE), str(HERE), args.other):
        res = subprocess.run([sys.executable, __file__, "--time", repo],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    names = ["other", "this", "this", "other"]
    for name, run in zip(names[:2], runs[:2]):
        print(f"{name} ({run['repo']}) registers:")
        for line in saved_p_registers(run["registers"]):
            print(f"  {line}")
    for i, _ in enumerate(SHAPES):
        rows = [run["rows"][i] for run in runs]
        print(json.dumps({
            "shape": rows[0]["shape"],
            "fwd_with_p_ms other/this/this/other":
                [r["fwd_with_p_ms"] for r in rows],
            "bwd_ms other/this/this/other": [r["bwd_ms"] for r in rows],
            "same_bits": {k: len({r["bits"][k] for r in rows}) == 1
                          for k in ("out", "p", "dqkv")}}))
    for i, first in enumerate(runs[0]["forwards"]):
        rows = [run["forwards"][i] for run in runs]
        print(json.dumps({
            "row": first["row"],
            "ms other/this/this/other": [r["ms"] for r in rows],
            "host_ms other/this/this/other": [r.get("host_ms")
                                              for r in rows],
            "library_ms other/this/this/other":
                [r["library_ms"] for r in rows],
            "same_bits": {k: len({r["bits"][k] for r in rows}) == 1
                          for k in ("out", "residual")}}))
    for i, first in enumerate(runs[0]["norms"]):
        rows = [run["norms"][i] for run in runs]
        print(json.dumps({
            "row": first["row"],
            "ms other/this/this/other": [r["ms"] for r in rows],
            "library_ms other/this/this/other":
                [r["library_ms"] for r in rows],
            "same_bits": len({r["bits"]["out"] for r in rows}) == 1}))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
