"""Time the bf16 attention kernels of two checkouts of this repo on one card.

    python megatron_clip_tpu_torch/tools/ab_attention.py --other DIR

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. One process per run, in the
order other, this, this, other, so that a drift of the card over the call
shows as a difference between the two runs of one checkout. Each process
imports the port from its checkout, builds that checkout's `fused_mha.cu`
and, with the API both checkouts share (`fused_mha_fwd(..., with_probs=True)`
and `fused_mha_bwd`), times the forward with P and the saved-P backward:
mean of 20 launches after 3 by CUDA events, warm L2, at the ViT-B/32 train
shapes (batch 384) and the ViT-L/14 and ViT-H/14 vision shapes (batch 64
and 24). Inputs come from a seeded generator, so the two checkouts get the
same ones; a hash of each output's bytes says whether they give the same
bits. Prints each run's register report (ptxas) for the saved-P kernels,
then one JSON line per shape and, last, one JSON object with every run.
Needs a CUDA device and nvcc.
"""
import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# (label, B, S, H, D, causal)
SHAPES = (("ViT-B/32 vision", 384, 50, 12, 64, False),
          ("ViT-B/32 text", 384, 77, 8, 64, True),
          ("ViT-L/14 vision", 64, 257, 16, 64, False),
          ("ViT-H/14 vision", 24, 257, 16, 80, False))
REPS, WARMUP = 20, 3


def time_checkout(repo: str) -> dict:
    """This process's run: the kernels of the checkout at `repo`."""
    sys.path.insert(0, repo)
    import torch
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    if not Path(mha.__file__).resolve().is_relative_to(Path(repo).resolve()):
        raise RuntimeError(f"imported {mha.__file__}, not from {repo}")
    _build.build(["fused_mha"])
    regs = [line.strip() for line in
            _build.build_log("fused_mha").splitlines()
            if "registers" in line or "Compiling entry" in line]

    def ms(fn) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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
    return {"repo": repo, "registers": regs, "rows": rows}


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
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
