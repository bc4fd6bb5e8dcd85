"""Time the fused CE backward and the fused flash backward of two checkouts
of this repo on one card.

    python megatron_clip_tpu_torch/tools/ab_backward.py --other DIR

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. One process per run, in the
order other, this, this, other. Each process imports the port from its
checkout, builds that checkout's `fused_ce.cu` and `flash_attention.cu`,
and times through the wrappers both checkouts share (`fused_ce_bwd`,
`flash_bwd_fused`, `flash_bwd_fused_dropout`), mean of CUDA events after
warm-up, warm L2:
- the fused CE backward, bf16, tied head, T = 16384, V = 50304, at the
  example GPT's W = 1024 and the pipeline GPT's W = 2048, beside the
  library's `autograd.grad` of `F.cross_entropy(x @ w)`; and, where the
  checkout's backward adds its products with float2 atomics (the kernel
  before the Hopper redesign), the same kernel built with those atomics
  replaced by plain stores: a timing-only build, wrong by design, that
  shows what the atomics cost;
- the fused flash backward, bf16, causal, on the packed projection's head
  views: GPT-345m's B = 6, S = 2048, H = 16, D = 64 (rate 0) and the
  pipeline GPT's B = 8, S = 2048, H = 16, D = 128 at rate 0 and 0.1,
  beside SDPA's backward (`dropout_p` alike).
Inputs come from a seeded generator, so both checkouts get the same ones.
Prints the card, one JSON line per row with the four runs' times, and
last one JSON object with every run. Needs a CUDA device and nvcc.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CE_ROWS = ((16384, 1024, 50304), (16384, 2048, 50304))
# (label, B, S, H, D, rate)
FLASH_ROWS = (("GPT-345m", 6, 2048, 16, 64, 0.0),
              ("pipeline GPT", 8, 2048, 16, 128, 0.0),
              ("pipeline GPT", 8, 2048, 16, 128, 0.1))
REPS, WARMUP = 10, 2
# the float2 atomics of the pre-Hopper backward's add_tile
_ATOMIC = re.compile(r"atomicAdd\(reinterpret_cast<float2\*>\(([^;]*?)\),"
                     r"\s*(make_float2\([^;]*?\))\);")


def no_atomics_library(build, ce):
    """The checkout's fused_ce.cu with add_tile's atomics made plain stores,
    built beside its other libraries; None if it has no such atomics."""
    import ctypes
    src = (build.CSRC / "fused_ce.cu").read_text()
    patched, n = _ATOMIC.subn(r"*reinterpret_cast<float2*>(\1) = \2;", src)
    if n == 0:
        return None
    if n != 2:
        raise RuntimeError(f"expected add_tile's 2 float2 atomics, found {n}")
    work = build.BUILD_DIR / "no_atomics"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (work / header.name).write_bytes(header.read_bytes())
    (work / "fused_ce.cu").write_text(patched)
    out = work / "libfused_ce_no_atomics.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(work / "fused_ce.cu")], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in ce._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def time_checkout(repo: str) -> dict:
    """This process's run: the kernels of the checkout at `repo`."""
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    if not Path(ce.__file__).resolve().is_relative_to(Path(repo).resolve()):
        raise RuntimeError(f"imported {ce.__file__}, not from {repo}")
    _build.build(["fused_ce", "flash_attention"])

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

    dt = torch.bfloat16
    rows = []
    no_atomics = no_atomics_library(_build, ce)
    for t, w, v in CE_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(t + w + v)
        x = torch.randn(t, w, device="cuda", generator=gen).to(dt)
        emb = (torch.randn(v, w, device="cuda", generator=gen) * 0.05).to(dt)
        head = emb.t()
        labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
        dloss = torch.rand(t, device="cuda", generator=gen) / t
        _, lse = ce.fused_ce_fwd(x, head, labels)
        lx, lw = (a.detach().requires_grad_(True) for a in (x, head))
        ly = F.cross_entropy(lx @ lw, labels, reduction="none")
        row = {"row": f"fused_ce_bwd T={t} W={w} V={v} tied bf16",
               "ms": ms(lambda: ce.fused_ce_bwd(x, head, labels, lse, dloss)),
               "library_ms": ms(lambda: torch.autograd.grad(
                   ly, (lx, lw), dloss.to(dt), retain_graph=True))}
        if no_atomics is not None:
            key = ("fused_ce", ())
            kept = _build._libs.get(key)
            _build._libs[key] = no_atomics
            try:
                row["no_atomics_ms"] = ms(lambda: ce.fused_ce_bwd(
                    x, head, labels, lse, dloss))
            finally:
                _build._libs[key] = kept
        rows.append(row)
        del x, emb, head, lx, lw, ly, lse
        torch.cuda.empty_cache()
    for label, b, s, h, d, rate in FLASH_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                         dtype=dt).transpose(1, 2)
        q, k, vv = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                        4).unbind(0)
        drop = AttentionDropout(rate, 1234, 1) if rate else None
        out, lse = (fa.flash_fwd(q, k, vv, causal=True) if drop is None else
                    fa.flash_fwd_dropout(q, k, vv, drop, causal=True))
        lq, lk, lv = (a.contiguous().requires_grad_(True) for a in (q, k, vv))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            dropout_p=rate)
        ldo = do.contiguous()
        if drop is None:
            fn = (lambda: fa.flash_bwd_fused(q, k, vv, out, lse, do,
                                             causal=True))
        else:
            fn = (lambda: fa.flash_bwd_fused_dropout(q, k, vv, out, lse, do,
                                                     drop, causal=True))
        rows.append({
            "row": f"flash_bwd_fused {label} B={b} S={s} H={h} D={d} causal "
                   f"rate={rate} bf16",
            "ms": ms(fn),
            "library_ms": ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), ldo, retain_graph=True))})
        del qkv, do, q, k, vv, out, lse, lq, lk, lv, lo, ldo
        torch.cuda.empty_cache()
    return {"repo": repo, "rows": rows}


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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    runs = []
    for repo in (args.other, str(HERE), str(HERE), args.other):
        res = subprocess.run([sys.executable, __file__, "--time", repo],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for i, first in enumerate(runs[0]["rows"]):
        rows = [run["rows"][i] for run in runs]
        line = {"row": first["row"]}
        for key in ("ms", "library_ms", "no_atomics_ms"):
            got = [r.get(key) for r in rows]
            if any(g is not None for g in got):
                line[f"{key} other/this/this/other"] = got
        print(json.dumps(line))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
