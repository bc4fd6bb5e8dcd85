"""Time the fused CE forward and backward, the fused and the split flash
backward, the fused-MHA recompute backward and the LayerNorm and RMSNorm
backwards of two checkouts of this repo on one card.

    python megatron_clip_tpu_torch/tools/ab_backward.py --other DIR \
        [--rows all|norm]

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. Both checkouts' kernels are
built first, at once; then one process per run, in the order other, this,
this, other. Each process imports the port from its checkout and times
through the wrappers both checkouts share (`fused_ce_fwd`, `fused_ce_bwd`,
`flash_bwd_fused`, `flash_bwd_dq`, `flash_bwd_dkv` and their dropout
twins, `fused_mha_bwd`, `fused_mha_bwd_recompute`, `fused_mha_dropout_bwd`,
`layer_norm_bwd`, `rms_norm_bwd`),
mean of CUDA events after warm-up, warm L2, the calls queued behind a
device-side wait so that the device's time is read and not the host's,
and each port call's host time (`host_ms`:
the wall time of issuing the calls, the device left to lag; map encoding,
launch set-up and launches):
- the fused CE forward and backward, bf16, tied head, T = 16384, V =
  50304, at the example GPT's W = 1024 and the pipeline GPT's W = 2048,
  beside the library's `F.cross_entropy(x @ w)` and its `autograd.grad`;
  and, where the checkout's backward adds its products with float2 atomics
  (the kernel before the Hopper redesign), the same kernel built with those
  atomics replaced by plain stores: a timing-only build, wrong by design,
  that shows what the atomics cost;
- the fused flash backward, bf16, causal, on the packed projection's head
  views: GPT-345m's B = 6, S = 2048, H = 16, D = 64 (rate 0) and the
  pipeline GPT's B = 8, S = 2048, H = 16, D = 128 at rate 0 and 0.1,
  beside SDPA's backward (`dropout_p` alike);
- the split flash backward (`flash_bwd_dq` and `flash_bwd_dkv`, or their
  dropout twins; `ms` their sum), bf16, causal, on the packed projection's
  head views at S = 8192: GPT-345m's B = 1, H = 16, D = 64 (rate 0) and the
  pipeline GPT's B = 1, H = 16, D = 128 at rate 0 and 0.1, beside the fused
  flash backward at the same shape and SDPA's backward (`dropout_p`
  alike); and, where the checkout's dKV runs on `hop::bwd_dkv`, the same
  wrapper on a timing-only build that runs `hop::bwd_fused` less its dQ
  product and reduce-adds instead (`fused_dkv_ms`: the other plan for
  dKV; its dK and dV must equal the fused backward's);
- the fused-MHA recompute backward, bf16, on the packed projection and the
  forward's row statistics: the pipeline GPT's B = 32, S = 512, H = 16,
  D = 128, causal, at rate 0 and 0.1, ViT-L/14's vision tower, B = 64,
  S = 257, H = 16, D = 64, and ViT-H/14's, B = 24, S = 257, H = 16,
  D = 80, and both text towers (ViT-L/14's B = 64, H = 12 and ViT-H/14's
  B = 24, H = 16, S = 77, D = 64, causal), beside SDPA's backward;
- the fused-MHA saved-P backward, bf16, from the forward's P, at
  ViT-B/32's training shapes (B = 384: vision S = 50, H = 12; text S = 77,
  H = 8, causal), beside SDPA's backward;
- the LayerNorm and RMSNorm backwards at every path's rows (NORM_ROWS),
  bf16 rows, the scale in the path's dtype, beside `autograd.grad` of
  `F.layer_norm` / `F.rms_norm` (on bf16 parameters), with each call's
  kernels and their device us from torch.profiler (`kernels_us`: the rows'
  kernel, the sum over blocks and any cast kernel, by name).
`--rows norm` times the norm rows alone (~1 min of command time).
Inputs come from a seeded generator, so both checkouts get the same ones.
Prints the card, one JSON line per row with the four runs' times, and
last one JSON object with every run. Needs a CUDA device and nvcc.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CE_ROWS = ((16384, 1024, 50304), (16384, 2048, 50304))
# (label, B, S, H, D, rate)
FLASH_ROWS = (("GPT-345m", 6, 2048, 16, 64, 0.0),
              ("pipeline GPT", 8, 2048, 16, 128, 0.0),
              ("pipeline GPT", 8, 2048, 16, 128, 0.1))
# the split pair's: (label, B, S, H, D, rate)
SPLIT_ROWS = (("GPT-345m", 1, 8192, 16, 64, 0.0),
              ("pipeline GPT", 1, 8192, 16, 128, 0.0),
              ("pipeline GPT", 1, 8192, 16, 128, 0.1))
# (label, B, S, H, D, causal, rate)
RECOMPUTE_ROWS = (("pipeline GPT", 32, 512, 16, 128, True, 0.0),
                  ("pipeline GPT", 32, 512, 16, 128, True, 0.1),
                  ("ViT-L/14 vision", 64, 257, 16, 64, False, 0.0),
                  ("ViT-H/14 vision", 24, 257, 16, 80, False, 0.0),
                  ("ViT-L/14 text", 64, 77, 12, 64, True, 0.0),
                  ("ViT-H/14 text", 24, 77, 16, 64, True, 0.0))
# the saved-P backward's: (label, B, S, H, D, causal)
SAVED_ROWS = (("ViT-B/32 vision", 384, 50, 12, 64, False),
              ("ViT-B/32 text", 384, 77, 8, 64, True))
# the norm backwards': (path, kernel, rows, W, scale dtype), the rows of a
# step's batch at the tower's or model's width; the scale bf16 on the
# pure_bf16 legs (CLIP, GPT-345m), fp32 for the GPTs on fp32 weights
NORM_ROWS = (("ViT-B/32 b384 vision", "layer_norm", 384 * 50, 768, "bf16"),
             ("ViT-B/32 b384 text", "layer_norm", 384 * 77, 512, "bf16"),
             ("ViT-L/14 b64 vision", "layer_norm", 64 * 257, 1024, "bf16"),
             ("ViT-L/14 b64 text", "layer_norm", 64 * 77, 768, "bf16"),
             ("ViT-H/14 b24 vision", "layer_norm", 24 * 257, 1280, "bf16"),
             ("ViT-H/14 b24 text", "layer_norm", 24 * 77, 1024, "bf16"),
             ("GPT-345m b6", "layer_norm", 6 * 2048, 1024, "bf16"),
             ("pipeline GPT b8", "layer_norm", 8 * 2048, 2048, "fp32"),
             ("example GPT b8", "rms_norm", 8 * 2048, 1024, "fp32"))
LIBRARIES = ["fused_ce", "flash_attention", "fused_mha", "layernorm"]
NORM_REPS = 20
REPS, WARMUP = 10, 2
# cycles of the device-side wait before a timing window (~2 ms on an H100)
QUEUE_CYCLES = 4_000_000
# hop::bwd_fused as a dKV kernel: its dS K product, its dQ boxes and their
# reduce-adds, and the split dKV wrapper's call of hop::launch_dkv
_FUSED_DQ_PRODUCT = re.compile(
    r"for \(int kk = 0; kk < kKeys / 16; \+\+kk\)\n(\s*wgmma_ss<1, 1>\(dq,)")
_FUSED_DQ_REDUCE = re.compile(
    r"\n    // the fp32 partial of dQ staged.*?bulk_commit\(\);\n    \}\n",
    re.S)
_SPLIT_DKV_CALL = re.compile(
    r"return hop::launch_dkv<DP>\(q, k, v, g, lse, delta, dk, dv, B, H, Sq,"
    r"\s*Sk,")
# the float2 atomics of the pre-Hopper backward's add_tile
_ATOMIC = re.compile(r"atomicAdd\(reinterpret_cast<float2\*>\(([^;]*?)\),"
                     r"\s*(make_float2\([^;]*?\))\);")


def no_atomics_library(build, ce):
    """The checkout's fused_ce.cu with add_tile's atomics made plain stores,
    built beside its other libraries; None if it has no such atomics."""
    src = (build.CSRC / "fused_ce.cu").read_text()
    patched, n = _ATOMIC.subn(r"*reinterpret_cast<float2*>(\1) = \2;", src)
    if n == 0:
        return None
    if n != 2:
        raise RuntimeError(f"expected add_tile's 2 float2 atomics, found {n}")
    return _patched_library(build, ce._SIGNATURES, "fused_ce", patched,
                            "no_atomics")


def _patched_library(build, sigs, name: str, src: str, tag: str):
    """`src` as csrc/<name>.cu built beside the checkout's headers into a
    library of its own, loaded with the wrapper's signatures `sigs`."""
    import ctypes
    work = build.BUILD_DIR / tag
    work.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (work / header.name).write_bytes(header.read_bytes())
    (work / f"{name}.cu").write_text(src)
    out = work / f"lib{name}_{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(work / f"{name}.cu")], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def fused_dkv_library(build, fa):
    """The checkout's flash_attention.cu with the split dKV wrapper sending
    bf16 D = 64 and 128 to hop::bwd_fused less its dS K product, dQ boxes
    and reduce-adds (the fused kernel as a dKV kernel; its dK and dV are
    the fused kernel's, its dq map is encoded on dk and never touched), the
    other plan for the split dKV: a timing-only build. None where the
    checkout has no hop::launch_dkv (the kernel before the Hopper split)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    src, n_call = _SPLIT_DKV_CALL.subn(
        "return hop::launch<DP>(q, k, v, g, lse, delta, dk, dv, "
        "reinterpret_cast<float*>(dk.p), B, H, Sq, Sk,", src)
    if n_call == 0:
        return None
    src, n_product = _FUSED_DQ_PRODUCT.subn(
        r"for (int kk = 0; kk < 0; ++kk)\n\1", src)
    src, n_reduce = _FUSED_DQ_REDUCE.subn("\n", src)
    if (n_call, n_product, n_reduce) != (1, 1, 1):
        raise RuntimeError("fused dKV build: expected one split dKV call, one "
                           "dS K product and one reduce-add block, found "
                           f"{n_call}, {n_product}, {n_reduce}")
    return _patched_library(build, fa._SIGNATURES, "flash_attention", src,
                            "fused_dkv")


def kernel_split(fn, calls: int = 10) -> dict:
    """The device kernels of one call of `fn` from torch.profiler: each
    kernel's device us a call by name (template arguments kept), and the
    kernels a call launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = re.sub(r"\((?!anonymous namespace\)).*$", "", e.name)
            by[key] = by.get(key, 0.0) + (e.time_range.end
                                          - e.time_range.start) / calls
            n += 1
    return {"kernels_us": by, "kernels_a_call": n / calls}


def time_norms(ms, host_ms) -> list:
    """The NORM_ROWS of the checkout imported: kernel, host and library ms,
    and the call's kernels."""
    import torch
    import torch.nn.functional as F
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    dt = torch.bfloat16
    rows = []
    for path, kind, n, w, pdt in NORM_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(n + w)
        x = (torch.randn(n, w, device="cuda", generator=gen) * 3 + 1).to(dt)
        dy = torch.randn(n, w, device="cuda", generator=gen).to(dt)
        scale, bias = (torch.randn(w, device="cuda", generator=gen)
                       for _ in range(2))
        scale = scale.to(dt) if pdt == "bf16" else scale
        lx, ls, lb = (a.detach().to(dt).requires_grad_(True)
                      for a in (x, scale, bias))
        if kind == "layer_norm":
            def fn():
                return ln.layer_norm_bwd(x, scale, dy)
            ly, lib_in = F.layer_norm(lx, (w,), ls, lb, 1e-5), (lx, ls, lb)
        else:
            def fn():
                return ln.rms_norm_bwd(x, scale, dy)
            ly, lib_in = F.rms_norm(lx, (w,), ls, 1e-6), (lx, ls)
        rows.append({
            "row": f"{kind}_bwd {path} rows={n} W={w} bf16, scale {pdt}",
            "ms": ms(fn, NORM_REPS), "host_ms": host_ms(fn),
            "library_ms": ms(lambda: torch.autograd.grad(
                ly, lib_in, dy, retain_graph=True), NORM_REPS),
            **kernel_split(fn)})
        del x, dy, lx, ly, lib_in
        torch.cuda.empty_cache()
    return rows


def time_checkout(repo: str, only: str = "all") -> dict:
    """This process's run: the kernels of the checkout at `repo` (`only`
    "norm": the norm rows alone)."""
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    if not Path(ce.__file__).resolve().is_relative_to(Path(repo).resolve()):
        raise RuntimeError(f"imported {ce.__file__}, not from {repo}")
    _build.build(["layernorm"] if only == "norm" else LIBRARIES)

    def ms(fn, reps: int = REPS) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the window starts behind a device-side wait long enough for the
        # host to enqueue every call: a call whose host side takes longer
        # than its kernels is timed by its kernels
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        took = time.perf_counter() - t0
        torch.cuda.synchronize()
        return took * 1e3 / REPS

    dt = torch.bfloat16
    rows = time_norms(ms, host_ms)
    if only == "norm":
        return {"repo": repo, "rows": rows}
    no_atomics = no_atomics_library(_build, ce)
    fused_dkv = fused_dkv_library(_build, fa)
    for t, w, v in CE_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(t + w + v)
        x = torch.randn(t, w, device="cuda", generator=gen).to(dt)
        emb = (torch.randn(v, w, device="cuda", generator=gen) * 0.05).to(dt)
        head = emb.t()
        labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
        dloss = torch.rand(t, device="cuda", generator=gen) / t
        _, lse = ce.fused_ce_fwd(x, head, labels)
        fwd = (lambda: ce.fused_ce_fwd(x, head, labels))
        rows.append({
            "row": f"fused_ce_fwd T={t} W={w} V={v} tied bf16",
            "ms": ms(fwd), "host_ms": host_ms(fwd),
            "library_ms": ms(lambda: F.cross_entropy(
                x @ head, labels, reduction="none"))})
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
    for label, b, s, h, d, rate in SPLIT_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d + 1)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                         dtype=dt).transpose(1, 2)
        q, k, vv = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1,
                                                        4).unbind(0)
        drop = AttentionDropout(rate, 1234, 1) if rate else None
        args = () if drop is None else (drop,)
        out, lse = (fa.flash_fwd(q, k, vv, causal=True) if drop is None else
                    fa.flash_fwd_dropout(q, k, vv, drop, causal=True))
        delta = fa.flash_delta(do, out)
        if drop is None:
            dq_fn, dkv_fn, fused_fn = (fa.flash_bwd_dq, fa.flash_bwd_dkv,
                                       fa.flash_bwd_fused)
        else:
            dq_fn, dkv_fn, fused_fn = (fa.flash_bwd_dq_dropout,
                                       fa.flash_bwd_dkv_dropout,
                                       fa.flash_bwd_fused_dropout)
        lq, lk, lv = (a.contiguous().requires_grad_(True) for a in (q, k, vv))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            dropout_p=rate)
        ldo = do.contiguous()
        row = {"row": f"flash_bwd_dq + flash_bwd_dkv {label} B={b} S={s} "
                      f"H={h} D={d} causal rate={rate} bf16",
               "dq_ms": ms(lambda: dq_fn(q, k, vv, do, lse, delta, *args,
                                         causal=True)),
               "dkv_ms": ms(lambda: dkv_fn(q, k, vv, do, lse, delta, *args,
                                           causal=True)),
               "fused_ms": ms(lambda: fused_fn(q, k, vv, out, lse, do, *args,
                                               causal=True)),
               "library_ms": ms(lambda: torch.autograd.grad(
                   lo, (lq, lk, lv), ldo, retain_graph=True))}
        row["ms"] = row["dq_ms"] + row["dkv_ms"]
        if fused_dkv is not None:
            key = ("flash_attention", ())
            kept = _build._libs.get(key)
            _build._libs[key] = fused_dkv
            try:
                got = dkv_fn(q, k, vv, do, lse, delta, *args, causal=True)
                row["fused_dkv_ms"] = ms(lambda: dkv_fn(
                    q, k, vv, do, lse, delta, *args, causal=True))
            finally:
                _build._libs[key] = kept
            want = fused_fn(q, k, vv, out, lse, do, *args, causal=True)[1:]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError("the fused dKV build's dK, dV differ from "
                                   "the fused backward's")
        rows.append(row)
        del qkv, do, q, k, vv, out, lse, delta, lq, lk, lv, lo, ldo
        torch.cuda.empty_cache()
    for label, b, s, h, d, causal, rate in RECOMPUTE_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        drop = AttentionDropout(rate, 1234, 1) if rate else None
        if drop is None:
            _, stats = mha.fused_mha_fwd(qkv, h, causal=causal,
                                         with_stats=True)
            fn = (lambda: mha.fused_mha_bwd_recompute(qkv, g, stats, h,
                                                      causal=causal))
        else:
            _, stats = mha.fused_mha_dropout_fwd(qkv, h, drop, causal=causal)
            fn = (lambda: mha.fused_mha_dropout_bwd(qkv, g, stats, h, drop,
                                                    causal=causal))
        lq, lk, lv = (t.contiguous().requires_grad_(True) for t in qkv.reshape(
            b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                            dropout_p=rate)
        ldo = g.reshape(b, s, h, d).transpose(1, 2).contiguous()
        shape = (f"{label} B={b} S={s} H={h} D={d} causal={causal} "
                 f"rate={rate} bf16")
        rows.append({
            "row": f"fused_mha recompute bwd {shape}", "ms": ms(fn),
            "host_ms": host_ms(fn),
            "library_ms": ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), ldo, retain_graph=True))})
        del qkv, g, stats, lq, lk, lv, lo, ldo
        torch.cuda.empty_cache()
    for label, b, s, h, d, causal in SAVED_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(b * s * h * d + 2)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        _, p = mha.fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
        fn = (lambda: mha.fused_mha_bwd(qkv, g, p, h, causal=causal))
        lq, lk, lv = (t.contiguous().requires_grad_(True) for t in qkv.reshape(
            b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        ldo = g.reshape(b, s, h, d).transpose(1, 2).contiguous()
        rows.append({
            "row": f"fused_mha saved-P bwd {label} B={b} S={s} H={h} D={d} "
                   f"causal={causal} bf16", "ms": ms(fn),
            "host_ms": host_ms(fn),
            "library_ms": ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), ldo, retain_graph=True))})
        del qkv, g, p, lq, lk, lv, lo, ldo
        torch.cuda.empty_cache()
    return {"repo": repo, "rows": rows}


def build_checkout(repo: str, only: str = "all") -> None:
    """This process's build: the checkout's libraries, all nvcc processes
    at once."""
    sys.path.insert(0, repo)
    from megatron_clip_tpu_torch.ops.kernels import _build
    _build.build(["layernorm"] if only == "norm" else LIBRARIES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rows", choices=("all", "norm"), default="all",
                    help="every row, or the norm backwards' alone")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_checkout(args.time, args.rows)))
        return 0
    if args.build:
        build_checkout(args.build, args.rows)
        return 0
    if not args.other:
        ap.error("--other is required")
    builds = [subprocess.Popen([sys.executable, __file__, "--build", repo,
                                "--rows", args.rows],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for repo in (args.other, str(HERE))]
    for proc in builds:
        out, _ = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    runs = []
    for repo in (args.other, str(HERE), str(HERE), args.other):
        res = subprocess.run([sys.executable, __file__, "--time", repo,
                              "--rows", args.rows],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for i, first in enumerate(runs[0]["rows"]):
        rows = [run["rows"][i] for run in runs]
        line = {"row": first["row"]}
        for key in ("ms", "dq_ms", "dkv_ms", "fused_dkv_ms", "fused_ms",
                    "host_ms", "library_ms", "no_atomics_ms", "kernels_us",
                    "kernels_a_call"):
            got = [r.get(key) for r in rows]
            if any(g is not None for g in got):
                line[f"{key} other/this/this/other"] = got
        print(json.dumps(line))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
