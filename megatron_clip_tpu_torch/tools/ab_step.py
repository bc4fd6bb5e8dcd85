"""Time the train steps of two checkouts of this repo on one card.

    python megatron_clip_tpu_torch/tools/ab_step.py --other DIR \
        [--leg "--model gpt-pipeline --seq 512"] \
        [--leg "--model ViT-L-14 --batch 64 --recompute"] \
        [--leg "--model ViT-H-14 --batch 24 --recompute"]

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. Each `--leg` takes the
options of `tools/profile_train.py` (model, batch, seq, fused CE,
recompute); the three above are the default. Both checkouts' kernels are
built first, at once; then, for each leg, one process per run in the order
other, this, this, other. Each process imports the port from its checkout
and builds the step with that checkout's `tools/profile_train.py` (the
model from seed 0, its optimizer and its seeded batch on the card), takes
WARMUP steps, then times STEPS steps as chip_smoke.py does: a CUDA event
recorded at each step's start, no synchronisation between steps, so a
step's time includes what the device waits for the host. Beside the step
ms (median, mean, fastest) each run gives the host's CPU ms per step
(`time.process_time`, every thread of the process: it counts the host's
waits for a full launch queue too) and the loss of every step, warm-up
included, read after the timed steps. Prints the card, one JSON line per
leg with the four runs, and last one JSON object with every run. Needs a
CUDA device and nvcc.
"""
import argparse
import json
import shlex
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
LEGS = ("--model gpt-pipeline --seq 512",
        "--model ViT-L-14 --batch 64 --recompute",
        "--model ViT-H-14 --batch 24 --recompute")
WARMUP, STEPS = 3, 12


def leg_args(leg: str) -> argparse.Namespace:
    """profile_train's options of one leg."""
    ap = argparse.ArgumentParser(prog="leg")
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--fused-ce", action="store_true")
    ap.add_argument("--recompute", action="store_true")
    return ap.parse_args(shlex.split(leg))


def time_leg(repo: str, leg: str) -> dict:
    """This process's run: one leg on the checkout at `repo`."""
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from megatron_clip_tpu_torch.tools import profile_train
    if not Path(profile_train.__file__).resolve().is_relative_to(
            Path(repo).resolve()):
        raise RuntimeError(f"imported {profile_train.__file__}, not {repo}")
    args = leg_args(leg)
    make = (profile_train._gpt_step if args.model.startswith("gpt-")
            else profile_train._clip_step)
    run, about = make(args)
    losses = [run()["loss"] for _ in range(WARMUP)]
    torch.cuda.synchronize()
    events = []
    cpu0 = time.process_time()
    for _ in range(STEPS):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(run()["loss"])
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    cpu_s = time.process_time() - cpu0
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"repo": repo, "leg": leg, **about,
            "step_ms_median": float(np.median(step_ms)),
            "step_ms_mean": float(np.mean(step_ms)),
            "step_ms_min": float(np.min(step_ms)), "step_ms": step_ms,
            "host_cpu_ms_per_step": cpu_s * 1e3 / STEPS,
            "losses": [float(v) for v in losses]}


def build_checkout(repo: str) -> None:
    """This process's build: the checkout's libraries, all nvcc processes
    at once."""
    sys.path.insert(0, repo)
    from megatron_clip_tpu_torch.ops.kernels import _build
    _build.build()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--leg", action="append",
                    help="profile_train options of one leg (repeatable)")
    ap.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_leg(*args.time)))
        return 0
    if args.build:
        build_checkout(args.build)
        return 0
    if not args.other:
        ap.error("--other is required")
    builds = [subprocess.Popen([sys.executable, __file__, "--build", repo],
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
    for leg in args.leg or LEGS:
        four = []
        for repo in (args.other, str(HERE), str(HERE), args.other):
            res = subprocess.run([sys.executable, __file__, "--time", repo,
                                  leg], capture_output=True, text=True,
                                 timeout=1200)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            four.append(json.loads(res.stdout.strip().splitlines()[-1]))
        line = {"leg": leg}
        for key in ("step_ms_median", "step_ms_mean", "step_ms_min",
                    "host_cpu_ms_per_step", "losses"):
            line[f"{key} other/this/this/other"] = [r[key] for r in four]
        print(json.dumps(line))
        runs += four
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
