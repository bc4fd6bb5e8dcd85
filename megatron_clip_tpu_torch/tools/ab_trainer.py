"""Time the CLIP trainer and the JPEG decoder of two checkouts of this repo
on one card.

    python megatron_clip_tpu_torch/tools/ab_trainer.py --other DIR

DIR is another checkout of the repo, for example the parent commit unpacked
with `git archive` into a gitignored directory. Both checkouts' libraries
(`fused_mha`, `layernorm` and the host JPEG decoder) are built first, at
once; then one process per run, in the order other, this, this, other. Each
process loads its checkout's `chip_smoke.py` as a module and runs, with that
checkout's port, what its phases 7 and 12 time: phase 7's train step
(ViT-B-32 pure_bf16 at chip_smoke's TRAIN_BATCH, `train_run`), the
trainer's synthetic run beside it (`trainer_synthetic`: `pretrain_clip.main`
on the same model and batch, its samples/s against phase 7's images/s and
where a step's host time goes) and the JPEG decode rates of one process on
the committed fixtures (`jpeg_decode_rates`). Prints the card, one JSON
line per metric with the four runs, and last one JSON object with every
run. Needs a CUDA device, nvcc and a C compiler.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
LIBRARIES = ("fused_mha", "layernorm", "jpeg_decode")


def run_checkout(repo: str) -> dict:
    """This process's run: phase 7's step, the trainer's synthetic run and
    the JPEG decode rates on the checkout at `repo`."""
    sys.path.insert(0, repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_checkout", Path(repo) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.factory import (get_model_config,
                                                 parse_model_cfg)
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.pretrain_clip import main
    from megatron_clip_tpu_torch.training import loop
    if not Path(port.__file__).resolve().is_relative_to(
            Path(repo).resolve()):
        raise RuntimeError(f"imported {port.__file__}, not {repo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.gpu_name_and_power_limit()
    phase7 = smoke.train_run(port, mha, ln, card, "ViT-B-32",
                             smoke.TRAIN_BATCH, smoke.TRAIN_WARMUP,
                             smoke.TRAIN_STEPS)
    per_step = smoke.per_step_launches(
        parse_model_cfg(get_model_config("ViT-B-32")), save_probs=True)
    trainer = smoke.trainer_synthetic(main, loop, mha, ln, per_step, phase7)
    decode = smoke.jpeg_decode_rates(smoke.CSV_IMAGE)
    return {"repo": repo, "card": card,
            "phase7_step_ms_median": phase7["step_ms_median"],
            "phase7_images_per_s": phase7["images_per_s"],
            "phase7_losses": phase7["losses"],
            "trainer_samples_per_s": trainer["samples_per_s"],
            "trainer_ratio": trainer["ratio"],
            "trainer_step_interval_ms_median":
                trainer["step_interval_ms_median"],
            "trainer_host_ms_in_step_median":
                trainer["host_ms_in_step_median"],
            "trainer_host_ms_between_steps_median":
                trainer["host_ms_between_steps_median"],
            "trainer_host_ms_prefetch_copy_median":
                trainer["host_ms_prefetch_copy_median"],
            "trainer_losses": trainer["losses"],
            **{f"jpeg_{mode}_images_per_s": rate["decode_images_per_s"]
               for mode, rate in decode.items()},
            **{f"jpeg_{mode}_windows_images_per_s":
               rate["decode_images_per_s_windows"]
               for mode, rate in decode.items()}}


def build_checkout(repo: str) -> None:
    """This process's build: the checkout's libraries, all compilers at
    once."""
    sys.path.insert(0, repo)
    from megatron_clip_tpu_torch.ops.kernels import _build
    _build.build(LIBRARIES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_checkout(args.run)))
        return 0
    if args.build:
        build_checkout(args.build)
        return 0
    if not args.other:
        ap.error("--other is required")
    other = str(Path(args.other).resolve())
    builds = [subprocess.Popen([sys.executable, __file__, "--build", repo],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for repo in (other, str(HERE))]
    failed = False
    for proc in builds:
        out, _ = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            failed = True
    if failed:
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    runs = []
    for repo in (other, str(HERE), str(HERE), other):
        res = subprocess.run([sys.executable, __file__, "--run", repo],
                             capture_output=True, text=True, timeout=1200,
                             cwd=repo)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for key in runs[0]:
        if key not in ("repo", "card") and not key.endswith("_losses"):
            print(json.dumps({key + " other/this/this/other":
                              [r[key] for r in runs]}))
    same = all(r[k] == runs[0][k] for r in runs
               for k in ("phase7_losses", "trainer_losses"))
    print(json.dumps({"losses equal in all four runs": same}))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
