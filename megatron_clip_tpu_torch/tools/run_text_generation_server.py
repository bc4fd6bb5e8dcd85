"""Launch the REST text-generation server.

The counterpart of the root `tools/run_text_generation_server.py`
(megatron's tools/run_text_generation_server.py and
text_generation_server.py): a GPT from a checkpoint the port's trainer
wrote (or random weights from --seed), the CLIP BPE tokenizer with its
<|endoftext|> as the EOS, served on PUT /api (`inference/server.py`).

  python -m megatron_clip_tpu_torch.tools.run_text_generation_server \\
      --load ckpt --port 5000 --num-layers 24 --hidden-size 1024 \\
      --num-heads 16 --seq-length 2048 --vocab-size 50304
  curl -X PUT http://localhost:5000/api \\
      -d '{"prompts": ["a photo of"], "tokens_to_generate": 16}'
  # on the CPU
  python -m megatron_clip_tpu_torch.tools.run_text_generation_server \\
      --device cpu --load ckpt --port 5000 ...
  # tensor parallelism over two cards: rank 0 answers on --port
  python -m torch.distributed.run --nproc-per-node 2 \\
      -m megatron_clip_tpu_torch.tools.run_text_generation_server \\
      --tensor-model-parallel-size 2 --load ckpt --port 5000 ...

Flags: --port and --load, then the port's `pretrain_gpt` flags for the
model (`gpt_cfg_from_args`: a checkpoint trained through pretrain_gpt
gives the same parameter tree here), `--device` (cuda, the default, or
cpu: without a CUDA device and without `--device cpu` it raises) and
`--dist-backend` (the tensor group's: nccl on the card, gloo on the CPU;
gloo for two ranks on one card). --load reads the `params` of the newest
checkpoint under the root (`checkpoints/io.load_checkpoint`, the trainer's
tree) and checks its names and shapes against the flags' model, which is
then built without drawing random weights. The decode computes in bf16
on the card and fp32 on the CPU, as the JAX server does; `--precision
fp32` on the card computes in fp32 (the JAX tool takes the flag and leaves
it unused).

Under torchrun the launch's ranks are the --tensor-model-parallel-size
ranks of one copy of the model (`parallel/sharding.shard_model`, the JAX
`gpt_param_specs`); rank 0 serves, the others follow
(`GenerationService.follow`) until rank 0 stops. Refused, naming their
ROADMAP Queue A item: --quantize-matmuls int8 (item 4) and
--pipeline-model-parallel-size above 1 (item 5).
"""
import argparse
import threading
from typing import Optional

import torch

from megatron_clip_tpu_torch.checkpoints.io import load_checkpoint
from megatron_clip_tpu_torch.models.gpt import GPTModel, create_gpt
from megatron_clip_tpu_torch.parallel import mesh
from megatron_clip_tpu_torch.parallel.sharding import (gpt_param_specs,
                                                       shard_model)
from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                  parse_args,
                                                  precision_from_args)


def device_from_args(args, tool: str) -> torch.device:
    """--device, else the card; raises without one."""
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA device is available; pass "
                           "--device cpu to serve on the CPU")
    return device


def load_params(root: str) -> tuple:
    """(the `params` of the newest checkpoint under `root`, its step)."""
    tree, _, step = load_checkpoint(root)
    return tree["params"], step


def build_model(cfg, precision, params: Optional[dict] = None,
                seed: int = 0) -> GPTModel:
    """`cfg`'s GPT on the CPU: `params` (a checkpoint's, whose names and
    shapes must be the model's) without drawing random weights first, or
    random weights from `seed`."""
    if params is None:
        return create_gpt(cfg, precision, device="cpu", seed=seed)
    with torch.device("meta"):
        model = GPTModel(cfg, precision)
    own = model.state_dict()
    if params.keys() != own.keys() or any(
            tuple(params[k].shape) != tuple(own[k].shape) for k in own):
        raise ValueError("the checkpoint's params do not match the model "
                         "the flags describe")
    model = model.to_empty(device="cpu").to(precision.param_torch)
    model.load_state_dict(params)
    return model


def _refuse(args) -> None:
    if args.quantize_matmuls != "none":
        raise NotImplementedError("--quantize-matmuls int8 decode weights "
                                  "are not ported yet (ROADMAP Queue A "
                                  "item 4)")
    if args.pipeline_model_parallel_size > 1:
        raise NotImplementedError("--pipeline-model-parallel-size > 1: "
                                  "pipeline-parallel serving is not ported "
                                  "yet (ROADMAP Queue A item 5)")


def build(argv=None, timeout=None):
    """The service the flags describe and the port to serve it on:
    (GenerationService, port). Under torchrun this joins the ranks' groups
    first (`timeout`, a timedelta, bounds their collectives)."""
    from megatron_clip_tpu_torch.inference.server import GenerationService
    from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--load", type=str, default=None,
                   help="checkpoint root (latest_checkpointed_iteration.txt)")
    p.add_argument("--dist-backend", type=str, default=None,
                   help="the tensor group's backend (nccl on the card, gloo "
                        "on the CPU)")
    srv_args, rest = p.parse_known_args(argv)
    args = parse_args(rest)
    _refuse(args)
    device = device_from_args(args, "run_text_generation_server")
    cfg = gpt_cfg_from_args(args)
    cfg.transformer()  # the model's refusals, before anything is loaded
    # the serving layout is tp ranks of one model: no fsdp, and the decode
    # has no sequence to split
    tp = args.tensor_model_parallel_size
    args.fsdp_parallel_size, args.sequence_parallel = 1, False
    args.dist_backend = srv_args.dist_backend
    device = mesh.init_distributed(args, device, timeout)
    lay = mesh.layout()
    if lay.dp > 1:
        raise SystemExit(f"serving takes one rank per tensor-parallel rank: "
                         f"launch --nproc-per-node {tp}, not {lay.dp * tp}")
    precision = precision_from_args(args)
    params = None
    if srv_args.load:
        params, step = load_params(srv_args.load)
        if mesh.is_main():
            print(f"loaded checkpoint @ step {step}", flush=True)
    model = build_model(cfg, precision, params, args.seed)
    if tp > 1:
        shard_model(model, gpt_param_specs(dict(model.named_parameters())),
                    lay)
        if mesh.is_main():
            print(f"serving under tp={tp}", flush=True)
    model = model.to(device).eval()
    compute = (torch.float32 if device.type == "cpu"
               else precision.compute_torch)
    tok = SimpleTokenizer()
    service = GenerationService(model, tok, eos_id=tok.eot_token_id,
                                mesh={"tensor": tp, "stage": 1},
                                compute_dtype=compute)
    return service, srv_args.port


def main(argv=None) -> None:
    from megatron_clip_tpu_torch.inference.server import run_server
    service, port = build(argv)
    try:
        if not service.leader:
            service.follow()
            return
        server = run_server(service, port=port)
        print(f"serving on :{server.server_address[1]} (PUT /api)",
              flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            server.shutdown()
        finally:
            service.stop()
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()
