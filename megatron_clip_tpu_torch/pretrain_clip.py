"""CLIP pretraining entry point of the port.

The counterpart of the root `pretrain_clip.py`, on one device or
data-parallel over the processes of a torchrun launch:

  # on the card, ViT-B/32 on webdataset shards
  python -m megatron_clip_tpu_torch.pretrain_clip --model ViT-B-32 \\
      --train-data 'shards/{00000..00099}.tar' --batch-size 256 \\
      --precision bf16 --save logs --save-interval 1000

  # the same on the 8 cards of one node: --batch-size is the global batch
  # (256 a card here), --workers the decode workers of each rank
  python -m torch.distributed.run --nproc-per-node 8 \\
      -m megatron_clip_tpu_torch.pretrain_clip --model ViT-B-32 \\
      --train-data 'shards/{00000..00099}.tar' --batch-size 2048 \\
      --precision bf16 --save logs --save-interval 1000

  # across 2 nodes (run on each, --node-rank 0 and 1)
  python -m torch.distributed.run --nnodes 2 --node-rank 0 \\
      --nproc-per-node 8 --master-addr HOST0 --master-port 29500 \\
      -m megatron_clip_tpu_torch.pretrain_clip --batch-size 4096 ...

  # on the CPU, a tiny model on synthetic data
  python -m megatron_clip_tpu_torch.pretrain_clip --device cpu \\
      --model test-tiny --dataset-type synthetic --batch-size 16 \\
      --precision fp32 --warmup 2 --log-interval 1

Flags: `training/params.py` (the JAX parser's, plus `--device`); the flags
of modules the port does not carry yet raise NotImplementedError naming
their ROADMAP Queue A item. Under torchrun `run_training` joins the
process group (`parallel/mesh.py`) and leaves it on every exit path; rank 0
alone prints.
"""
import os

from megatron_clip_tpu_torch.training.loop import run_training
from megatron_clip_tpu_torch.training.params import parse_args


def main(argv=None):
    args = parse_args(argv)
    metrics = run_training(args)
    if int(os.environ.get("RANK", "0")) == 0:
        print("final:", metrics, flush=True)
    return metrics


if __name__ == "__main__":
    main()
