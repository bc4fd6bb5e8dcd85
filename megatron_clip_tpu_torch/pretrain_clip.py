"""CLIP pretraining entry point of the port.

The counterpart of the root `pretrain_clip.py` for one device:

  # on the card, ViT-B/32 on webdataset shards
  python -m megatron_clip_tpu_torch.pretrain_clip --model ViT-B-32 \\
      --train-data 'shards/{00000..00099}.tar' --batch-size 256 \\
      --precision bf16 --save logs --save-interval 1000

  # on the CPU, a tiny model on synthetic data
  python -m megatron_clip_tpu_torch.pretrain_clip --device cpu \\
      --model test-tiny --dataset-type synthetic --batch-size 16 \\
      --precision fp32 --warmup 2 --log-interval 1

Flags: `training/params.py` (the JAX parser's, plus `--device`); the flags
of modules the port does not carry yet raise NotImplementedError naming
their ROADMAP Queue A item.
"""
from megatron_clip_tpu_torch.training.loop import run_training
from megatron_clip_tpu_torch.training.params import parse_args


def main(argv=None):
    args = parse_args(argv)
    metrics = run_training(args)
    print("final:", metrics, flush=True)
    return metrics


if __name__ == "__main__":
    main()
