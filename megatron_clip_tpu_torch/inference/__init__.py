"""Text generation: the KV-cache decode, beam search and the REST server
(the counterparts of `megatron_clip_tpu/inference/`)."""
from megatron_clip_tpu_torch.inference.generation import (  # noqa: F401
    KVCache, generate, greedy_generate)
