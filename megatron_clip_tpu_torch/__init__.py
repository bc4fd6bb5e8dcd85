"""PyTorch/CUDA port of megatron_clip_tpu.

A second package beside the JAX one, which stays the reference. Entry points
run on the CUDA device unless the caller asks for the CPU; every TPU kernel
on a ported path is a hand-written Hopper kernel under `csrc/`.

`create_model`, `get_tokenizer` and `tokenize` are imported on first use, so
that importing a module that needs no torch (the data tools, the
tokenizers) does not import it: `tools/preprocess_data.py`'s workers start
in a fraction of a second.
"""


def __getattr__(name: str):
    if name == "create_model":
        from megatron_clip_tpu_torch.factory import create_model
        return create_model
    if name in ("get_tokenizer", "tokenize"):
        from megatron_clip_tpu_torch import tokenizer
        return getattr(tokenizer, name)
    raise AttributeError(f"module 'megatron_clip_tpu_torch' has no "
                         f"attribute {name!r}")
