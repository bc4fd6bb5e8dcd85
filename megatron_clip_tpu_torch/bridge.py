"""Carry weights into the port's modules.

Weight layout. The port keeps the JAX package's layout: a Linear weight is
stored [in, out] and applied as `x @ w` (never transposed into nn.Linear's
[out, in]); the patch embed is [p*p*3, W] with patch features in (py, px, c)
order; the token embedding is [vocab, W]. State-dict keys mirror the JAX
pytree paths joined with dots, with the stacked layer axis of `blocks`
unstacked into `blocks.{i}`:

  JAX pytree                              port state dict
  visual/patch_embed/w  [p*p*3, W]        visual.patch_embed.w
  visual/cls, pos_embed, proj             visual.cls, .pos_embed, .proj
  visual/ln_pre|ln_post/{scale,bias}      visual.ln_pre.scale, ...
  */blocks/attn/wqkv    [L, W, 3W]        *.blocks.{i}.attn.wqkv  [W, 3W]
  (likewise bqkv, wo, bo, mlp/w1|b1|w2|b2, ln_1|ln_2/{scale,bias})
  text/tok_embed, pos_embed               text.tok_embed, text.pos_embed
  text/ln_final/{scale,bias}, proj/w      text.ln_final.scale, text.proj.w
  logit_scale  []                         logit_scale

The same flattening carries an optax state's moments (`opt_state_from_jax`)
and maps a JAX gradient tree onto the port's names. A GPT tree
(`gpt_params_from_jax`) flattens the same way: tok_embed, pos_embed
(learned positions only; a rope GPT has none), ln_f/{scale,bias} (rmsnorm:
scale only), lm_head (untied) and blocks/* -> blocks.{i}.*, whatever the
leaves' widths: the swiglu w1 [W, 2 * ffn] and b1, the grouped-query wqkv
[W, (H + 2 Hkv) D].
"""
from typing import Any, Dict, Union

import numpy as np
import torch

from megatron_clip_tpu_torch.config import CLIPCfg
from megatron_clip_tpu_torch.models.gpt import GPTCfg
from megatron_clip_tpu_torch.training.optim import OptState


def _flatten(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if k == "blocks":
            n = None
            stacked = {}
            _flatten(v, "", stacked)
            for sub, arr in stacked.items():
                n = arr.shape[0] if n is None else n
                if arr.shape[0] != n:
                    raise ValueError(f"{key}.{sub}: layer axis {arr.shape[0]} "
                                     f"!= {n}")
                for i in range(n):
                    out[f"{key}.{i}.{sub}"] = arr[i]
        elif isinstance(v, dict):
            _flatten(v, key + ".", out)
        else:
            out[key] = np.asarray(v, dtype=np.float32)


def _unstacked(tree: Dict[str, Any], towers, device, dtype
               ) -> Dict[str, torch.Tensor]:
    """`tree` flattened onto the port's names as tensors; `towers` maps
    each prefix of a `blocks` stack ('' for the root) to its layer count,
    which the tree must hold."""
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, "", out)
    for tower, layers in towers.items():
        prefix = f"{tower}.blocks." if tower else "blocks."
        found = {int(k[len(prefix):].split(".")[0]) for k in out
                 if k.startswith(prefix)}
        if found != set(range(layers)):
            raise ValueError(f"{tower or 'GPT'}: {len(found)} layers in the "
                             f"tree, config says {layers}")
    return {k: torch.from_numpy(np.array(v)).to(device, dtype)
            for k, v in out.items()}


def params_from_jax(tree: Dict[str, Any], cfg: CLIPCfg,
                    device: Union[str, torch.device, None] = "cpu",
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """JAX CLIP param pytree (nested dicts of numpy or jax arrays) -> the
    port's state dict, ready for `model.load_state_dict`. `cfg` checks the
    layer counts."""
    return _unstacked(tree, {"visual": cfg.vision.layers,
                             "text": cfg.text.layers}, device, dtype)


def gpt_params_from_jax(tree: Dict[str, Any], cfg: GPTCfg,
                        device: Union[str, torch.device, None] = "cpu",
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """JAX GPT param pytree (`init_gpt`'s, nested dicts of numpy or jax
    arrays) -> a `GPTModel`'s state dict, the `blocks` layer axis
    unstacked. `cfg` checks the layer count."""
    return _unstacked(tree, {"": cfg.num_layers}, device, dtype)


def _nodes(tree):
    yield tree
    if isinstance(tree, (tuple, list)):
        for child in tree:
            yield from _nodes(child)


def opt_state_from_jax(opt_state, cfg: CLIPCfg, like: OptState) -> OptState:
    """The optax state of the JAX package's `make_optimizer` (AdamW, with or
    without clipping) -> the port's `OptState`: ScaleByAdamState's count,
    mu and nu (flattened onto the port's names as `params_from_jax` does
    the parameters) and the learning-rate schedule's count. Tensors take
    the dtype and device of `like`'s (the port optimizer's `init()`)."""
    nodes = list(_nodes(opt_state))
    adam = [n for n in nodes if getattr(n, "_fields", None) == ("count", "mu",
                                                                 "nu")]
    sched = [n for n in nodes if getattr(n, "_fields", None) == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("expected one ScaleByAdamState and one "
                         f"ScaleByScheduleState, found {len(adam)} and "
                         f"{len(sched)}")
    moments = []
    for tree, into in ((adam[0].mu, like.mu), (adam[0].nu, like.nu)):
        flat = params_from_jax(tree, cfg)
        if flat.keys() != into.keys():
            raise ValueError("optimizer state names differ from the port's: "
                             f"{sorted(set(flat) ^ set(into))[:5]}")
        moments.append({n: t.to(into[n]) for n, t in flat.items()})
    return OptState(count=int(np.asarray(adam[0].count)), mu=moments[0],
                    nu=moments[1],
                    schedule_count=int(np.asarray(sched[0].count)))


def _blocks_from_openclip(sd: Dict[str, np.ndarray], prefix: str,
                          layers: int) -> dict:
    """open_CLIP resblocks -> a JAX-layout stacked `blocks` tree (torch
    Linear weights transpose to [in, out])."""
    names = {
        ("ln_1", "scale"): ("ln_1.weight", False),
        ("ln_1", "bias"): ("ln_1.bias", False),
        ("attn", "wqkv"): ("attn.in_proj_weight", True),
        ("attn", "bqkv"): ("attn.in_proj_bias", False),
        ("attn", "wo"): ("attn.out_proj.weight", True),
        ("attn", "bo"): ("attn.out_proj.bias", False),
        ("ln_2", "scale"): ("ln_2.weight", False),
        ("ln_2", "bias"): ("ln_2.bias", False),
        ("mlp", "w1"): ("mlp.c_fc.weight", True),
        ("mlp", "b1"): ("mlp.c_fc.bias", False),
        ("mlp", "w2"): ("mlp.c_proj.weight", True),
        ("mlp", "b2"): ("mlp.c_proj.bias", False),
    }
    blocks: dict = {}
    for (group, leaf), (name, transpose) in names.items():
        per_layer = [sd[f"{prefix}.resblocks.{i}.{name}"] for i in range(layers)]
        if transpose:
            per_layer = [w.T for w in per_layer]
        blocks.setdefault(group, {})[leaf] = np.stack(per_layer)
    return blocks


def params_from_openclip_state_dict(sd: Dict[str, Any], cfg: CLIPCfg,
                                    device: Union[str, torch.device,
                                                  None] = "cpu",
                                    dtype: torch.dtype = torch.float32
                                    ) -> Dict[str, torch.Tensor]:
    """open_CLIP ViT CLIP state dict (numpy arrays or tensors) -> the port's
    state dict, through the JAX-layout tree (as
    `megatron_clip_tpu/checkpoints/torch_interop.py` builds it)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)).astype(np.float32) for k, v in sd.items()}
    p = cfg.vision.patch_size
    conv = sd["visual.conv1.weight"]                           # [W, 3, p, p]
    if sd["visual.positional_embedding"].shape[0] != cfg.vision.seq_len:
        raise NotImplementedError("resizing the position table to another "
                                  "image size is not ported yet "
                                  "(ROADMAP Queue A)")
    visual = {
        "patch_embed": {"w": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, -1)},
        "cls": sd["visual.class_embedding"],
        "pos_embed": sd["visual.positional_embedding"],
        "ln_pre": {"scale": sd["visual.ln_pre.weight"],
                   "bias": sd["visual.ln_pre.bias"]},
        "ln_post": {"scale": sd["visual.ln_post.weight"],
                    "bias": sd["visual.ln_post.bias"]},
        "proj": sd["visual.proj"],
        "blocks": _blocks_from_openclip(sd, "visual.transformer",
                                        cfg.vision.layers),
    }
    text = {
        "tok_embed": sd["token_embedding.weight"],
        "pos_embed": sd["positional_embedding"],
        "ln_final": {"scale": sd["ln_final.weight"],
                     "bias": sd["ln_final.bias"]},
        "proj": {"w": sd["text_projection"]},
        "blocks": _blocks_from_openclip(sd, "transformer", cfg.text.layers),
    }
    tree = {"visual": visual, "text": text,
            "logit_scale": sd["logit_scale"].reshape(())}
    return params_from_jax(tree, cfg, device, dtype)
