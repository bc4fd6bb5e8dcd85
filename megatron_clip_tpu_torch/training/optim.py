"""AdamW with global-norm clipping and open_CLIP's learning-rate schedules.

Counterpart of the AdamW branch of `megatron_clip_tpu/training/optim.py::
make_optimizer`, `cosine_lr` and `_no_decay_mask`, written in optax's
arithmetic rather than `torch.optim.AdamW`'s, so that the same gradients give
the same parameters:

  clip_by_global_norm -> scale_by_adam -> add_decayed_weights (masked)
  -> scale_by_learning_rate (-lr(count), count from 0) -> apply_updates.

With `decay_mask=False` every parameter decays: `optax.adamw` with its
defaults and no mask, bench.py's GPT recipe (`constant_lr`, weight decay
1e-4, eps 1e-8).

Each step of that chain rounds where optax does. A Python constant (b1,
1 - b1, eps, the decay, lr) meets a tensor in the tensor's dtype, as JAX's
weakly typed scalars do: with bf16 moments b1 acts as 0.8984375. The
product b1 mu is not rounded to bf16 before it meets the fp32 gradient term,
as the JAX package's jitted step computes it (XLA keeps that intermediate in
fp32; optax run eagerly would round it). mu is rounded to `moment_dtype`
after each update; nu stays in the parameter's dtype. Parameters are
updated in place, and the moments are replaced, one tensor per parameter.
The update runs over chunks of at most `CHUNK_ELEMENTS` elements, each
through the whole chain: every step is elementwise, so the result is the
same, and the chain's temporaries (a dozen per element) stay at a chunk's
size rather than the model's (1.7 billion parameters would need some 70 GB
of them at once).

The tower lock (open_CLIP --lock-image / --lock-text, LiT): the JAX
package's `tower_lock_mask` multiplies the final updates by 0 or 1
(`apply_update_mask`, chained last), so a locked parameter's gradient is
still computed, still counts in the global norm that clips, and its Adam
moments still move; only its update is zeroed. The port's blocks are
unstacked, so the JAX per-layer multiplier is one number per parameter
(`tower_lock_mask`), applied as the last step of the chain.

The schedules: open_CLIP's `cosine_lr`, `const_lr` and `const_lr_cooldown`,
and `constant_lr`. Not ported yet: SGD, bf16 nu (`adamw_lowbits`),
scheduled weight decay and the megatron schedules, which only the GPT
runtime calls (ROADMAP Queue A item 4).
"""
import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# the update's chunk: 2^27 elements, 512 MB of fp32
CHUNK_ELEMENTS = 1 << 27


def cosine_lr(base_lr: float, warmup: int, total_steps: int,
              min_lr: float = 0.0) -> Callable[[int], float]:
    """open_CLIP scheduler.py cosine_lr: linear warmup from base_lr/warmup,
    then cosine to min_lr; computed in fp32 as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step)
        if t < warmup:
            return float(f32(base_lr) * (t + f32(1)) / f32(max(warmup, 1)))
        prog = (t - f32(warmup)) / f32(max(total_steps - warmup, 1))
        return float(f32(min_lr) + f32(0.5 * (base_lr - min_lr))
                     * (f32(1) + np.cos(f32(np.pi) * prog)))
    return schedule


def constant_lr(lr: float) -> Callable[[int], float]:
    """A fixed learning rate, as optax takes a float (and the CLIP
    trainer's `--skip-scheduler`: the raw lr, no warmup or decay)."""
    return lambda step: lr


def const_lr(base_lr: float, warmup: int) -> Callable[[int], float]:
    """open_CLIP scheduler.py const_lr: the cosine schedule's linear warmup,
    then base_lr; in fp32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step)
        if t < warmup:
            return float(f32(base_lr) * (t + f32(1)) / f32(max(warmup, 1)))
        return float(f32(base_lr))
    return schedule


def const_lr_cooldown(base_lr: float, warmup: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Callable[[int], float]:
    """open_CLIP scheduler.py const_lr_cooldown: const_lr, then over the last
    `cooldown_steps` a polynomial decay to cooldown_end_lr; in fp32 as the
    JAX schedule computes it (the difference of the two rates in Python's
    float, as the JAX package forms it)."""
    f32 = np.float32
    start = total_steps - cooldown_steps

    def schedule(step: int) -> float:
        t = f32(step)
        if t >= start:
            prog = (t - f32(start)) / f32(max(cooldown_steps, 1))
            prog = min(max(prog, f32(0)), f32(1))
            return float(f32(cooldown_end_lr)
                         + f32(base_lr - cooldown_end_lr)
                         * (f32(1) - prog) ** f32(cooldown_power))
        if t < warmup:
            return float(f32(base_lr) * (t + f32(1)) / f32(max(warmup, 1)))
        return float(f32(base_lr))
    return schedule


def _no_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True = apply weight decay, as the JAX package's `_no_decay_mask`
    decides on its own pytree: a leaf decays unless it has fewer than two
    axes or is `logit_scale`.

    That rule is meant to keep biases and LayerNorm gains out of weight
    decay (open_CLIP excludes all of them). But the JAX package stacks every
    transformer block on a leading layer axis, so each block's biases
    (bqkv, bo, b1, b2) and its ln_1/ln_2 scale and bias are [L, W] there and
    DO decay; only cls, ln_pre, ln_post, ln_final and logit_scale are
    excluded. The port's blocks are unstacked, so a plain `ndim < 2` rule
    would differ: every `*.blocks.*` parameter decays here too. This keeps
    the reference's defect, for parity (ROADMAP Queue C)."""
    return {name: "logit_scale" not in name
            and ("blocks" in name.split(".") or p.dim() >= 2)
            for name, p in params.items()}


def tower_lock_mask(params: Mapping[str, torch.Tensor], *,
                    lock_image: bool = False, image_unlocked_groups: int = 0,
                    lock_text: bool = False,
                    text_unlocked_layers: int = 0) -> Dict[str, float]:
    """The JAX `tower_lock_mask` by parameter name: 1.0 trains, 0.0 is
    frozen. A locked tower of L blocks has L + 2 groups, as open_CLIP's
    VisionTransformer.lock lays them out: group 0 the embeddings, class
    token, position table and ln_pre; group 1 + i block i, the last block
    with ln_post / ln_final; group L + 1 the projection. `unlocked` keeps
    the last `unlocked` groups trainable (the text tower's count takes the
    same groups, as in the JAX package)."""
    def tower_mask(tower: str, unlocked: int) -> Dict[str, float]:
        names = {n[len(tower) + 1:]: n for n in params
                 if n.startswith(tower + ".")}
        layers = len({rel.split(".")[1] for rel in names
                      if rel.startswith("blocks.")})
        if unlocked > 0 and layers == 0:
            raise ValueError("unlocked groups/layers need a block-stacked "
                             "tower (ViT/TextTransformer); this tower has no "
                             "'blocks'")
        first_unlocked = layers + 2 - unlocked
        out = {}
        for rel, name in names.items():
            parts = rel.split(".")
            if "blocks" in parts:
                group = int(parts[parts.index("blocks") + 1]) + 1
            elif "proj" in rel:
                group = layers + 1
            elif "ln_post" in rel or "ln_final" in rel:
                group = layers
            else:
                group = 0
            out[name] = 1.0 if group >= first_unlocked else 0.0
        return out

    mask = dict.fromkeys(params, 1.0)
    if lock_image:
        mask.update(tower_mask("visual", image_unlocked_groups))
    if lock_text:
        mask.update(tower_mask("text", text_unlocked_layers))
    return mask


def _jax_leaf(name: str) -> str:
    """The JAX tree leaf that holds a port parameter: the JAX package
    stacks the layers under `blocks`, so the layer index goes."""
    parts = name.split(".")
    if "blocks" in parts:
        del parts[parts.index("blocks") + 1]
    return ".".join(parts)


def _c(x: float, dtype: torch.dtype) -> float:
    """The Python constant x as a JAX weak scalar meets a `dtype` tensor:
    rounded to that dtype."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


@dataclasses.dataclass
class OptState:
    """optax's ScaleByAdamState (count, mu, nu) and the learning-rate
    schedule's count, by parameter name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: int


class AdamW:
    """The optimizer `make_optimizer` builds for one model's parameters."""

    def __init__(self, model: nn.Module, lr: Callable[[int], float], *,
                 beta1: float, beta2: float, eps: float, weight_decay: float,
                 grad_clip_norm: Optional[float],
                 moment_dtype: Optional[torch.dtype],
                 decay_mask: bool = True,
                 lock_mask: Optional[Mapping[str, float]] = None):
        self.params = dict(model.named_parameters())
        self.lr = lr
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.moment_dtype = moment_dtype
        decay = (_no_decay_mask(self.params) if decay_mask
                 else dict.fromkeys(self.params, True))
        lock = lock_mask or dict.fromkeys(self.params, 1.0)
        groups: Dict[tuple, list] = {}
        for name, p in self.params.items():
            groups.setdefault((p.dtype, decay[name], lock[name]),
                              []).append(name)
        self.groups = list(groups.items())
        # global_norm: each parameter's JAX leaf in the JAX tree's order
        # (dict keys sorted at every level), which leaves round their sum
        # of squares to bf16, and whether all do; made here, so that the
        # step does not copy them to the card
        leaves = {n: _jax_leaf(n) for n in self.params}
        order = sorted(set(leaves.values()), key=lambda k: k.split("."))
        dtypes = {leaves[n]: p.dtype for n, p in self.params.items()}
        device = next(iter(self.params.values())).device
        self._leaf_index = torch.tensor([order.index(leaves[n])
                                         for n in self.params], device=device)
        bf16 = [dtypes[k] == torch.bfloat16 for k in order]
        self._leaf_bf16 = torch.tensor(bf16, device=device)
        self._all_bf16 = all(bf16)

    def init(self) -> OptState:
        return OptState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
                for n, p in self.params.items()},
            nu={n: torch.zeros_like(p) for n, p in self.params.items()},
            schedule_count=0)

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the JAX package's gradient tree, as a 0-d
        fp32 tensor: Python's sum over the leaves, in tree order, of
        jnp.sum(g * g), square-rooted. jnp.sum accumulates in fp32 and
        returns the leaf's dtype, so a bf16 leaf's sum is rounded to bf16
        (its squares are rounded to bf16 there too, which moves the sum by
        far less than that rounding). Python's sum adds the leaves in the
        dtype they promote to: in bf16, rounding after every addition, when
        every leaf is bf16 (a pure-bf16 GPT tree, and its square root too),
        else in fp32 (the port's other trees are CLIP's, whose first leaf,
        logit_scale, is fp32). A JAX leaf under `blocks` holds every layer, so the
        port's per-layer sums of one leaf are added before that rounding.
        Each leaf's sum is accumulated in fp64 and rounded once to fp32, the
        correctly rounded fp32 sum, which XLA's fp32 order approaches within
        its summation error: PyTorch's fp32 norm of a leaf of millions of
        elements loses digits on the CPU, which would make the CPU and the
        card disagree on the clip."""
        norms = torch._foreach_norm([grads[n] for n in self.params], 2,
                                    dtype=torch.float64)
        leaf = torch.zeros(len(self._leaf_bf16), dtype=torch.float64,
                           device=self._leaf_bf16.device).index_add_(
            0, self._leaf_index, torch.stack(norms).square()).float()
        if not self._all_bf16:
            leaf = torch.where(self._leaf_bf16, leaf.bfloat16().float(), leaf)
            return leaf.sum().sqrt()
        leaf = leaf.bfloat16()
        total = leaf[0]
        for x in leaf[1:]:
            total = total + x
        return total.sqrt().float()

    def _clip(self, g: list, dtype: torch.dtype, norm: torch.Tensor):
        """optax.clip_by_global_norm on the tensors `g` of one dtype: t ->
        (t / norm) * max_norm when norm >= max_norm, else t; chosen on the
        device, no sync."""
        keep = norm < self.grad_clip_norm
        safe = torch.where(keep, torch.ones_like(norm), norm)
        c = torch._foreach_div(g, safe.to(dtype))
        torch._foreach_mul_(c, _c(self.grad_clip_norm, dtype))
        k = keep.to(dtype)
        kept = torch._foreach_mul(g, k)
        torch._foreach_mul_(c, 1 - k)
        return torch._foreach_add(kept, c)

    def _chunks(self, names: list):
        """`names` in consecutive runs of at most CHUNK_ELEMENTS elements
        (a larger tensor alone)."""
        run, size = [], 0
        for n in names:
            numel = self.params[n].numel()
            if run and size + numel > CHUNK_ELEMENTS:
                yield run
                run, size = [], 0
            run.append(n)
            size += numel
        if run:
            yield run

    def update(self, state: OptState, grads: Dict[str, torch.Tensor]):
        """One optax step: updates the parameters in place and returns
        (the new state, the gradients' global norm before clipping)."""
        norm = self.global_norm(grads)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        lr = self.lr(state.schedule_count)
        mu_out, nu_out = {}, {}
        for (dtype, decays, lock), group in self.groups:
            for names in self._chunks(group):
                self._update_chunk(names, dtype, decays, lock, grads, norm,
                                   state, bc1, bc2, lr, mu_out, nu_out)
        return OptState(count=count, mu=mu_out, nu=nu_out,
                        schedule_count=state.schedule_count + 1), norm

    def _update_chunk(self, names, dtype, decays, lock, grads, norm, state,
                      bc1, bc2, lr, mu_out, nu_out) -> None:
        """The chain on the parameters `names` (one dtype, decay and lock
        multiplier): the clip, scale_by_adam, the decay, the learning rate,
        the lock mask, the update in place; the new moments into mu_out
        and nu_out."""
        g = [grads[n] for n in names]
        if self.grad_clip_norm:
            g = self._clip(g, dtype, norm)
        mdt = self.moment_dtype or dtype
        udt = torch.promote_types(dtype, mdt)
        # scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        a = torch._foreach_mul(g, _c(1 - self.b1, dtype))
        b = torch._foreach_mul([state.mu[n].to(udt) for n in names],
                               _c(self.b1, mdt))
        mu = torch._foreach_add([t.to(udt) for t in a],
                                [t.to(udt) for t in b])
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, _c(1 - self.b2, dtype))
        nu = torch._foreach_add(
            g2, torch._foreach_mul([state.nu[n] for n in names],
                                   _c(self.b2, dtype)))
        # bias correction, then mu_hat / (sqrt(nu_hat) + eps)
        u = torch._foreach_div(mu, _c(bc1, udt))
        den = torch._foreach_div(nu, _c(bc2, dtype))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _c(self.eps, dtype))
        u = torch._foreach_div(u, [t.to(udt) for t in den])
        if decays:  # add_decayed_weights: u + wd p
            wp = torch._foreach_mul([self.params[n].detach()
                                     for n in names],
                                    _c(self.weight_decay, dtype))
            u = torch._foreach_add(u, [t.to(udt) for t in wp])
        # scale_by_learning_rate, then apply_updates: p <- p + u
        torch._foreach_mul_(u, _c(-lr, udt))
        if lock != 1.0:  # apply_update_mask: u * mask, last in the chain
            torch._foreach_mul_(u, lock)
        with torch.no_grad():
            torch._foreach_add_([self.params[n] for n in names], u)
        mu_out.update(zip(names, (t.to(mdt) for t in mu)))
        nu_out.update(zip(names, nu))


def make_optimizer(model: nn.Module, lr: Callable[[int], float], *,
                   beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-6,
                   weight_decay: float = 0.2,
                   grad_clip_norm: Optional[float] = None,
                   moment_dtype: Optional[torch.dtype] = None,
                   decay_mask: bool = True,
                   lock_mask: Optional[Mapping[str, float]] = None) -> AdamW:
    """AdamW with the CLIP recipe's defaults (open_CLIP: beta2 0.98, eps
    1e-6, weight decay 0.2), weight decay masked by `_no_decay_mask` (with
    `decay_mask=False` every parameter decays), optional
    global-norm clipping first. `moment_dtype` stores the first moment
    (optax's mu_dtype); None keeps each parameter's dtype. `lock_mask`
    (`tower_lock_mask`'s) multiplies each parameter's final update."""
    return AdamW(model, lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
                 moment_dtype=moment_dtype, decay_mask=decay_mask,
                 lock_mask=lock_mask)


def make_gpt_optimizer(model: nn.Module, lr: float = 1e-4, *,
                       grad_clip_norm: Optional[float] = 1.0,
                       moment_dtype: Optional[torch.dtype] = torch.bfloat16
                       ) -> AdamW:
    """bench.py's GPT chain: optax.clip_by_global_norm(1.0), then
    optax.adamw(lr, b1=0.9, b2=0.95, mu_dtype=bf16) with adamw's defaults
    (eps 1e-8, weight decay 1e-4, no mask) and a constant learning rate."""
    return make_optimizer(model, constant_lr(lr), beta1=0.9, beta2=0.95,
                          eps=1e-8, weight_decay=1e-4,
                          grad_clip_norm=grad_clip_norm,
                          moment_dtype=moment_dtype, decay_mask=False)
