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
after each update; nu stays in the parameter's dtype. Parameters and
moments are updated in place (each chunk's new moments copied, rounded to
their dtype, into the state's tensors), so an update holds one chunk's
temporaries beside the state and never a second copy of the moments: the
state passed to `update` is the one it returns.
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
`constant_lr`, and megatron's `megatron_lr` (linear, cosine, constant and
inverse-square-root decay after a linear warmup) and `megatron_wd` (weight
decay ramped over the run), each in fp32 as the JAX schedule computes it.

The GPT runtime's other chains (`make_optimizer(optimizer=..., nu_dtype=...,
weight_decay=callable)`, the JAX `make_optimizer`'s branches):
- scheduled weight decay: the decay is `weight_decay(count)` each step, as
  `optax.inject_hyperparams(optax.adamw)` evaluates it; there every
  hyperparameter is an array of the first gradient leaf's dtype, so
  1 - b1 and the bias corrections are formed from the rounded b1 and b2
  and rounded again (`AdamW._injected`);
- bf16 nu (`adamw_lowbits`, `scale_by_adam_lowbits`): both moments stored in
  bf16 (mu in `moment_dtype`, default bf16), the whole moment update and
  bias correction in fp32 from the stored moments and the fp32 gradient,
  the step rounded to the gradient's dtype, then the masked decay and the
  learning rate in the parameter's dtype;
- `SGD`: megatron --optimizer sgd, `optax.add_decayed_weights` (masked)
  before `optax.sgd`'s momentum trace (t <- g + m t, stored in the
  parameter's dtype) and the learning rate.
"""
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from megatron_clip_tpu_torch.parallel.sharding import norm_weights

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


def megatron_lr(base_lr: float, warmup: int, total_steps: int, *,
                decay_style: str = "cosine", min_lr: float = 0.0,
                decay_steps: Optional[int] = None) -> Callable[[int], float]:
    """megatron OptimizerParamScheduler.get_lr as the JAX `megatron_lr`
    computes it, in fp32: linear warmup from base_lr/warmup, then constant,
    linear, cosine or inverse-square-root decay to min_lr over
    `decay_steps` (--lr-decay-iters; default the whole run)."""
    if decay_style not in ("constant", "linear", "cosine",
                           "inverse-square-root"):
        raise ValueError(f"unknown lr decay style {decay_style!r}")
    f32 = np.float32
    decay_steps = decay_steps or total_steps
    span = max(decay_steps - warmup, 1)

    def schedule(step: int) -> float:
        t = f32(step)
        if t < warmup:
            return float(f32(base_lr) * (t + f32(1)) / f32(max(warmup, 1)))
        prog = min(max((t - f32(warmup)) / f32(span), f32(0)), f32(1))
        if decay_style == "constant":
            return float(f32(base_lr))
        if decay_style == "linear":
            return float(f32(min_lr) + f32(base_lr - min_lr)
                         * (f32(1) - prog))
        if decay_style == "cosine":
            return float(f32(min_lr) + f32(0.5 * (base_lr - min_lr))
                         * (f32(1) + np.cos(f32(np.pi) * prog)))
        dec = f32(base_lr) * np.sqrt(f32(max(warmup, 1))) \
            / np.sqrt(max(t, f32(1)))
        return float(min(max(f32(min_lr), dec), f32(base_lr)))
    return schedule


def megatron_wd(start_wd: float, end_wd: float, total_steps: int,
                incr_style: str = "constant") -> Callable[[int], float]:
    """megatron OptimizerParamScheduler.get_wd as the JAX `megatron_wd`
    computes it, in fp32: weight decay from start_wd to end_wd over the run
    (--weight-decay-incr-style constant, linear or cosine)."""
    if incr_style not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown wd incr style {incr_style!r}")
    f32 = np.float32

    def schedule(step: int) -> float:
        if incr_style == "constant":
            return float(f32(start_wd))
        p = min(max(f32(step) / f32(max(total_steps, 1)), f32(0)), f32(1))
        if incr_style == "linear":
            coeff = p
        else:
            coeff = f32(0.5) * (np.cos(f32(np.pi) * (f32(1) - p)) + f32(1))
        return float(f32(start_wd) + coeff * f32(end_wd - start_wd))
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


def _store(out: dict, names: list, new: list, moments: dict) -> None:
    """The new moments of `names` copied into the state's tensors
    (`moments`, rounded to their dtype as `.to` rounds), and those tensors
    into `out`."""
    into = [moments[n] for n in names]
    torch._foreach_copy_(into, new)
    out.update(zip(names, into))


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
                 beta1: float, beta2: float, eps: float,
                 weight_decay: Union[float, Callable[[int], float]],
                 grad_clip_norm: Optional[float],
                 moment_dtype: Optional[torch.dtype],
                 decay_mask: bool = True,
                 lock_mask: Optional[Mapping[str, float]] = None,
                 nu_dtype: Optional[torch.dtype] = None):
        self.params = dict(model.named_parameters())
        self.lr = lr
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.moment_dtype = moment_dtype
        self.nu_dtype = nu_dtype
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
        self._inject_dtype = dtypes[order[0]]
        self._leaf_bf16 = torch.tensor(bf16, device=device)
        self._all_bf16 = all(bf16)
        # a sharded model's parameters are its shards (`parallel/
        # sharding.py`): `global_norm` sums each parameter's squares over
        # the ranks that hold one copy of the model between them, each
        # rank's weighted by 1 / the ranks holding the same elements, so
        # that a replicated parameter counts once
        weights = norm_weights(model)
        self._shard_weight = None if weights is None else torch.tensor(
            [weights[n] for n in self.params], dtype=torch.float64,
            device=device)
        self._shard_group = None if weights is None else model.layout.model

    def init(self) -> OptState:
        return OptState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
                for n, p in self.params.items()},
            nu={n: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                for n, p in self.params.items()},
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
        card disagree on the clip. Over a sharded model's shards each
        leaf's squares are summed over its shards first, in fp64, then
        rounded as the whole leaf's."""
        norms = torch._foreach_norm([grads[n] for n in self.params], 2,
                                    dtype=torch.float64)
        squares = torch.stack(norms).square()
        if self._shard_weight is not None:
            squares = squares * self._shard_weight
            if self._shard_group is not None:
                dist.all_reduce(squares, group=self._shard_group)
        leaf = torch.zeros(len(self._leaf_bf16), dtype=torch.float64,
                           device=self._leaf_bf16.device).index_add_(
            0, self._leaf_index, squares).float()
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
        wd = (self.weight_decay(state.schedule_count)
              if callable(self.weight_decay) else self.weight_decay)
        mu_out, nu_out = {}, {}
        for (dtype, decays, lock), group in self.groups:
            for names in self._chunks(group):
                self._update_chunk(names, dtype, decays, lock, grads, norm,
                                   state, bc1, bc2, lr, wd, mu_out, nu_out)
        return OptState(count=count, mu=mu_out, nu=nu_out,
                        schedule_count=state.schedule_count + 1), norm

    def _update_chunk(self, names, dtype, decays, lock, grads, norm, state,
                      bc1, bc2, lr, wd, mu_out, nu_out) -> None:
        """The chain on the parameters `names` (one dtype, decay and lock
        multiplier): the clip, scale_by_adam, the decay, the learning rate,
        the lock mask, the update in place; the new moments into mu_out
        and nu_out."""
        g = [grads[n] for n in names]
        if self.grad_clip_norm:
            g = self._clip(g, dtype, norm)
        if self.nu_dtype is not None:
            u = self._lowbits(names, g, dtype, state, mu_out, nu_out)
            self._finish(names, u, dtype, decays, lock, lr, wd)
            return
        mdt = self.moment_dtype or dtype
        udt = torch.promote_types(dtype, mdt)
        k = (self._injected(state.count + 1) if callable(self.weight_decay)
             else dict(omb1=_c(1 - self.b1, dtype), b1=_c(self.b1, mdt),
                       omb2=_c(1 - self.b2, dtype), b2=_c(self.b2, dtype),
                       bc1=_c(bc1, udt), bc2=_c(bc2, dtype),
                       eps=_c(self.eps, dtype)))
        # scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        a = torch._foreach_mul(g, k["omb1"])
        b = torch._foreach_mul([state.mu[n].to(udt) for n in names],
                               k["b1"])
        mu = torch._foreach_add([t.to(udt) for t in a],
                                [t.to(udt) for t in b])
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, k["omb2"])
        nu = torch._foreach_add(
            g2, torch._foreach_mul([state.nu[n] for n in names], k["b2"]))
        # bias correction, then mu_hat / (sqrt(nu_hat) + eps)
        u = torch._foreach_div(mu, k["bc1"])
        den = torch._foreach_div(nu, k["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, k["eps"])
        u = torch._foreach_div(u, [t.to(udt) for t in den])
        _store(mu_out, names, mu, state.mu)
        _store(nu_out, names, nu, state.nu)
        self._finish(names, u, udt, decays, lock, lr, wd)

    def _injected(self, count: int) -> dict:
        """scale_by_adam's constants as `optax.inject_hyperparams(
        optax.adamw)` forms them (a scheduled weight decay): b1, b2 and eps
        arrays of the first gradient leaf's dtype, so 1 - b1 and the bias
        corrections 1 - b1^count are computed from the rounded b1 and
        rounded to that dtype."""
        dt = self._inject_dtype
        b1, b2 = _c(self.b1, dt), _c(self.b2, dt)
        f32 = np.float32
        return dict(omb1=_c(1 - b1, dt), b1=b1, omb2=_c(1 - b2, dt), b2=b2,
                    bc1=_c(1 - _c(float(f32(b1) ** f32(count)), dt), dt),
                    bc2=_c(1 - _c(float(f32(b2) ** f32(count)), dt), dt),
                    eps=_c(self.eps, dt))

    def _lowbits(self, names, g, dtype, state, mu_out, nu_out) -> list:
        """scale_by_adam_lowbits on one chunk: the moments' update and the
        bias-corrected step in fp32, the step rounded to the gradient's
        dtype; the new moments, rounded to their storage dtypes, into
        mu_out and nu_out."""
        f32 = np.float32
        c = f32(state.count + 1)
        bc1 = float(f32(1) - f32(self.b1) ** c)
        bc2 = float(f32(1) - f32(self.b2) ** c)
        g32 = [t.float() for t in g]
        mu = torch._foreach_mul([state.mu[n].float() for n in names],
                                _c(self.b1, torch.float32))
        torch._foreach_add_(mu, torch._foreach_mul(
            g32, _c(1 - self.b1, torch.float32)))
        nu = torch._foreach_mul([state.nu[n].float() for n in names],
                                _c(self.b2, torch.float32))
        g2 = torch._foreach_mul(g32, _c(1 - self.b2, torch.float32))
        torch._foreach_mul_(g2, g32)
        torch._foreach_add_(nu, g2)
        step = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _c(self.eps, torch.float32))
        torch._foreach_div_(step, den)
        _store(mu_out, names, mu, state.mu)
        _store(nu_out, names, nu, state.nu)
        return [t.to(dtype) for t in step]

    def _finish(self, names, u, udt, decays, lock, lr, wd) -> None:
        """The chain's tail on the updates `u` (in `udt`): the masked weight
        decay, the learning rate, the lock mask, the update in place."""
        dtype = self.params[names[0]].dtype
        if decays:  # add_decayed_weights: u + wd p
            wp = torch._foreach_mul([self.params[n].detach()
                                     for n in names], _c(wd, dtype))
            u = torch._foreach_add(u, [t.to(udt) for t in wp])
        # scale_by_learning_rate, then apply_updates: p <- p + u
        torch._foreach_mul_(u, _c(-lr, udt))
        if lock != 1.0:  # apply_update_mask: u * mask, last in the chain
            torch._foreach_mul_(u, lock)
        with torch.no_grad():
            torch._foreach_add_([self.params[n] for n in names], u)


class SGD(AdamW):
    """megatron --optimizer sgd as the JAX `make_optimizer` chains it: the
    clip, `optax.add_decayed_weights` (masked, scheduled or not), then
    `optax.sgd`: the momentum trace t <- g + m t (stored in the parameter's
    dtype; the update is the new trace) and the learning rate. The state's
    `mu` holds the trace; `nu` is empty."""

    def __init__(self, model: nn.Module, lr: Callable[[int], float], *,
                 momentum: float,
                 weight_decay: Union[float, Callable[[int], float]],
                 grad_clip_norm: Optional[float]):
        super().__init__(model, lr, beta1=0.0, beta2=0.0, eps=0.0,
                         weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm, moment_dtype=None)
        self.momentum = momentum

    def init(self) -> OptState:
        return OptState(count=0, mu={n: torch.zeros_like(p) for n, p
                                     in self.params.items()},
                        nu={}, schedule_count=0)

    def _update_chunk(self, names, dtype, decays, lock, grads, norm, state,
                      bc1, bc2, lr, wd, mu_out, nu_out) -> None:
        g = [grads[n] for n in names]
        if self.grad_clip_norm:
            g = self._clip(g, dtype, norm)
        if decays:  # add_decayed_weights: g + wd p
            g = torch._foreach_add(g, torch._foreach_mul(
                [self.params[n].detach() for n in names], _c(wd, dtype)))
        trace = torch._foreach_mul([state.mu[n] for n in names],
                                   _c(self.momentum, dtype))
        trace = torch._foreach_add(g, trace)
        _store(mu_out, names, trace, state.mu)
        u = torch._foreach_mul(trace, _c(-lr, dtype))
        with torch.no_grad():
            torch._foreach_add_([self.params[n] for n in names], u)


def make_optimizer(model: nn.Module, lr: Callable[[int], float], *,
                   beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-6,
                   weight_decay: Union[float, Callable[[int], float]] = 0.2,
                   grad_clip_norm: Optional[float] = None,
                   moment_dtype: Optional[torch.dtype] = None,
                   decay_mask: bool = True,
                   lock_mask: Optional[Mapping[str, float]] = None,
                   optimizer: str = "adam", sgd_momentum: float = 0.9,
                   nu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with the CLIP recipe's defaults (open_CLIP: beta2 0.98, eps
    1e-6, weight decay 0.2), weight decay masked by `_no_decay_mask` (with
    `decay_mask=False` every parameter decays), optional
    global-norm clipping first. `moment_dtype` stores the first moment
    (optax's mu_dtype); None keeps each parameter's dtype. `lock_mask`
    (`tower_lock_mask`'s) multiplies each parameter's final update.

    The JAX `make_optimizer`'s other branches: `weight_decay` a schedule
    (`megatron_wd`; megatron --weight-decay-incr-style), `optimizer="sgd"`
    (`SGD`, momentum `sgd_momentum`) and `nu_dtype` (bf16 second moments,
    `adamw_lowbits`; the first moment then defaults to bf16 too). A
    scheduled decay with `nu_dtype` raises ValueError, as there."""
    if callable(weight_decay) and nu_dtype is not None:
        raise ValueError("--weight-decay-incr-style does not compose with "
                         "--nu-dtype bf16 (adamw_lowbits has no injected "
                         "hyperparameters)")
    if optimizer == "sgd":
        if not decay_mask or lock_mask is not None:
            raise ValueError("SGD takes the decay mask and no lock mask")
        return SGD(model, lr, momentum=sgd_momentum,
                   weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
    if optimizer != "adam":
        raise ValueError(f"optimizer={optimizer!r}: adam or sgd")
    if nu_dtype is not None and moment_dtype is None:
        moment_dtype = torch.bfloat16
    return AdamW(model, lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
                 moment_dtype=moment_dtype, decay_mask=decay_mask,
                 lock_mask=lock_mask, nu_dtype=nu_dtype)


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
