"""The port's train step vs the JAX package's, at a small size on the CPU.

The model is the CPU configuration of bench.py's primary leg (ViT-B-32 with
embed 64, two layers of width 64 per tower, 32 px images, context 16, vocab
512), its zero biases and unit LayerNorm gains perturbed so every parameter
path carries signal. The JAX weights go into the port through
`bridge.params_from_jax`; images and token ids come from numpy with a seed.
On the CPU the port runs its kernels' plain versions; the JAX step runs its
XLA attention and LayerNorm (the CPU path of the JAX package).

Tolerances, fp32: loss and logit_scale 1e-6 relative at the first step and
1e-5 after it, grad_norm and every gradient 1e-5 relative with 1e-5 of the
largest |gradient| absolute (sums over the batch in another order). The
parameters after the steps: 99% of them within 1e-6 absolute, every one
within 2 lr per step. Adam's first step moves an element by g / (|g| + eps)
lr, whose slope at |g| = eps = 1e-6 is lr / (4 eps): a difference of 1e-11
in such a gradient (1e-5 of it) moves the weight by 1.25e-5 at lr 5e-3, and
a gradient that is 0 in exact arithmetic (the key part of each bqkv: a
softmax does not see a shift that is the same for every key) is rounding
noise that Adam scales up to as much as lr. The optimizer alone, on the
same gradients, agrees within 2e-6 absolute in fp32
(test_optimizer_matches_optax). bf16 moments and pure_bf16 weights: see
each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import megatron_clip_tpu as mct
from megatron_clip_tpu import losses as jax_losses
from megatron_clip_tpu.models.clip import apply_clip
from megatron_clip_tpu.training import optim as jax_optim
from megatron_clip_tpu.training import train_step as jax_ts
import megatron_clip_tpu_torch as port
from megatron_clip_tpu_torch import losses
from megatron_clip_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from megatron_clip_tpu_torch.ops.kernels import fused_mha as port_mha
from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                              make_optimizer, make_train_step)
from megatron_clip_tpu_torch.training.optim import _no_decay_mask

# bench.py's CPU configuration of the primary leg
OVERRIDES = dict(
    embed_dim=64,
    vision_cfg={"image_size": 32, "layers": 2, "width": 64, "head_width": 32,
                "patch_size": 8},
    text_cfg={"context_length": 16, "vocab_size": 512, "width": 64,
              "heads": 2, "layers": 2})
BATCH = 8
# larger than bench's 1e-3 with 100 warm-up steps, so that three steps move
# the weights far beyond the tolerance
LR = dict(base_lr=5e-3, warmup=1, total_steps=10)


def _jax_model(precision="fp32", seed=0, overrides=OVERRIDES):
    jmodel, params = mct.create_model("ViT-B-32", precision=precision,
                                      seed=seed, **overrides)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(np.asarray(v, np.float32) + 0.05 * rng.standard_normal(
        np.shape(v)).astype(np.float32), jnp.asarray(v).dtype) for v in leaves]
    return jmodel, jax.tree.unflatten(treedef, leaves)


def _port_model(jmodel, jparams, precision="fp32", overrides=OVERRIDES,
                attn_save_probs=True):
    model = port.create_model("ViT-B-32", precision=precision, device="cpu",
                              attn_save_probs=attn_save_probs, **overrides)
    model.load_state_dict(params_from_jax(jparams, jmodel.cfg))
    return model.train()


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 512 - 2, (BATCH, 16)).astype(np.int32)
    return images, texts


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_params(model, jparams, cfg, atol, rtol=0.0, loose=None,
                   frac=1.0):
    """Every parameter within `loose` (default `atol`) absolute plus rtol,
    and a share `frac` of all elements within `atol` plus rtol."""
    want = params_from_jax(jparams, cfg)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    tight = total = 0
    for name, w in want.items():
        g, w = got[name].detach().float().numpy(), w.numpy()
        _close(g, w, rtol, atol if loose is None else loose, name)
        tight += int((np.abs(g - w) <= atol + rtol * np.abs(w)).sum())
        total += g.size
    assert tight >= frac * total, (tight, total)


def test_clip_loss_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    img, txt = (rng.standard_normal((6, 16)).astype(np.float32)
                for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale = np.float32(14.3)

    def jloss(i, t, s):
        return jax_losses.ClipLoss()(i, t, s)
    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale))
    ti, tt, ts = (torch.tensor(a, requires_grad=True)
                  for a in (img, txt, scale))
    got = losses.ClipLoss()(ti, tt, ts)
    got.backward()
    _close(float(got.detach()), float(want), 1e-6)
    _close(float(losses.clip_loss(ti, tt, ts).detach()),
           float(jax_losses.clip_loss(jnp.asarray(img), jnp.asarray(txt),
                                      jnp.asarray(scale))), 1e-6)
    for g, w in zip((ti.grad, tt.grad, ts.grad), want_g):
        _close(g.numpy(), np.asarray(w), 1e-5, 1e-6)


@pytest.mark.parametrize("step", [0, 99, 100, 5000, 10000])
def test_cosine_lr_matches_jax(step):
    _close(cosine_lr(1e-3, 100, 10000)(step),
           float(jax_optim.cosine_lr(1e-3, 100, 10000)(step)), 1e-6, 1e-12)


def test_decay_mask_keeps_the_stacked_blocks_defect():
    """The JAX mask excludes a leaf with fewer than two axes, meant for
    biases and gains, but its blocks are stacked [L, ...], so every block
    bias and ln_1/ln_2 gain IS decayed there; only cls, ln_pre, ln_post,
    ln_final and logit_scale are excluded. The port, whose blocks are
    unstacked, must decide the same per parameter."""
    jmodel, jparams = _jax_model()
    want = {}
    for path, keep in jax.tree_util.tree_leaves_with_path(
            jax_optim._no_decay_mask(jparams)):
        keys = [p.key for p in path]
        if "blocks" in keys:
            i = keys.index("blocks")
            layers = getattr(jmodel.cfg, "vision" if keys[0] == "visual"
                             else "text").layers
            for layer in range(layers):
                want[".".join(keys[:i + 1] + [str(layer)] + keys[i + 1:])] = \
                    bool(keep)
        else:
            want[".".join(keys)] = bool(keep)
    model = _port_model(jmodel, jparams)
    got = _no_decay_mask(dict(model.named_parameters()))
    assert got == want
    assert got["visual.blocks.0.attn.bqkv"] and \
        got["text.blocks.1.ln_2.scale"]
    assert not (got["visual.cls"] or got["visual.ln_post.bias"]
                or got["logit_scale"])


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
def test_optimizer_matches_optax(mu_dtype, grad_scale):
    """Three AdamW updates with the clip at 1.0, on the same parameters and
    gradients. grad_scale 1e-3 leaves the global norm under 1.0 (no clip),
    1.0 puts it far above (clipped). With bf16 first moments both sides
    round mu to bf16 after each update and apply b1 = 0.8984375, b1 in bf16;
    where the fp32 terms differ in the last place a rounding of mu to bf16
    can flip, which moves that element's update by 2^-8 lr, so the weights
    are held to 2^-7 lr. A flip in one update is carried, times b1, into the
    next, where a second flip can add to it: the stored mu is held to two
    bf16 ulps (rtol 1.6e-2). Such a flip is an ulp of the terms, which can
    cancel in later updates: the absolute floor is 2^-8 of the leaf's
    largest |mu|. The port's global norm adds each leaf's squares as the
    correctly rounded fp32 sum, optax as an fp32 sum in XLA's order, so the
    clipped gradients differ in the last fp32 place."""
    jmodel, jparams = _jax_model()
    model = _port_model(jmodel, jparams)
    lr = (1e-2, 1, 10)
    tx = jax_optim.make_optimizer(
        jparams, jax_optim.cosine_lr(*lr), grad_clip_norm=1.0,
        moment_dtype=None if mu_dtype is None else jnp.bfloat16)
    jstate = tx.init(jparams)
    jupdate = jax.jit(lambda g, st, p: tx.update(g, st, p))
    opt = make_optimizer(model, cosine_lr(*lr), grad_clip_norm=1.0,
                         moment_dtype=None if mu_dtype is None
                         else torch.bfloat16)
    state = opt.init()
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree.flatten(jparams)
    norms = []
    for _ in range(3):
        g = jax.tree.unflatten(treedef, [jnp.asarray(
            grad_scale * rng.standard_normal(np.shape(v)), jnp.float32)
            for v in leaves])
        norms.append(float(optax.global_norm(g)))
        upd, jstate = jupdate(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state, norm = opt.update(state, params_from_jax(g, jmodel.cfg))
        _close(float(norm), norms[-1], 1e-6)
    assert (max(norms) < 1.0) == (grad_scale < 1.0)
    _assert_params(model, jparams, jmodel.cfg,
                   atol=2e-6 if mu_dtype is None else 2 ** -7 * lr[0])
    adam = jstate[1][0]
    assert state.count == int(adam.count) == 3 and state.schedule_count == 3
    for name, want in params_from_jax(adam.mu, jmodel.cfg).items():
        want = want.numpy()
        _close(state.mu[name].float().numpy(), want,
               1e-6 if mu_dtype is None else 1.6e-2,
               1e-9 if mu_dtype is None else 2 ** -8 * np.abs(want).max(),
               name)


@pytest.mark.parametrize("precision", ["fp32", "pure_bf16"])
def test_global_norm_matches_optax(precision):
    """The clip's norm on the same gradients, against optax.global_norm as
    the JAX package's jitted step computes it. In pure_bf16 optax rounds
    each stacked leaf's sum of squares to bf16 (up to 2^-9 relative each),
    far beyond 1e-6; the port rounds at the same points, so
    the two agree within fp32 summation error: 1e-6 relative."""
    jmodel, jparams = _jax_model(precision)
    model = _port_model(jmodel, jparams, precision)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0)
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda v: jnp.asarray(
        rng.standard_normal(np.shape(v)), jnp.asarray(v).dtype), jparams)
    want = float(jax.jit(optax.global_norm)(g))
    grads = {n: t.to(opt.params[n].dtype)
             for n, t in params_from_jax(g, jmodel.cfg).items()}
    _close(float(opt.global_norm(grads)), want, 1e-6)


def _jax_step(jmodel, jparams, precision_lr=LR, mu=None):
    tx = jax_optim.make_optimizer(
        jparams, jax_optim.cosine_lr(*precision_lr.values()),
        grad_clip_norm=1.0, moment_dtype=mu)
    return tx, jax_ts.TrainState.create(jparams, tx), \
        jax_ts.make_train_step(jmodel, tx)


def test_gradients_match_jax_including_pooled_ln():
    """Every parameter's gradient of the contrastive loss. ln_post and
    ln_final run on the pooled token only in the port and over the whole
    sequence in the JAX package; LayerNorm is per token, so the gradients,
    of those gains too, agree."""
    jmodel, jparams = _jax_model()
    model = _port_model(jmodel, jparams)
    images, texts = _batch()

    def loss_fn(p):
        out = apply_clip(p, jnp.asarray(images), jnp.asarray(texts),
                         jmodel.cfg, compute_dtype=jnp.float32)
        return jax_losses.ClipLoss()(out["image_features"],
                                     out["text_features"], out["logit_scale"])
    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    out = model(images, texts)
    got = losses.ClipLoss()(out["image_features"], out["text_features"],
                            out["logit_scale"])
    got.backward()
    _close(float(got.detach()), float(want), 1e-6)
    wg = params_from_jax(jgrads, jmodel.cfg)
    for name, p in model.named_parameters():
        scale = float(np.abs(wg[name].numpy()).max())
        _close(p.grad.numpy(), wg[name].numpy(), 1e-5, 1e-5 * scale + 1e-9,
               name)
    assert float(np.abs(wg["visual.ln_post.scale"].numpy()).max()) > 0
    assert float(np.abs(wg["text.ln_final.scale"].numpy()).max()) > 0


def test_train_step_matches_jax_three_fp32_steps():
    jmodel, jparams = _jax_model()
    model = _port_model(jmodel, jparams)
    images, texts = _batch()
    _, jstate, jstep = _jax_step(jmodel, jparams)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
        state, m = step(state, images, texts)
        tol = 1e-6 if i == 0 else 1e-5
        _close(float(m["loss"]), float(jm["loss"]), tol, what=f"loss {i}")
        _close(float(m["logit_scale"]), float(jm["logit_scale"]), tol,
               what=f"logit_scale {i}")
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-5,
               what=f"grad_norm {i}")
    assert state.step == 3
    _assert_params(model, jstate.params, jmodel.cfg, atol=1e-6,
                   loose=3 * 2 * LR["base_lr"], frac=0.99)


# ViT-H/14's vision head width: 80 (two heads of a 160-wide tower)
OVERRIDES_D80 = dict(OVERRIDES, vision_cfg=dict(OVERRIDES["vision_cfg"],
                                                width=160, head_width=80))


def test_recompute_train_step_matches_jax_head_width_80(monkeypatch):
    """bench.py's ViT-L/14 and ViT-H/14 legs train with MCT_MHA_SAVE_PROBS=0;
    the port's counterpart is attn_save_probs=False. Three fp32 steps with
    a vision head of width 80 against a step jitted after the variable is
    set (the JAX side reads it at trace time; on the CPU its attention is
    XLA's, differentiated by JAX), at the tolerances of the saved-P run."""
    monkeypatch.setenv("MCT_MHA_SAVE_PROBS", "0")
    jmodel, jparams = _jax_model(overrides=OVERRIDES_D80)
    assert jmodel.cfg.vision.head_width == 80
    model = _port_model(jmodel, jparams, overrides=OVERRIDES_D80,
                        attn_save_probs=False)
    assert not model.attn_save_probs
    images, texts = _batch()
    _, jstate, jstep = _jax_step(jmodel, jparams)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
        state, m = step(state, images, texts)
        tol = 1e-6 if i == 0 else 1e-5
        _close(float(m["loss"]), float(jm["loss"]), tol, what=f"loss {i}")
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-5,
               what=f"grad_norm {i}")
    _assert_params(model, jstate.params, jmodel.cfg, atol=1e-6,
                   loose=3 * 2 * LR["base_lr"], frac=0.99)


def test_recompute_mode_saves_row_stats_not_probs(monkeypatch):
    """attn_save_probs=False: every training attention forward writes the
    row statistics and no P, and the backward recomputes."""
    jmodel, jparams = _jax_model()
    model = _port_model(jmodel, jparams, attn_save_probs=False)
    asked, backward = [], []
    fwd, bwd = port_mha.fused_mha_fwd, port_mha.fused_mha_bwd_recompute

    def spy(*args, **kw):
        asked.append((kw.get("with_probs", False), kw.get("with_stats")))
        return fwd(*args, **kw)

    def spy_bwd(*args, **kw):
        backward.append(args[2].shape)
        return bwd(*args, **kw)
    monkeypatch.setattr(port_mha, "fused_mha_fwd", spy)
    monkeypatch.setattr(port_mha, "fused_mha_bwd_recompute", spy_bwd)
    monkeypatch.setattr(port_mha, "fused_mha_bwd", None)
    images, texts = _batch()
    out = model(images, texts)
    losses.ClipLoss()(out["image_features"], out["text_features"],
                      out["logit_scale"]).backward()
    assert asked == [(False, True)] * 4
    assert backward == [(2, BATCH, 2, 16)] * 2 + [(2, BATCH, 2, 17)] * 2


def test_bridge_carries_a_jax_state_into_the_port():
    """A JAX state after two steps, carried over with params_from_jax and
    opt_state_from_jax; one more step on each side agrees."""
    jmodel, jparams = _jax_model()
    images, texts = _batch()
    _, jstate, jstep = _jax_step(jmodel, jparams)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
    model = _port_model(jmodel, jstate.params)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0)
    state = TrainState(model=model, opt_state=opt_state_from_jax(
        jstate.opt_state, jmodel.cfg, opt.init()), step=2)
    assert (state.opt_state.count, state.opt_state.schedule_count) == (2, 2)
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
    state, m = make_train_step(model, opt)(state, images, texts)
    _close(float(m["loss"]), float(jm["loss"]), 1e-6)
    _close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-5)
    _assert_params(model, jstate.params, jmodel.cfg, atol=1e-6,
                   loose=2 * LR["base_lr"], frac=0.99)


def test_pure_bf16_step_keeps_bf16_weights_and_fp32_logit_scale():
    """One pure_bf16 step on each side from the same bf16 weights. The
    weights stay bf16 and logit_scale fp32. Both sides round at the same
    points in principle, but XLA may keep bf16 intermediates in fp32 and
    the port's biased linears round once (ops/dense.py), so the loss is
    held to 1e-2 relative and grad_norm to 3e-2. Adam moves an element by
    about lr times the sign of a gradient near 0, so where the two sides'
    bf16 roundings give such a gradient another sign (the key biases,
    whose gradient is 0 in exact arithmetic, and a few others) the weights
    differ by up to 2 lr: every weight is held to 2 lr plus two bf16 ulps
    (rtol 1.6e-2), and 99% of them to 2e-4 plus two ulps."""
    jmodel, jparams = _jax_model("pure_bf16")
    model = _port_model(jmodel, jparams, "pure_bf16")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes.pop("logit_scale") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    images, texts = _batch()
    _, jstate, jstep = _jax_step(jmodel, jparams, mu=jnp.bfloat16)
    opt = make_optimizer(model, cosine_lr(*LR.values()), grad_clip_norm=1.0,
                         moment_dtype=torch.bfloat16)
    state, m = make_train_step(model, opt)(TrainState.create(model, opt),
                                           images, texts)
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(texts))
    assert model.logit_scale.dtype == torch.float32
    assert all(state.opt_state.mu[n].dtype == torch.bfloat16 for n in dtypes)
    assert np.isfinite(float(m["loss"]))
    _close(float(m["loss"]), float(jm["loss"]), 1e-2)
    _close(float(m["grad_norm"]), float(jm["grad_norm"]), 3e-2)
    _assert_params(model, jstate.params, jmodel.cfg, atol=2e-4, rtol=1.6e-2,
                   loose=2 * LR["base_lr"], frac=0.99)


def test_bf16_policy_sends_fp32_gradients_to_fp32_master_weights():
    """Under `bf16` the weights stay fp32 and are cast at use; the casts'
    backward carries each gradient back to fp32. Against the fp32 run: bf16
    activations round to 8 significant bits at every op of four blocks,
    which moves each leaf's gradient by up to ~5% of its norm here, so each
    leaf is held to 10% and the whole gradient to cosine 0.999."""
    jmodel, jparams = _jax_model()
    images, texts = _batch()
    grads = {}
    for precision in ("fp32", "bf16"):
        model = _port_model(jmodel, jparams, precision)
        out = model(images, texts)
        losses.ClipLoss()(out["image_features"], out["text_features"],
                          out["logit_scale"]).backward()
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        grads[precision] = {n: p.grad for n, p in model.named_parameters()}
    for name, want in grads["fp32"].items():
        got = grads["bf16"][name]
        assert float((got - want).norm()) <= 0.1 * float(want.norm()), name
    a, b = (torch.cat([g.flatten() for g in grads[k].values()])
            for k in ("fp32", "bf16"))
    assert float(a @ b / (a.norm() * b.norm())) >= 0.999


def test_serving_encoders_take_no_gradient_and_write_no_probs(monkeypatch):
    jmodel, jparams = _jax_model()
    model = _port_model(jmodel, jparams)
    asked = []
    fwd = port_mha.fused_mha_fwd

    def spy(*args, **kw):
        asked.append(kw.get("with_probs", False))
        return fwd(*args, **kw)
    monkeypatch.setattr(port_mha, "fused_mha_fwd", spy)
    images, texts = _batch()
    feats = [model.encode_image(images), model.encode_text(texts)]
    assert not any(f.requires_grad for f in feats)
    assert asked == [False] * 4
    out = model(images, texts)
    assert out["image_features"].requires_grad
    assert asked[4:] == [True] * 4
