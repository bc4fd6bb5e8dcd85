"""The port's GPT (models/gpt.py, ops/cross_entropy.py, the GPT train step)
against the JAX package's `gpt_loss` and bench.py's optax chain on the CPU.

A small GPT (2 layers, width 64, 2 heads, vocab 512) at S = 1100, above the
fused-MHA gate, so the port's blocks run the flash path (its plain versions
here); the JAX package's run sdpa_bshd on the CPU, the same function.
Weights come from JAX `init_gpt` through `bridge.gpt_params_from_jax`;
tokens from numpy with a seed.

Tolerances, with their reasons:
- fp32 loss 1e-5 relative: logsumexp over 512 logits and the mean over
  2,200 tokens in another order.
- fp32 gradients: each within 1e-4 of its own largest |value| (sums over
  2,200 tokens in another order; a tied embedding's two terms).
- Three steps of bench.py's chain (clip 1.0, adamw(1e-4, b1=0.9, b2=0.95,
  mu_dtype=bf16)): fp32 losses and gradient norms 1e-5 relative; each
  parameter's distance from JAX's within 1e-3 of the distance the three
  steps moved it. Adam moves an element by lr g / (|g| + eps), so where
  gradients agree to 1e-5 relative the steps agree, but an element whose
  gradient is at rounding level can step by lr either way (measured: 4e-4,
  a bias of the first MLP).
  Pure bf16: the JAX package rounds each bf16 product before adding its
  bias and the port rounds once (ROADMAP Queue C), and XLA keeps some bf16
  intermediates in fp32 where PyTorch rounds them: losses within 2e-3
  relative; the gradient norm, a bf16 sum of bf16 leaf sums in tree order
  on both sides, within 8e-3 (two bf16 ulps); each parameter's distance
  from JAX's within half the distance the three steps moved it, so that an
  update left out or skipped for a leaf (distance 1) fails. Measured: at
  most 0.33 (attn.bqkv, the leaf the bias rounding reaches), 0.01-0.14 for
  the others. The LayerNorm gains do not move in bf16 (a step of 3e-4 is
  under half an ulp of 1) on either side and must equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megatron_clip_tpu.models import gpt as jax_gpt
from megatron_clip_tpu_torch.bridge import gpt_params_from_jax
from megatron_clip_tpu_torch.config import FP32, PURE_BF16
from megatron_clip_tpu_torch.models.gpt import (GPTCfg, GPTModel, create_gpt,
                                                gpt_loss)
from megatron_clip_tpu_torch.ops.cross_entropy import cross_entropy
from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
from megatron_clip_tpu_torch.training import (TrainState, make_gpt_optimizer,
                                              make_gpt_train_step)

SMALL = dict(num_layers=2, hidden_size=64, num_heads=2, vocab_size=512,
             seq_length=1100)
BATCH = 2


def _setup(dtype="float32", seed=0, **over):
    kw = dict(SMALL, **over)
    jcfg, pcfg = jax_gpt.GPTCfg(**kw), GPTCfg(**kw)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = jax_gpt.init_gpt(jax.random.PRNGKey(seed), jcfg, dtype=jd)
    prec = FP32 if dtype == "float32" else PURE_BF16
    model = GPTModel(pcfg, prec).to(prec.param_torch)
    model.load_state_dict(gpt_params_from_jax(params, pcfg,
                                              dtype=prec.param_torch))
    tokens = np.random.default_rng(seed + 1).integers(
        1, kw["vocab_size"] - 1, (BATCH, kw["seq_length"] + 1))
    return jcfg, params, model, tokens


def _port_grads(model):
    return {n: p.grad.float().numpy() for n, p in model.named_parameters()}


def _jax_grads(grads, cfg):
    flat = gpt_params_from_jax(jax.tree.map(np.asarray, grads),
                               GPTCfg(**SMALL))
    return {n: t.numpy() for n, t in flat.items()}


@pytest.mark.parametrize("chunk", [0, 512])
def test_loss_and_gradients_match_jax(chunk):
    jcfg, params, model, tokens = _setup()
    jt = jnp.asarray(tokens, jnp.int32)
    want, want_g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
        p, jt, jcfg, compute_dtype=jnp.float32, loss_seq_chunk=chunk))(
            params)
    before = fa.flash_fwd.launches
    got = gpt_loss(model, torch.from_numpy(tokens), loss_seq_chunk=chunk)
    got.backward()
    assert fa.flash_fwd.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got_g, want_g = _port_grads(model), _jax_grads(want_g, jcfg)
    assert got_g.keys() == want_g.keys()
    for name, w in want_g.items():
        np.testing.assert_allclose(got_g[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_chunked_loss_equals_the_whole_one_with_a_loss_mask():
    _, _, model, tokens = _setup(seed=2)
    mask = torch.from_numpy(np.random.default_rng(5).random(tokens.shape)
                            > 0.3).float()
    t = torch.from_numpy(tokens)
    whole = gpt_loss(model, t, loss_mask=mask)
    for chunk in (256, 1024, 4096):
        torch.testing.assert_close(
            gpt_loss(model, t, loss_mask=mask, loss_seq_chunk=chunk), whole,
            rtol=1e-6, atol=0)


def _jax_steps(jcfg, params, tokens, dtype, n):
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-4, b1=0.9, b2=0.95,
                                 mu_dtype=jnp.bfloat16))
    opt = tx.init(params)
    tcfg = jcfg.transformer(remat="none", scan_layers=False)

    @jax.jit
    def step(params, opt, tokens):
        loss, g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
            p, tokens, jcfg, tcfg=tcfg, loss_seq_chunk=1024,
            compute_dtype=dtype))(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, loss, \
            optax.global_norm(g)
    jt = jnp.asarray(tokens, jnp.int32)
    out = []
    for _ in range(n):
        params, opt, loss, norm = step(params, opt, jt)
        out.append((float(loss), float(norm)))
    return params, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_bench_steps_match_optax(dtype):
    jcfg, params, model, tokens = _setup(dtype, seed=3)
    init = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    want_params, want = _jax_steps(jcfg, params, tokens,
                                   getattr(jnp, dtype), 3)
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(model, opt, loss_seq_chunk=1024)
    got = []
    for _ in range(3):
        state, m = step(state, torch.from_numpy(tokens))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert state.step == 3 and state.opt_state.count == 3
    loss_tol, norm_tol, param_tol = ((1e-5, 1e-5, 1e-3) if dtype == "float32"
                                     else (2e-3, 8e-3, 0.5))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= loss_tol * abs(wl), (got, want)
        assert abs(gn - wn) <= norm_tol * abs(wn), (got, want)
    flat = gpt_params_from_jax(jax.tree.map(np.asarray, want_params),
                               GPTCfg(**SMALL))
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16)
        got_p, w = p.detach().float(), flat[name]
        moved = float((w - init[name]).norm())
        if moved == 0:  # bf16 LayerNorm gains: 1 - 3e-4 rounds back to 1
            torch.testing.assert_close(got_p, w, rtol=0, atol=0, msg=name)
        else:
            assert float((got_p - w).norm()) <= param_tol * moved, name


def test_bridge_carries_the_jax_tree():
    jcfg, params, model, _ = _setup(tie_embeddings=False)
    sd = gpt_params_from_jax(params, GPTCfg(**SMALL, tie_embeddings=False))
    assert sd.keys() == dict(model.named_parameters()).keys()
    assert "lm_head" in sd and sd["blocks.1.attn.wqkv"].shape == (64, 192)
    np.testing.assert_array_equal(sd["blocks.1.mlp.w2"].numpy(),
                                  np.asarray(params["blocks"]["mlp"]["w2"][1]))
    with pytest.raises(ValueError, match="layers"):
        gpt_params_from_jax(params, GPTCfg(**dict(SMALL, num_layers=3)))


def test_megatron_init_laws():
    """attn and fc weights at init_std, the residual outputs (wo, w2) at
    init_std / sqrt(2 L), zero biases, unit LayerNorm gains."""
    cfg = GPTCfg(num_layers=4, hidden_size=256, num_heads=4, vocab_size=512,
                 seq_length=64, init_std=0.02)
    model = create_gpt(cfg, precision="fp32", device="cpu", seed=0)
    p = dict(model.named_parameters())
    for name, std in (("tok_embed", 0.02), ("pos_embed", 0.02),
                      ("blocks.0.attn.wqkv", 0.02), ("blocks.3.mlp.w1", 0.02),
                      ("blocks.0.attn.wo", 0.02 / 8 ** 0.5),
                      ("blocks.2.mlp.w2", 0.02 / 8 ** 0.5)):
        assert abs(float(p[name].detach().std()) / std - 1) < 0.03, name
    assert not p["blocks.1.attn.bqkv"].any() and not p["ln_f.bias"].any()
    assert bool((p["blocks.1.ln_2.scale"] == 1).all())
    twin = create_gpt(cfg, precision="pure_bf16", device="cpu", seed=0)
    assert twin.tok_embed.dtype == torch.bfloat16
    torch.testing.assert_close(twin.tok_embed.float(),
                               p["tok_embed"].bfloat16().float())
    no_bias = GPTModel(GPTCfg(**SMALL, use_bias=False))
    assert not {"bqkv", "bo", "b1", "b2"} & {
        n.split(".")[-1] for n, _ in no_bias.named_parameters()}


def test_create_gpt_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_gpt(GPTCfg(**SMALL))


@pytest.mark.parametrize("over", [dict(position_embedding="rope"),
                                  dict(swiglu=True), dict(squared_relu=True),
                                  dict(normalization="rmsnorm"),
                                  dict(kv_heads=1), dict(kv_channels=16),
                                  dict(num_experts=4)])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTModel(GPTCfg(**SMALL, **over))


@pytest.mark.parametrize("kw", [dict(fused_ce=True),
                                dict(position_ids=np.arange(8)),
                                dict(attn_bias=np.zeros(1))])
def test_unported_loss_options_raise(kw):
    model = GPTModel(GPTCfg(**dict(SMALL, seq_length=8)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt_loss(model, torch.zeros(1, 9, dtype=torch.long), **kw)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    from megatron_clip_tpu.ops.cross_entropy import cross_entropy as jax_ce
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                  label_smoothing=smoothing)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                        label_smoothing=smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_global_norm_of_a_bf16_tree_adds_in_bf16():
    """Every leaf of a pure-bf16 GPT tree is bf16, so optax's Python sum of
    the leaves' bf16 sums runs in bf16, in tree order, and so does its
    square root; the port's global norm gives the same bf16 value."""
    _, params, model, _ = _setup("bfloat16")
    rng = np.random.default_rng(8)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape) * 0.03, jnp.bfloat16), params)
    want = jax.jit(optax.global_norm)(grads)
    assert want.dtype == jnp.bfloat16
    flat = gpt_params_from_jax(jax.tree.map(np.asarray, grads),
                               GPTCfg(**SMALL), dtype=torch.bfloat16)
    got = make_gpt_optimizer(model).global_norm(flat)
    assert float(got) == float(want)
    fp32_sum = sum(float((t.float() ** 2).sum()) for t in flat.values())
    assert float(got) != np.float32(np.sqrt(fp32_sum))
