"""The port's GPT (models/gpt.py, ops/cross_entropy.py, the GPT train step)
against the JAX package's `gpt_loss` and bench.py's optax chain on the CPU.

A small GPT (2 layers, width 64, 2 heads, vocab 512) at S = 1100, above the
fused-MHA gate, so the port's blocks run the flash path (its plain versions
here); the JAX package's run sdpa_bshd on the CPU, the same function.
The GPT of examples/pretrain_gpt_dist.sh (rope, swiglu, rmsnorm, biases,
tied embedding) cut to 2 layers of width 64, 4 heads, vocab 512, S = 256
(the flash path from MIN_FLASH_SEQ on), with and without grouped-query
attention, its loss through the fused CE (the JAX side's Pallas kernels
in interpret mode) and through full logits, under the same tolerances.
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
EXAMPLE = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=512,
               seq_length=256, position_embedding="rope", swiglu=True,
               normalization="rmsnorm")
BATCH = 2


def _setup(dtype="float32", seed=0, base=SMALL, **over):
    kw = dict(base, **over)
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


@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("over", [{}, dict(kv_heads=2, tie_embeddings=False)],
                         ids=["tied", "gqa_untied"])
def test_example_gpt_loss_and_gradients_match_jax(over, fused_ce):
    jcfg, params, model, tokens = _setup(base=EXAMPLE, **over)
    assert not hasattr(model, "pos_embed")
    jt = jnp.asarray(tokens, jnp.int32)
    want, want_g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
        p, jt, jcfg, compute_dtype=jnp.float32, fused_ce=fused_ce))(params)
    got = gpt_loss(model, torch.from_numpy(tokens), fused_ce=fused_ce)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got_g, want_g = _port_grads(model), _jax_grads(want_g, jcfg)
    assert got_g.keys() == want_g.keys()
    for name, w in want_g.items():
        np.testing.assert_allclose(got_g[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_fused_ce_loss_equals_the_chunked_one_with_a_loss_mask():
    _, _, model, tokens = _setup(base=EXAMPLE, seed=4)
    mask = torch.from_numpy(np.random.default_rng(5).random(tokens.shape)
                            > 0.3).float()
    t = torch.from_numpy(tokens)
    torch.testing.assert_close(
        gpt_loss(model, t, loss_mask=mask, fused_ce=True),
        gpt_loss(model, t, loss_mask=mask, loss_seq_chunk=128),
        rtol=1e-6, atol=0)


def test_rope_attention_below_the_flash_gate_raises():
    """With rope the fused-MHA kernels are never taken, and below
    MIN_FLASH_SEQ = 256 the JAX package runs sdpa_bshd, not ported yet."""
    model = GPTModel(GPTCfg(**dict(EXAMPLE, seq_length=128)))
    with pytest.raises(NotImplementedError, match="sdpa_bshd"):
        gpt_loss(model, torch.zeros(1, 129, dtype=torch.long))


def _jax_steps(jcfg, params, tokens, dtype, n, fused_ce=False):
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-4, b1=0.9, b2=0.95,
                                 mu_dtype=jnp.bfloat16))
    opt = tx.init(params)
    tcfg = jcfg.transformer(remat="none", scan_layers=False)

    @jax.jit
    def step(params, opt, tokens):
        loss, g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
            p, tokens, jcfg, tcfg=tcfg, loss_seq_chunk=1024,
            compute_dtype=dtype, fused_ce=fused_ce))(params)
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


def test_example_gpt_three_steps_match_optax():
    """Three fp32 steps of the example GPT (GQA, fused CE) in bench.py's
    chain, under the fp32 bounds of test_three_bench_steps_match_optax."""
    jcfg, params, model, tokens = _setup(base=EXAMPLE, seed=3, kv_heads=2)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_params, want = _jax_steps(jcfg, params, tokens, jnp.float32, 3,
                                   fused_ce=True)
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(model, opt, fused_ce=True)
    for wl, wn in want:
        state, m = step(state, torch.from_numpy(tokens))
        assert abs(float(m["loss"]) - wl) <= 1e-5 * abs(wl)
        assert abs(float(m["grad_norm"]) - wn) <= 1e-5 * abs(wn)
    flat = gpt_params_from_jax(jax.tree.map(np.asarray, want_params),
                               GPTCfg(**EXAMPLE))
    for name, p in model.named_parameters():
        moved = float((flat[name] - init[name]).norm())
        assert float((p.detach() - flat[name]).norm()) <= 1e-3 * moved, name


def test_bridge_carries_the_example_tree():
    """RMSNorm scale-only norms, the swiglu w1 [W, 2 * 4W] and b1, the GQA
    wqkv width (heads + 2 kv_heads) * D, and no pos_embed."""
    cfg = dict(EXAMPLE, kv_heads=2)
    jcfg, params, model, _ = _setup(base=EXAMPLE, kv_heads=2)
    sd = gpt_params_from_jax(params, GPTCfg(**cfg))
    assert sd.keys() == dict(model.named_parameters()).keys()
    assert "pos_embed" not in sd and "ln_f.bias" not in sd
    assert "blocks.0.ln_1.bias" not in sd
    assert sd["blocks.1.mlp.w1"].shape == (64, 2 * 256)
    assert sd["blocks.1.mlp.b1"].shape == (2 * 256,)
    assert sd["blocks.0.attn.wqkv"].shape == (64, (4 + 2 * 2) * 16)
    np.testing.assert_array_equal(sd["blocks.1.mlp.w1"].numpy(),
                                  np.asarray(params["blocks"]["mlp"]["w1"][1]))


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


@pytest.mark.parametrize("over", [dict(squared_relu=True),
                                  dict(kv_channels=16),
                                  dict(num_experts=4)])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTModel(GPTCfg(**SMALL, **over))


@pytest.mark.parametrize("kw", [dict(position_ids=np.arange(8)),
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


# examples/pretrain_gpt_pipeline.sh's GPT (learned positions, gelu_tanh,
# LayerNorm, biases, tied embedding; attention and hidden dropout 0.1) cut
# to 2 layers of width 128, 2 heads: S = 256 takes the flash route, S = 64
# the fused-MHA dropout kernels (the JAX gate's `dropout_kernel_eligible`).
PIPELINE = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=512,
                seq_length=256)
DROPOUT = dict(attention_dropout=0.1, hidden_dropout=0.1)


def _pipeline(seq=256, seed=0, precision=FP32):
    base = dict(PIPELINE, seq_length=seq)
    jcfg, pcfg = jax_gpt.GPTCfg(**base), GPTCfg(**base, **DROPOUT)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(seed), jcfg)
    model = GPTModel(pcfg, precision)
    model.load_state_dict(gpt_params_from_jax(params, pcfg))
    tokens = np.random.default_rng(seed + 1).integers(1, 511, (BATCH,
                                                               seq + 1))
    return jcfg, pcfg, params, model, tokens


@pytest.mark.parametrize("seq", [256, 64])
def test_pipeline_gpt_without_a_seed_matches_jax_without_rng(seq):
    """Rates of 0.1 with no seed drop nothing, as the JAX package's
    rng=None: loss and gradients at the fp32 bounds above."""
    jcfg, pcfg, params, model, tokens = _pipeline(seq)
    tcfg = jcfg.transformer(train=True, **DROPOUT)
    jt = jnp.asarray(tokens, jnp.int32)
    want, want_g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
        p, jt, jcfg, tcfg=tcfg, compute_dtype=jnp.float32, fused_ce=True,
        rng=None))(params)
    got = gpt_loss(model, torch.from_numpy(tokens), fused_ce=True, seed=None)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = gpt_params_from_jax(jax.tree.map(np.asarray, want_g), pcfg)
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("seq", [256, 64])
def test_remat_modes_give_bit_identical_gradients_with_dropout(seq):
    """The JAX package's test_dropout.py:79 for the port: none, selective
    and full recompute replay the same masks, so loss and gradients are
    equal bit for bit."""
    *_, model, tokens = _pipeline(seq, seed=2)
    t = torch.from_numpy(tokens)
    runs = {}
    for remat in ("none", "selective", "full"):
        model.zero_grad(set_to_none=True)
        loss = gpt_loss(model, t, fused_ce=True, seed=99, remat=remat)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()})
    loss, grads = runs["none"]
    for remat in ("selective", "full"):
        assert torch.equal(runs[remat][0], loss), remat
        for name, g in grads.items():
            assert torch.equal(runs[remat][1][name], g), (remat, name)


def test_the_seed_picks_the_masks():
    *_, model, tokens = _pipeline(seed=3)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        a, b = (gpt_loss(model, t, fused_ce=True, seed=5) for _ in range(2))
        other = gpt_loss(model, t, fused_ce=True, seed=6)
        clean = gpt_loss(model, t, fused_ce=True)
    assert torch.equal(a, b)
    assert float(other) != float(a) and float(clean) != float(a)


def test_three_dropout_steps_lower_the_loss():
    """make_gpt_train_step with a seed: each step draws from its own folded
    seed, and three steps at rate 0.1 lower the loss on a fixed batch."""
    *_, model, tokens = _pipeline(seed=4)
    opt = make_gpt_optimizer(model, lr=3e-3)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(model, opt, fused_ce=True, remat="selective",
                               seed=1234)
    losses = []
    for _ in range(3):
        state, m = step(state, torch.from_numpy(tokens))
        losses.append(float(m["loss"]))
    assert state.step == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_remat_mlp_is_refused_and_others_checked():
    """remat="mlp" is taken since it was ported (its parity is in
    test_torch_remat_mlp.py); a mode the JAX package does not have raises."""
    assert GPTCfg(**PIPELINE, remat="mlp").transformer().remat == "mlp"
    with pytest.raises(ValueError, match="remat"):
        GPTCfg(**PIPELINE, remat="dots").transformer()
    *_, model, _ = _pipeline(seq=64)
    opt = make_gpt_optimizer(model)
    make_gpt_train_step(model, opt, remat="mlp")
    with pytest.raises(ValueError, match="remat"):
        make_gpt_train_step(model, opt, remat="dots")


def test_bridge_carries_the_pipeline_tree_at_full_width():
    """examples/pretrain_gpt_pipeline.sh's widths (2048 wide, 16 heads,
    learned positions), 2 layers and a small vocabulary: dropout adds no
    parameter, so the JAX tree maps onto the port's model as it is."""
    kw = dict(num_layers=2, hidden_size=2048, num_heads=16, vocab_size=512,
              seq_length=64)
    jcfg, pcfg = jax_gpt.GPTCfg(**kw), GPTCfg(**kw, **DROPOUT)
    shapes = jax.eval_shape(lambda k: jax_gpt.init_gpt(k, jcfg),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params["blocks"]["mlp"]["w1"][1, 3, 5] = 7.0
    sd = gpt_params_from_jax(params, pcfg)
    with torch.device("meta"):
        model = GPTModel(pcfg)
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(t.shape) for n, t in sd.items()} == want
    assert want["blocks.1.attn.wqkv"] == (2048, 3 * 2048)
    assert want["pos_embed"] == (64, 2048)
    assert float(sd["blocks.1.mlp.w1"][3, 5]) == 7.0


# The "bf16" precision (fp32 weights, bf16 compute), the one that
# examples/pretrain_gpt_dist.sh's and pretrain_gpt_pipeline.sh's GPTs train
# in, against JAX gpt_loss(compute_dtype=bfloat16) on the same fp32
# weights. Bounds derived as the pure-bf16 ones above: the loss within
# 2e-3 relative; each gradient leaf within 5e-2 of its largest |value| and
# within 2e-2 of its norm. bf16 rounds each activation to 2^-9 relative and
# the two packages round at other points (the biased projections, XLA's fp32
# intermediates), so each gradient element can move by a few bf16 ulps of
# the leaf's largest element (2^-8 each); measured (3 seeds, with and
# without the fused CE) losses within 3.6e-5 relative and leaves within
# 2.5% of their largest |value|.
@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("which", ["example", "pipeline", "pipeline_fused"])
def test_bf16_compute_on_fp32_weights_matches_jax(which, fused_ce):
    from megatron_clip_tpu_torch.config import BF16
    kw = {"example": EXAMPLE, "pipeline": PIPELINE,
          "pipeline_fused": dict(PIPELINE, seq_length=64)}[which]
    jcfg, pcfg = jax_gpt.GPTCfg(**kw), GPTCfg(**kw)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    model = GPTModel(pcfg, BF16)
    model.load_state_dict(gpt_params_from_jax(params, pcfg))
    tokens = np.random.default_rng(1).integers(1, 511,
                                               (BATCH, kw["seq_length"] + 1))
    want, want_g = jax.value_and_grad(lambda p: jax_gpt.gpt_loss(
        p, jnp.asarray(tokens, jnp.int32), jcfg, compute_dtype=jnp.bfloat16,
        fused_ce=fused_ce))(params)
    got = gpt_loss(model, torch.from_numpy(tokens), fused_ce=fused_ce)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 2e-3 * abs(float(want))
    want_g = gpt_params_from_jax(jax.tree.map(np.asarray, want_g), pcfg)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        w, g = want_g[name], p.grad
        assert float((g - w).abs().max()) <= 5e-2 * float(w.abs().max()), \
            name
        assert float((g - w).norm()) <= 2e-2 * float(w.norm()), name


def test_the_optimizer_update_in_chunks_equals_one_pass(monkeypatch):
    """The AdamW chain runs over chunks of CHUNK_ELEMENTS elements (its
    temporaries for the 1.7B-parameter GPT would not fit the card in one
    pass): every step is elementwise, so the chunks change no bit."""
    from megatron_clip_tpu_torch.training import optim
    runs = []
    for chunk in (1 << 40, 5000):
        monkeypatch.setattr(optim, "CHUNK_ELEMENTS", chunk)
        *_, model, tokens = _pipeline(seq=64, seed=6)
        opt = make_gpt_optimizer(model, lr=1e-3)
        chunks = list(opt._chunks(opt.groups[0][1]))
        assert (len(chunks) == 1) == (chunk > 1 << 30)
        state = TrainState.create(model, opt)
        step = make_gpt_train_step(model, opt, fused_ce=True)
        for _ in range(2):
            state, _ = step(state, torch.from_numpy(tokens))
        runs.append(({n: p.detach().clone()
                      for n, p in model.named_parameters()},
                     state.opt_state))
    (p1, s1), (p2, s2) = runs
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
        assert torch.equal(s1.mu[name], s2.mu[name]), name
        assert torch.equal(s1.nu[name], s2.nu[name]), name
