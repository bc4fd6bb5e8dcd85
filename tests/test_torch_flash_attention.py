"""The port's flash attention (its plain versions, which CPU tensors take)
against the JAX package's `flash_attention`, whose Pallas kernels run in
interpret mode on the CPU as tests/test_flash_attention.py runs them.

Inputs come from numpy with a seed and go to both sides. Tolerances: fp32
those of the JAX suite, forward 2e-5 and gradients 5e-5 (the log-sum-exp
too); the fused backward against the split one 2e-5, as the JAX suite holds
its two kernels. bf16: both sides form fp32 scores from the same bf16
inputs over one block of every key, so they round P, dS and the outputs at
the same places; the fp32 sums run in another order, so a value on a
rounding boundary can round the other way: one bf16 ulp (rtol 8e-3) plus
2^-8 of the largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops.attention import multi_head_attention as jax_mha
from megatron_clip_tpu.ops.pallas import flash_attention as jfa
from megatron_clip_tpu_torch.ops.attention import multi_head_attention
from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa


def _inputs(seed, b=2, h=2, sq=256, sk=256, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _jax_lse(q, k, v, causal):
    """The JAX forward kernel's lse [B, H, Sq], from `_flash_fwd` at
    `flash_attention`'s padding and blocks."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    blocks = [min(1024, -(-s // 128) * 128) for s in (sq, sk)]
    pads = [-(-s // blk) * blk for s, blk in zip((sq, sk), blocks)]

    def flat(t, s_pad):
        t = t.reshape(b * h, t.shape[2], d)
        return jnp.pad(t, ((0, 0), (0, s_pad - t.shape[1]), (0, 0)))
    _, lse = jfa._flash_fwd(flat(q, pads[0]), flat(k, pads[1]),
                            flat(v, pads[1]), jnp.zeros((1,), jnp.int32),
                            scale=d ** -0.5, causal=causal,
                            block_q=blocks[0], block_k=blocks[1], kv_len=sk)
    return np.asarray(lse)[:, 0, :sq].reshape(b, h, sq)


def _both(arrays, dtype, causal):
    """(port out, lse, grads) and (JAX out, lse, grads) of sum(out * dO)."""
    q, k, v, do = arrays
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in arrays)
    want = jfa.flash_attention(jq, jk, jv, causal=causal)
    want_g = jax.grad(lambda a, b, c: jnp.sum(
        (jfa.flash_attention(a, b, c, causal=causal) * jdo).astype(
            jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_(True)
                  for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    got_g = torch.autograd.grad(got, (tq, tk, tv),
                                torch.from_numpy(do).to(td))
    _, lse = fa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                q.shape[-1] ** -0.5, causal)
    f32 = (lambda t: np.asarray(t.astype(jnp.float32)))
    return ((got.detach().float().numpy(), lse.numpy(),
             [g.float().numpy() for g in got_g]),
            (f32(want), _jax_lse(jq, jk, jv, causal),
             [f32(g) for g in want_g]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 128), (200, 200),
                                   (128, 256), (256, 200)])
def test_forward_lse_and_gradients_match_jax(causal, sq, sk):
    (out, lse, grads), (w_out, w_lse, w_grads) = _both(
        _inputs(0, sq=sq, sk=sk), "float32", causal)
    np.testing.assert_allclose(out, w_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse, w_lse, rtol=5e-5, atol=5e-5)
    for g, w, name in zip(grads, w_grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 200), (128, 256)])
def test_bf16_matches_jax(causal, sq, sk):
    (out, lse, grads), (w_out, w_lse, w_grads) = _both(
        _inputs(1, sq=sq, sk=sk), "bfloat16", causal)
    for got, want in ((out, w_out), *zip(grads, w_grads)):
        np.testing.assert_allclose(got, want, rtol=8e-3,
                                   atol=2 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(lse, w_lse, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_backward_matches_split(causal, monkeypatch):
    """The port's fused and split plain backward against the JAX package's
    split and fused kernels (three 128-key blocks, MCT_FLASH_SPLIT_BWD as
    tests/test_flash_attention.py sets it)."""
    q, k, v, do = _inputs(7, b=1, sq=384, sk=384)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    def f(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal=causal,
                                           block_q=128, block_k=128) * jdo)
    want = {}
    for split in ("1", "0"):
        monkeypatch.setenv("MCT_FLASH_SPLIT_BWD", split)
        want[split] = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_fwd(tq, tk, tv, causal=causal)
    delta = fa.flash_delta(tdo, out)
    fused = fa.flash_bwd_fused(tq, tk, tv, out, lse, tdo, causal=causal)
    split = (fa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=causal),
             *fa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal=causal))
    for got, w in ((fused, want["1"]), (split, want["0"])):
        for g, wg, name in zip(got, w, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=2e-5,
                                       atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("s", [200, 1100, 2048, 4096, 4097, 4200, 8192])
def test_backward_choice_follows_the_jax_package(s, monkeypatch):
    """Fused while the keys, padded to their block, span <= 4 of the JAX
    package's blocks (`_flash_bwd` with flash_attention's default blocks),
    and on the CPU the wrappers take the matching plain versions."""
    block = min(1024, -(-s // 128) * 128)
    sk_pad = -(-s // block) * block
    assert fa.uses_fused_bwd(s) == (sk_pad // block <= 4)
    assert fa.uses_fused_bwd(s) == (s <= 4096)
    calls = []
    monkeypatch.setattr(fa, "flash_bwd_fused_plain",
                        lambda *a: calls.append("fused") or (None,) * 3)
    monkeypatch.setattr(fa, "flash_bwd_dq_plain",
                        lambda *a: calls.append("dq"))
    monkeypatch.setattr(fa, "flash_bwd_dkv_plain",
                        lambda *a: calls.append("dkv") or (None,) * 2)
    t = torch.zeros(1, 1, s, 8)
    fa.flash_bwd(t, t, t, t, torch.zeros(1, 1, s), t, causal=True,
                 scale=1.0)
    assert calls == (["fused"] if s <= 4096 else ["dq", "dkv"])


def test_packed_entry_matches_the_public_function():
    """flash_attention_qkv on a packed [B, S, 3*H*D] projection gives
    flash_attention's output and, as one packed tensor, its gradients."""
    rng = np.random.default_rng(3)
    b, s, h, d = 1, 300, 3, 32
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(
        np.float32))
    out = fa.flash_attention_qkv(qkv, h, causal=True)
    (dqkv,) = torch.autograd.grad(out, qkv, g)
    x = qkv.detach().requires_grad_(True)
    q, k, v = x.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    want = fa.flash_attention(q, k, v, causal=True)
    want = want.transpose(1, 2).reshape(b, s, h * d)
    (want_g,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(dqkv, want_g, rtol=0, atol=0)
    # a dropout rate without a seed is eval: the rate-0 function
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, causal=True, dropout_rate=0.1).transpose(
            1, 2).reshape(b, s, h * d), want, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_takes_the_flash_path_above_1024(causal):
    """At S = 1100 the JAX package's fused gate is closed: its block runs
    flash on a TPU and sdpa_bshd here; the port's runs the flash path."""
    rng = np.random.default_rng(4)
    b, s, w, h = 1, 1100, 64, 2
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = {"wqkv": rng.standard_normal((w, 3 * w)) * w ** -0.5,
              "bqkv": rng.standard_normal(3 * w) * 0.1,
              "wo": rng.standard_normal((w, w)) * w ** -0.5,
              "bo": rng.standard_normal(w) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want = jax_mha(jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in params.items()}, h,
                   causal=causal)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = multi_head_attention(tx, {k: torch.from_numpy(v)
                                    for k, v in params.items()}, h,
                               causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    (gx,) = torch.autograd.grad(got.sum(), tx)
    want_gx = jax.grad(lambda a: jnp.sum(jax_mha(
        a, {k: jnp.asarray(v) for k, v in params.items()}, h,
        causal=causal)))(jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), rtol=5e-5,
                               atol=5e-5)


# The dropout route. The JAX package's flash dropout needs the TPU's PRNG
# (no interpret lowering), so on the CPU its reference is `sdpa` with
# `_drop_probs`, the route the JAX package itself takes there. Its
# jax.random.bernoulli mask is fed to the port's plain versions as keep /
# (1 - rate) multipliers: forward 2e-5 and q, k, v gradients 5e-5, the
# bounds of tests/test_flash_attention.py. sdpa divides the normalised fp32
# probabilities by 1 - rate, the flash arithmetic multiplies the
# unnormalised p by fp32 1/(1 - rate) and divides by l after P.V: the same
# function, fp32 roundings apart.
@pytest.mark.parametrize("causal", [True, False])
def test_dropout_route_matches_jax_sdpa_with_its_mask(causal):
    from megatron_clip_tpu.ops.attention import sdpa as jax_sdpa
    rate, b, h, s, d = 0.1, 2, 2, 300, 32
    q, k, v, do = _inputs(7, b=b, h=h, sq=s, sk=s, d=d)
    key = jax.random.PRNGKey(5)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))

    def f(a, b_, c):
        return jax_sdpa(a, b_, c, causal=causal, dropout_rate=rate,
                        dropout_rng=key)
    want, vjp = jax.vjp(f, jq, jk, jv)
    want_g = vjp(jdo)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (b, h, s, s)))
    mult = torch.from_numpy(keep).float() * fa.dropout_mult(rate)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(tq, tk, tv, scale, causal, mult)
    grads = fa.flash_bwd_fused_plain(tq, tk, tv, out, lse, tdo, scale, causal,
                                     mult)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for got, w in zip(grads, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)
    # the split backward is the same function
    delta = fa.flash_delta(tdo, out)
    np.testing.assert_allclose(
        fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, scale, causal,
                              mult).numpy(), grads[0].numpy(), rtol=2e-5,
        atol=2e-5)


def test_dropout_autograd_uses_the_philox_mask():
    """flash_attention with dropout on the CPU: the plain versions fed the
    kernels' Philox mask of (seed, offset), forward and backward alike;
    the packed entry gives the same function."""
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    b, h, s, d = 1, 2, 300, 32
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(8, b=b, h=h, sq=s,
                                                          sk=s, d=d))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, dropout_rate=0.1, seed=3,
                             offset=11)
    grads = torch.autograd.grad(out, leaves, do)
    keep = AttentionDropout(0.1, 3, 11).multipliers(b, h, s, s,
                                                    fa.dropout_mult(0.1))
    want, lse = fa.flash_fwd_plain(q, k, v, d ** -0.5, True, keep)
    assert torch.equal(out, want)
    for got, w in zip(grads, fa.flash_bwd_fused_plain(
            q, k, v, want, lse, do, d ** -0.5, True, keep)):
        assert torch.equal(got, w)
    qkv = torch.stack([q, k, v], 2).permute(0, 3, 2, 1, 4).reshape(
        b, s, 3 * h * d)
    packed = fa.flash_attention_qkv(qkv, h, causal=True, dropout_rate=0.1,
                                    seed=3, offset=11)
    assert torch.equal(packed, want.transpose(1, 2).reshape(b, s, h * d))
