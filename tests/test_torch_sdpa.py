"""The port's unfused attention (`ops/attention.py::sdpa_bshd` and its
route) against the JAX package's, on the CPU, in fp32.

- `sdpa_bshd` against JAX `sdpa_bshd`, forward and the gradients of q, k,
  v and the bias: causal with an additive document bias, GQA's repeated
  heads, rotated q and k (shared and per-row tables), head_dim 160, and
  dropout, both sides fed one keep mask (the port's draw is its own
  generator's, `ops/dropout.hidden_keep`); at rate 0 with a seed the
  output is bit-equal to the call without dropout.
- `multi_head_attention` on each branch of `attention_route` that now
  takes the unfused route (an additive bias, S < 256 with rope, S < 256
  with GQA, head_dim > 128, use_flash=False, and dropout that neither
  kernel takes) against JAX `multi_head_attention`, which runs
  `sdpa_bshd` on the CPU: the output and the gradients of x and of every
  weight.
- Under selective recompute the route runs under its own checkpoint and
  gives the same gradients.
Tolerances (fp32): outputs 2e-6 absolute and 1e-5 relative, gradients
1e-5 absolute and 1e-4 relative (the einsums sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.ops import attention as jax_attn
from megatron_clip_tpu.ops import rope as jax_rope
from megatron_clip_tpu_torch.ops import attention as attn
from megatron_clip_tpu_torch.ops.dropout import hidden_keep
from megatron_clip_tpu_torch.ops.rope import rope_cos_sin

OUT = dict(atol=2e-6, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _doc_bias(rng, b, s):
    """An additive document mask [B, 1, S, S]: 0 within, -1e30 across."""
    doc = np.cumsum(rng.random((b, s)) < 0.1, axis=1)
    return np.where(doc[:, :, None] == doc[:, None, :], 0.0,
                    -1e30).astype(np.float32)[:, None]


def _grads_jax(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _grads_port(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


CASES = {
    "causal-bias": dict(h=4, hkv=4, d=16, s=48, causal=True, bias=True),
    "bias-no-causal": dict(h=2, hkv=2, d=32, s=40, causal=False, bias=True),
    "gqa": dict(h=4, hkv=2, d=16, s=48, causal=True, bias=False),
    "rope": dict(h=4, hkv=4, d=16, s=48, causal=True, rope="shared"),
    "rope-per-row-gqa": dict(h=4, hkv=1, d=16, s=48, causal=True,
                             rope="per-row", bias=True),
    "head-dim-160": dict(h=2, hkv=2, d=160, s=32, causal=True, bias=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sdpa_bshd_matches_jax(case):
    c = {"bias": False, "rope": None, **CASES[case]}
    b, s, h, hkv, d = 2, c["s"], c["h"], c["hkv"], c["d"]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    bias = _doc_bias(rng, b, s) if c["bias"] else None
    cos = sin = None
    if c["rope"]:
        pos = (np.arange(s) if c["rope"] == "shared"
               else rng.integers(0, s, (b, s)))
        jc, js = jax_rope.rope_cos_sin(s, d)
        cos, sin = np.asarray(jc)[pos], np.asarray(js)[pos]
        tc, ts = rope_cos_sin(s, d)
        np.testing.assert_allclose(tc.numpy()[pos], cos, atol=1e-6)
    rep = h // hkv
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jax_fn(q, k, v):
        if cos is not None:
            q = jax_rope.apply_rope_bshd(q, jnp.asarray(cos), jnp.asarray(sin))
            k = jax_rope.apply_rope_bshd(k, jnp.asarray(cos), jnp.asarray(sin))
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return jax_attn.sdpa_bshd(q, k, v, causal=c["causal"],
                                  bias=None if bias is None
                                  else jnp.asarray(bias))

    def port_fn(q, k, v):
        if cos is not None:
            from megatron_clip_tpu_torch.ops.rope import apply_rope_bshd
            tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
            q, k = apply_rope_bshd(q, tc, ts), apply_rope_bshd(k, tc, ts)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        return attn.sdpa_bshd(q, k, v, causal=c["causal"],
                              bias=None if bias is None
                              else torch.from_numpy(bias))
    want, wg = _grads_jax(jax_fn, (q, k, v), cot)
    got, gg = _grads_port(port_fn, (q, k, v), cot)
    np.testing.assert_allclose(got, want, **OUT)
    for name, g, w in zip("qkv", gg, wg):
        np.testing.assert_allclose(g, w, **GRAD, err_msg=name)


def test_sdpa_bshd_bias_gradient_matches_jax():
    """The bias is an input with a gradient (d logits), as in JAX."""
    rng = np.random.default_rng(3)
    b, s, h, d = 1, 24, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((b, 1, s, s)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    want, wg = _grads_jax(lambda q, k, v, bb: jax_attn.sdpa_bshd(
        q, k, v, causal=True, bias=bb), (q, k, v, bias), cot)
    got, gg = _grads_port(lambda q, k, v, bb: attn.sdpa_bshd(
        q, k, v, causal=True, bias=bb), (q, k, v, bias), cot)
    np.testing.assert_allclose(got, want, **OUT)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, **GRAD)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_sdpa_bshd_dropout_with_a_fed_mask_matches_jax(rate, monkeypatch):
    rng = np.random.default_rng(int(rate * 10))
    b, s, h, d = 2, 32, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    keep = hidden_keep((b, h, s, s), rate, 11, 4, "cpu")
    assert 0 < keep.float().mean() < 1
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep.numpy()))
    want, wg = _grads_jax(lambda q, k, v: jax_attn.sdpa_bshd(
        q, k, v, causal=True, dropout_rate=rate,
        dropout_rng=jax.random.PRNGKey(0)), (q, k, v), cot)
    # the port draws that mask itself from (seed, offset)
    got, gg = _grads_port(lambda q, k, v: attn.sdpa_bshd(
        q, k, v, causal=True, dropout_rate=rate, seed=11, offset=4),
        (q, k, v), cot)
    np.testing.assert_allclose(got, want, **OUT)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, **GRAD)


def test_sdpa_bshd_rate_zero_is_no_dropout():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 20, 2, 8, generator=g) for _ in range(3))
    assert torch.equal(attn.sdpa_bshd(q, k, v, causal=True, dropout_rate=0.0,
                                      seed=3),
                       attn.sdpa_bshd(q, k, v, causal=True))
    assert torch.equal(attn.sdpa_bshd(q, k, v, dropout_rate=0.3, seed=None),
                       attn.sdpa_bshd(q, k, v))


# ----------------------------------------------------------------------
# the routes into sdpa_bshd, through multi_head_attention

ROUTES = {
    # name: (S, heads, kv_heads, head_dim, keyword arguments)
    "bias": (64, 4, None, 16, {"bias": True}),
    "rope-below-flash": (64, 4, None, 16, {"rope": True}),
    "gqa-below-flash": (64, 4, 2, 16, {}),
    "head-dim-160": (32, 2, None, 160, {}),
    "use-flash-false": (64, 4, None, 16, {"use_flash": False}),
    "dropout-neither-kernel": (200, 3, None, 96, {"dropout": 0.1}),
}


def _mha_params(rng, w, h, hkv, d):
    """Weights of std 1/sqrt(fan-in), so that the outputs are O(1)."""
    return {"wqkv": (rng.standard_normal((w, (h + 2 * hkv) * d)) / w ** 0.5
                     ).astype(np.float32),
            "bqkv": (0.1 * rng.standard_normal((h + 2 * hkv) * d)
                     ).astype(np.float32),
            "wo": (rng.standard_normal((h * d, w)) / (h * d) ** 0.5
                   ).astype(np.float32),
            "bo": (0.1 * rng.standard_normal(w)).astype(np.float32)}


@pytest.mark.parametrize("name", list(ROUTES))
def test_each_route_into_sdpa_matches_jax(name, monkeypatch):
    s, h, kvh, d, kw = ROUTES[name]
    hkv = kvh or h
    rng = np.random.default_rng(len(name))
    b, w = 2, 48
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = _mha_params(rng, w, h, hkv, d)
    cot = rng.standard_normal((b, s, w)).astype(np.float32)
    rate = kw.get("dropout", 0.0)
    seed, offset = (7, 5) if rate else (None, 0)
    route = attn.attention_route(s, h, kvh, d, rope=kw.get("rope"),
                                 use_flash=kw.get("use_flash", True),
                                 dropout_rate=rate, seed=seed,
                                 bias="bias" in kw)
    assert route == "sdpa"
    bias = _doc_bias(rng, b, s) if "bias" in kw else None
    jrope = trope = None
    if kw.get("rope"):
        jrope = jax_rope.rope_cos_sin(s, d)
        trope = rope_cos_sin(s, d)
    if rate:
        keep = hidden_keep((b, h, s, s), rate, seed, offset, "cpu")
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(keep.numpy()))
    names = list(params)

    def jax_fn(x, *ps):
        return jax_attn.multi_head_attention(
            x, dict(zip(names, ps)), h, causal=True,
            bias=None if bias is None else jnp.asarray(bias),
            use_flash=kw.get("use_flash", True), rope=jrope, kv_heads=kvh,
            dropout_rate=rate,
            dropout_rng=jax.random.PRNGKey(1) if rate else None)

    def port_fn(x, *ps):
        return attn.multi_head_attention(
            x, dict(zip(names, ps)), h, causal=True,
            bias=None if bias is None else torch.from_numpy(bias),
            use_flash=kw.get("use_flash", True), rope=trope, kv_heads=kvh,
            dropout_rate=rate, seed=seed, offset=offset)
    args = (x, *params.values())
    want, wg = _grads_jax(jax_fn, args, cot)
    got, gg = _grads_port(port_fn, args, cot)
    np.testing.assert_allclose(got, want, **OUT)
    for n, g, wgt in zip(["x"] + names, gg, wg):
        np.testing.assert_allclose(g, wgt, **GRAD, err_msg=n)


def test_selective_recompute_of_the_sdpa_route_keeps_the_gradients():
    """`segment` set (selective recompute): the sdpa route runs under a
    checkpoint of its own; outputs and gradients equal the plain run."""
    from megatron_clip_tpu_torch.nn.transformer import _selective
    rng = np.random.default_rng(9)
    b, s, w, h = 2, 40, 32, 2
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = _mha_params(rng, w, h, h, 16)
    bias = torch.from_numpy(_doc_bias(rng, b, s))
    out = []
    for segment in (None, _selective):
        xt = torch.tensor(x, requires_grad=True)
        ps = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        y = attn.multi_head_attention(xt, ps, h, causal=True, bias=bias,
                                      segment=segment, dropout_rate=0.2,
                                      seed=3, offset=1)
        y.square().sum().backward()
        out.append([y.detach(), xt.grad] + [p.grad for p in ps.values()])
    for a, c in zip(*out):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
