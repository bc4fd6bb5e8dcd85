"""The port's dropout (ops/dropout.py, the attention's dropout routes, the
block's hidden dropout) on the CPU, against the JAX package where the two
can be compared.

The port draws its masks from its own Philox stream, which cannot equal
`jax.random` or the TPU's PRNG, so the JAX side's mask is fed to the port
where outputs are compared: hidden dropout must then be bit-exact in fp32
and bf16 (both divide x by 1 - rate in x's dtype where kept). The Philox
stream itself is held to Random123's known-answer vectors, its keep share
to 5 sigma of 1 - rate, and its layout to being a function of the global
indices alone (a mask drawn in row blocks equals the mask drawn whole).
The fused-MHA dropout gate is the JAX package's, compared over a grid; the
routes are shown with spies on the kernels' entry points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.nn import transformer as jax_transformer
from megatron_clip_tpu.ops.pallas import fused_mha as jax_fused
from megatron_clip_tpu_torch.ops import attention
from megatron_clip_tpu_torch.ops.dropout import (
    dropout, dropout_keep_with, fold_in, keep_threshold, philox4x32_10,
    philox_keep)
from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha

KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_matches_random123_known_answers(counter, key, want):
    got = philox4x32_10([torch.tensor(c) for c in counter], key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_five_sigma(rate):
    keep = philox_keep(0x1234567890ABCDEF, 3, range(4), range(1024),
                       range(1024), rate)
    n = keep.numel()
    assert n >= 4 * 2 ** 20
    share = float(keep.double().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma, (share, sigma)


def test_masks_differ_by_head_offset_and_seed_and_repeat():
    base = dict(seed=11, offset=2, bh=3, rows=range(96), cols=range(80),
                rate=0.1)
    mask = philox_keep(**base)
    assert torch.equal(mask, philox_keep(**base))
    for what, value in (("bh", 4), ("offset", 3), ("seed", 12),
                        ("seed", 11 + (1 << 32))):
        other = philox_keep(**dict(base, **{what: value}))
        # two independent masks at rate 0.1 agree on ~82% of the elements
        assert 0.75 < float((other == mask).float().mean()) < 0.9, what


@pytest.mark.parametrize("block", [64, 128])
def test_mask_drawn_in_row_blocks_equals_the_whole(block):
    s = 320
    whole = philox_keep(5, 7, range(2), range(s), range(s), 0.1)
    parts = torch.cat([philox_keep(5, 7, range(2), range(r, min(r + block, s)),
                                   range(s), 0.1)
                       for r in range(0, s, block)], dim=1)
    assert torch.equal(parts, whole)
    cols = torch.cat([philox_keep(5, 7, range(2), range(s),
                                  range(c, min(c + block, s)), 0.1)
                      for c in range(0, s, block)], dim=2)
    assert torch.equal(cols, whole)


def test_threshold_is_the_tpu_kernels():
    assert keep_threshold(0.1) == int(0.9 * 2 ** 32)
    assert keep_threshold(0.0) == 2 ** 32 - 1


def test_fold_in_gives_each_step_its_own_seed():
    seeds = {fold_in(1234, i) for i in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2 ** 64 for s in seeds)
    assert fold_in(1234, 5) == fold_in(1234, 5) != fold_in(1235, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_dropout_matches_jax_bit_for_bit(dtype):
    rate = 0.1
    x = np.random.default_rng(0).standard_normal((2, 33, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax_transformer.dropout(jx, rate, key)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, jx.shape))
    got = dropout_keep_with(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(keep), rate)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_hidden_dropout_replays_and_keeps_its_rate():
    x = torch.ones(4, 256, 128)
    a, b = dropout(x, 0.1, 99, 5), dropout(x, 0.1, 99, 5)
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.1, 99, 6))
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.9) < 5 * (0.09 / a.numel()) ** 0.5
    assert torch.equal(dropout(x, 0.1, None), x)
    assert torch.equal(dropout(x, 0.0, 99), x)


@pytest.mark.parametrize("s", [26, 128, 512, 1024])
def test_dropout_gate_is_the_jax_packages(s):
    for heads in (1, 2, 3, 4, 12, 16):
        for hd in (32, 64, 80, 96, 128):
            assert mha.dropout_kernel_eligible(s, heads, hd) == \
                jax_fused.dropout_kernel_eligible(s, heads, hd), (heads, hd)


def _spy(monkeypatch):
    """Replace the attention's kernel entry points in ops/attention.py by
    recorders returning zeros of the output's shape."""
    calls = []

    def record(name):
        def fn(qkv, heads, **kw):
            calls.append((name, kw))
            b, s, w = qkv.shape
            return torch.zeros(b, s, w // 3, dtype=qkv.dtype)
        return fn
    for name in ("fused_mha", "fused_mha_dropout", "flash_attention_qkv"):
        monkeypatch.setattr(attention, name, record(name))
    return calls


@pytest.mark.parametrize("s,route", [(512, "fused_mha_dropout"),
                                     (1024, "flash_attention_qkv"),
                                     (2048, "flash_attention_qkv"),
                                     (64, "fused_mha_dropout")])
def test_dropout_takes_the_jax_route(monkeypatch, s, route):
    calls = _spy(monkeypatch)
    heads, hd = 16, 128
    qkv = torch.zeros(1, s, 3 * heads * hd)
    fused = attention.attention_route(s, heads, None, hd, dropout_rate=0.1,
                                      seed=5)
    attention.attention_heads(qkv, heads, fused, causal=True,
                              dropout_rate=0.1, seed=5, offset=9)
    (name, kw), = calls
    assert name == route
    if route == "flash_attention_qkv":
        assert kw == dict(causal=True, dropout_rate=0.1, seed=5, offset=9)
    else:
        assert kw == dict(causal=True, rate=0.1, seed=5, offset=9)


@pytest.mark.parametrize("s,route", [(512, "fused_mha"),
                                     (2048, "flash_attention_qkv")])
def test_rate_zero_with_a_seed_takes_the_rate_zero_route(monkeypatch, s,
                                                         route):
    calls = _spy(monkeypatch)
    fused = attention.attention_route(s, 16, None, 128, dropout_rate=0.0,
                                      seed=5)
    attention.attention_heads(torch.zeros(1, s, 3 * 16 * 128), 16, fused,
                              causal=True, dropout_rate=0.0, seed=5)
    assert [name for name, _ in calls] == [route]


def test_dropout_below_the_flash_gate_outside_the_fused_one_raises():
    # head_dim 96 has no head group (128 % 96), and S = 200 is below flash:
    # sdpa_bshd, as in the JAX package (tests/test_torch_sdpa.py holds its
    # dropout against JAX's)
    assert attention.attention_route(200, 3, None, 96, dropout_rate=0.1,
                                     seed=1) == "sdpa"
    assert attention.attention_route(200, 3, None, 96) == "fused"  # rate 0


@pytest.mark.parametrize("causal", [False, True])
def test_rate_zero_kernels_bit_for_bit(causal):
    """A rate of 0 with a seed runs exactly the rate-0 functions (the JAX
    package's test_fused_mha_dropout_zero_rate_matches_plain)."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 50, 3 * 4 * 32, generator=g, requires_grad=True)
    do = torch.randn(2, 50, 4 * 32, generator=g)
    got = mha.fused_mha_dropout(qkv, 4, causal=causal, rate=0.0, seed=7)
    gg, = torch.autograd.grad(got, qkv, do)
    want = mha.fused_mha(qkv, 4, causal=causal)
    wg, = torch.autograd.grad(want, qkv, do)
    assert torch.equal(got, want) and torch.equal(gg, wg)
    q, k, v = (torch.randn(1, 2, 300, 32, generator=g, requires_grad=True)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=causal, dropout_rate=0.0, seed=7)
    want = fa.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, want)


def test_flash_dropout_needs_no_seed_for_eval():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 256, 32, generator=g) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v, dropout_rate=0.1),
                       fa.flash_attention(q, k, v))
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention(q, k, v, dropout_rate=1.0, seed=1)
