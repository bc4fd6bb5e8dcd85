"""The port's KV-cache decode (`inference/generation.py`) against the JAX
package's on the CPU, fp32, a small GPT (2 layers, width 64, 4 heads,
vocab 128) in four variants: learned positions, rotary positions, partial
rotary with grouped-query attention (2 k/v heads, swiglu, rmsnorm), and an
untied head; weights from JAX `init_gpt` moved by seeded noise, bridged
(`tests/torch_gen_util.py`).

Tolerances, with their reasons:
- `_forward_cached`'s logits (prefill, then decode steps at per-row
  positions) 2e-5: the same fp32 products and softmax summed in another
  order (the JAX suite's attention tolerance). Both caches are bf16, so K
  and V are rounded alike on both sides.
- `generate`: greedy tokens equal, and the log-probabilities within 1e-5
  outside each row's pad gap, whose entries are undefined on both sides.
- `_sample`'s filtered logits equal, bit for bit (the same fp32
  divisions, comparisons and cutoffs); the draw equal given JAX's Gumbel
  noise (`jax.random.categorical` is the argmax of logits plus
  `jax.random.gumbel` of its key, checked here): torch cannot reproduce
  JAX's key stream, so the port draws its noise from a `torch.Generator`
  (a deviation kept on purpose, ROADMAP).

Reference defect kept for parity: past a learned position table's end,
the JAX gather clamps its index and every later token reads the table's
last row; the port clamps the same way
(`test_generation_past_a_learned_table_reuses_its_last_row`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_clip_tpu.inference import generation as jgen
from megatron_clip_tpu_torch.inference import generation as tgen
from torch_gen_util import VARIANTS, pair, ragged, t, valid_logprobs

N_NEW = 6


@functools.lru_cache(maxsize=None)
def _jax_forward():
    return jax.jit(jgen._forward_cached,
                   static_argnames=("cfg", "compute_dtype"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_cached_matches_jax(variant):
    """The prefill of ragged prompts, then three decode steps each row at
    its own position, feeding both sides the same tokens."""
    jcfg, params, pcfg, model = pair(variant)
    prompt, lens = ragged(3, 8, pcfg.vocab_size)
    steps = np.random.default_rng(2).integers(1, pcfg.vocab_size, (3, 3))
    fwd = _jax_forward()
    jcache = jgen.KVCache.create(jcfg, 3, 8 + 3)
    pcache = tgen.KVCache.create(pcfg, 3, 8 + 3)
    pparams = tgen.decode_params(model, torch.float32)
    with torch.no_grad():
        calls = [(prompt, 0)] + [(steps[:, i:i + 1], lens + i)
                                 for i in range(3)]
        for toks, pos in calls:
            jl, jcache = fwd(params, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(pos, jnp.int32), jcache, jcfg,
                             jnp.float32)
            pl, pcache = tgen._forward_cached(
                pparams, t(toks), pos if isinstance(pos, int) else t(pos),
                pcache, pcfg, torch.float32)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                       rtol=2e-5, atol=2e-5)
    assert pcache.k.dtype == torch.bfloat16


def _jax_generate(params, prompt, lens, jcfg, **kw):
    return jgen.generate(params, jnp.asarray(prompt, jnp.int32),
                         jnp.asarray(lens, jnp.int32), jcfg, **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    """Ragged prompts, an EOS that one row emits, return_lengths and
    return_logprobs: tokens and lengths equal, log-probabilities within
    1e-5 outside the pad gap."""
    jcfg, params, pcfg, model = pair(variant)
    prompt, lens = ragged(3, 8, pcfg.vocab_size)
    first = tgen.generate(model, t(prompt), t(lens), max_new_tokens=N_NEW,
                          temperature=0.0)
    gen0 = first[0, lens[0]:lens[0] + N_NEW].tolist()
    # row 0 ends at the last of its tokens that is new where it falls
    at = max(j for j in range(N_NEW) if gen0[j] not in gen0[:j])
    eos = gen0[at]
    kw = dict(max_new_tokens=N_NEW, temperature=0.0, eos_id=eos,
              return_lengths=True, return_logprobs=True)
    jo, jn, jl = _jax_generate(params, prompt, lens, jcfg, **kw)
    po, pn, pl = tgen.generate(model, t(prompt), t(lens), **kw)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert pn[0] == at + 1 and (po[0, lens[0] + at + 1:] == 0).all()
    for got, want in zip(valid_logprobs(pl, lens, N_NEW),
                         valid_logprobs(jl, lens, N_NEW)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_generation_past_a_learned_table_reuses_its_last_row():
    """A learned-position model of 12 positions asked for 10 tokens past
    prompts of up to 8: positions 12 to 17 read row 11 on both sides (JAX
    clamps the gather; a reference defect kept for parity)."""
    jcfg, params, pcfg, model = pair("learned", seq_length=12)
    prompt, lens = ragged(2, 8, pcfg.vocab_size)
    assert lens.max() + 10 > model.pos_embed.shape[0]
    kw = dict(max_new_tokens=10, temperature=0.0, return_logprobs=True)
    jo, jl = _jax_generate(params, prompt, lens, jcfg, **kw)
    po, pl = tgen.generate(model, t(prompt), t(lens), **kw)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    for got, want in zip(valid_logprobs(pl, lens, 10),
                         valid_logprobs(jl, lens, 10)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_filtered(monkeypatch, logits, temperature, top_k, top_p):
    """The logits JAX's `_sample` hands `jax.random.categorical`."""
    got = {}

    def categorical(key, lg, axis=-1):
        got["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", categorical)
        jgen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                     temperature, top_k, top_p)
    return got["logits"]


def _logits_with_ties(rng) -> np.ndarray:
    """[4, 128] logits whose 5th-largest value of each row is held by
    three entries."""
    lg = rng.standard_normal((4, 128)).astype(np.float32) * 3
    for row in lg:
        order = np.argsort(-row)
        row[order[5:7]] = row[order[4]]
    return lg


@pytest.mark.parametrize("case", ["temperature", "top_k_ties", "top_p",
                                  "top_p_decayed"])
def test_sample_filters_equal_jax(monkeypatch, case):
    rng = np.random.default_rng(3)
    logits = _logits_with_ties(rng)
    temperature, top_k, top_p = {
        "temperature": (0.7, 0, None),
        "top_k_ties": (1.0, 5, None),
        "top_p": (0.9, 0, 0.9),
        # step 4 of --top-p 0.9 --top-p-decay 0.8 --top-p-bound 0.3
        "top_p_decayed": (1.0, 7, tgen.decayed_top_p(0.9, 0.8, 0.3, 4))}[
            case]
    want = _jax_filtered(monkeypatch, logits, temperature, top_k, top_p)
    got = tgen._filter_logits(torch.from_numpy(logits), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "top_k_ties":
        assert ((got > -1e30).sum(-1) == 7).all()  # the tied 5th kept


def test_decayed_top_p_equals_the_jax_scan():
    """max(bound, p * decay ** i) in fp32, as the JAX scan computes it,
    within an fp32 ulp: XLA's power and the port's (fp64, rounded) may
    round apart; the filter given one threshold is exact (above)."""
    for p, decay, bound in ((0.9, 0.8, 0.3), (0.95, 0.99, 0.0),
                            (0.9, 0.95, 0.1)):
        want = np.asarray(jnp.maximum(bound, p * jnp.power(
            decay, jnp.arange(200).astype(jnp.float32))))
        got = np.array([tgen.decayed_top_p(p, decay, bound, i)
                        for i in range(200)], np.float32)
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)


def _jax_noise(seed: int, steps: int, shape) -> torch.Tensor:
    """Each decode step's Gumbel draws of JAX's generate: the step key
    split off the running one, as its scan splits it."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, shape)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("variant,sampling", [
    ("learned", dict(temperature=0.8, top_k=20)),
    ("rope_gqa_partial", dict(temperature=1.0, top_p=0.9, top_p_decay=0.8,
                              top_p_bound=0.3)),
])
def test_sampled_generate_equals_jax_given_its_noise(variant, sampling):
    jcfg, params, pcfg, model = pair(variant)
    prompt, lens = ragged(3, 8, pcfg.vocab_size)
    # jax.random.categorical is the argmax of logits plus gumbel(key)
    lg = jax.random.normal(jax.random.PRNGKey(5), (3, pcfg.vocab_size))
    key = jax.random.PRNGKey(6)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, lg, axis=-1)),
        np.asarray(jnp.argmax(lg + jax.random.gumbel(key, lg.shape), -1)))
    kw = dict(max_new_tokens=N_NEW, seed=11, **sampling)
    want = _jax_generate(params, prompt, lens, jcfg, **kw)
    got = tgen.generate(model, t(prompt), t(lens), noise=_jax_noise(
        11, N_NEW, (3, pcfg.vocab_size)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_port_stream_is_seeded():
    """Without noise, the draw follows the request's seed: the same seed
    gives the same tokens, another seed others, all in the vocabulary."""
    _, _, pcfg, model = pair("learned")
    prompt, lens = ragged(3, 8, pcfg.vocab_size)
    kw = dict(max_new_tokens=N_NEW, temperature=1.0)
    a, b, c = (tgen.generate(model, t(prompt), t(lens), seed=s, **kw)
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < pcfg.vocab_size)).all()
