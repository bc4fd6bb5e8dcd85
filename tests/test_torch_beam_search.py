"""The port's beam search (`inference/beam_search.py`) against the JAX
package's on the CPU, fp32, the small GPT of `tests/torch_gen_util.py`
with learned positions and with partial rotary, grouped-query attention:
the beams' tokens equal and their length-penalised scores within 1e-5 (a
sum of fp32 log-probabilities over the steps, each within the decode's
2e-5 logits), with an EOS that the beams emit, so that frozen beams and
their lengths count; and a beam of one equal to greedy decoding."""
import jax.numpy as jnp
import numpy as np
import pytest

from megatron_clip_tpu.inference import beam_search as jbeam
from megatron_clip_tpu_torch.inference import beam_search as tbeam
from megatron_clip_tpu_torch.inference.generation import greedy_generate
from torch_gen_util import pair, ragged, t

N_NEW = 7


@pytest.mark.parametrize("variant,eos", [("learned", 0),
                                         ("rope_gqa_partial", None)])
def test_beam_search_matches_jax(variant, eos):
    jcfg, params, pcfg, model = pair(variant)
    prompt, _ = ragged(2, 6, pcfg.vocab_size)
    prompt[1] = np.random.default_rng(4).integers(1, pcfg.vocab_size, 6)
    if eos is None:  # a token the beams of row 0 emit at their second step
        toks, _ = tbeam.beam_search(model, t(prompt), beam_size=3,
                                    max_new_tokens=N_NEW, eos_id=0)
        eos = int(toks[0, 1, 6 + 1])
    kw = dict(beam_size=3, max_new_tokens=N_NEW, eos_id=eos,
              length_penalty=0.7)
    jt, js = jbeam.beam_search(params, jnp.asarray(prompt, jnp.int32), jcfg,
                               **kw)
    pt, ps = tbeam.beam_search(model, t(prompt), **kw)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_a_beam_of_one_is_greedy():
    _, _, pcfg, model = pair("rope")
    prompt, _ = ragged(2, 6, pcfg.vocab_size)
    prompt[1] = np.random.default_rng(4).integers(1, pcfg.vocab_size, 6)
    toks, _ = tbeam.beam_search(model, t(prompt), beam_size=1,
                                max_new_tokens=N_NEW, eos_id=-1)
    np.testing.assert_array_equal(
        toks[:, 0].numpy(),
        greedy_generate(model, t(prompt), max_new_tokens=N_NEW).numpy())


def test_pp_beam_search_names_its_item():
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        tbeam.pp_beam_search()
