"""The port's beam search (`memory_augmented_vlm_torch/models/beam_search.py`)
against the JAX package's `beam_search` on the tiny config of
tests/test_vlm.py, fp32, the same converted weights and numpy embeddings.

Tokens equal for K in {1, 2, 4}: plain, with length penalties 0.5 and 2,
with a repetition penalty (on the flat LM, whose greedy output repeats one
token), with an eos that is the prefill's top token (so the seed step puts
a hypothesis in the finished pool), with eos mid-search, and with stop
sequences taken from the search's own output. K = 1 equals greedy. Beam
sampling takes JAX's uniforms (`fold_in(rng, step)` draws).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import beam_search as jbeam
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import beam_search as tbeam
from memory_augmented_vlm_torch.models import vlm as tvlm
from test_vlm import TINY

PCFG = convert.config_from_fields(TINY)
MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    lively = dict(jp, language_model=jax.tree.map(lambda a: a * 5 if a.ndim >= 2 else a,
                                                  jp["language_model"]))
    return {name: (p, convert.from_jax_params(p, PCFG, device="cpu"))
            for name, p in (("flat", jp), ("lively", lively))}


def _emb(seed=0, s=23):
    return (0.5 * np.random.default_rng(seed).standard_normal((s, 32))).astype(np.float32)


def _both(models, name, emb, **kw):
    jp, tp = models[name]
    want = np.asarray(jbeam.beam_search(jp, TINY, jnp.asarray(emb), max_new_tokens=MAX_NEW,
                                        **kw))
    got = tbeam.beam_search(tp, PCFG, torch.from_numpy(emb), max_new_tokens=MAX_NEW, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def test_neg_inf_equals_jax():
    assert tbeam.NEG_INF == jbeam.NEG_INF == -np.inf


@pytest.mark.parametrize("num_beams", [1, 2, 4])
@pytest.mark.parametrize("length_penalty", [1.0, 0.5, 2.0])
def test_beam_search_matches_jax(models, num_beams, length_penalty):
    emb = _emb(1)
    free = _both(models, "lively", emb, num_beams=num_beams, eos_token_ids=(),
                 length_penalty=length_penalty)
    assert len(free) == MAX_NEW
    # eos mid-search: a token of the unconstrained best beam
    _both(models, "lively", emb, num_beams=num_beams, eos_token_ids=(int(free[4]),),
          length_penalty=length_penalty)


@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_with_eos_in_the_seed_step(models, num_beams):
    emb = _emb(2)
    first = int(np.asarray(jvlm.generate(models["lively"][0], TINY, jnp.asarray(emb),
                                         max_new_tokens=1).tokens)[0])
    out = _both(models, "lively", emb, num_beams=num_beams, eos_token_ids=(first, 7))
    if num_beams == 1:
        assert out.tolist() == [first]


@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_with_repetition_penalty(models, num_beams):
    emb = _emb(3)
    plain = _both(models, "flat", emb, num_beams=num_beams, eos_token_ids=())
    penalised = _both(models, "flat", emb, num_beams=num_beams, eos_token_ids=(),
                      repetition_penalty=2.0)
    assert plain.tolist() != penalised.tolist()


@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_with_stop_sequences(models, num_beams):
    emb = _emb(4)
    free = _both(models, "lively", emb, num_beams=num_beams, eos_token_ids=())
    stop = ((int(free[5]), int(free[6])), (49999, 2))
    _both(models, "lively", emb, num_beams=num_beams, eos_token_ids=(), stop_sequences=stop)


def test_one_beam_equals_greedy(models):
    jp, tp = models["lively"]
    emb = _emb(5)
    greedy = tvlm.generate(tp, PCFG, torch.from_numpy(emb), max_new_tokens=MAX_NEW,
                           eos_token_ids=())
    beam = _both(models, "lively", emb, num_beams=1, eos_token_ids=())
    assert beam.tolist() == greedy.tokens.tolist()


@pytest.mark.parametrize("num_beams", [2, 4])
@pytest.mark.parametrize("knobs", [dict(temperature=1.0), dict(temperature=0.8, top_k=30),
                                   dict(temperature=1.3, top_p=0.9)])
def test_beam_sampling_takes_jax_uniforms(models, num_beams, knobs):
    jp, tp = models["lively"]
    emb = _emb(6)
    rng = jax.random.key(9)
    vocab = TINY.lm.vocab_size
    uniforms = [np.asarray(jax.random.uniform(jax.random.fold_in(rng, step),
                                              (vocab if step == 0 else num_beams * vocab,),
                                              jnp.float32, minval=1e-20, maxval=1.0))
                for step in range(MAX_NEW)]
    want = np.asarray(jbeam.beam_search(jp, TINY, jnp.asarray(emb), num_beams=num_beams,
                                        max_new_tokens=MAX_NEW, eos_token_ids=(),
                                        do_sample=True, rng=rng, **knobs))
    got = tbeam.beam_search(tp, PCFG, torch.from_numpy(emb), num_beams=num_beams,
                            max_new_tokens=MAX_NEW, eos_token_ids=(), do_sample=True,
                            uniforms=[torch.from_numpy(u.copy()) for u in uniforms], **knobs)
    np.testing.assert_array_equal(got, want)
    search = tbeam.beam_search(tp, PCFG, torch.from_numpy(emb), num_beams=num_beams,
                               max_new_tokens=MAX_NEW, eos_token_ids=())
    assert got.tolist() != search.tolist()
