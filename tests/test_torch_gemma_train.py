"""The port's training of untied and Gemma LMs against the JAX package on the
CPU, fp32.

  - The loss of an untied LM contracts with `lm_head`, as JAX's
    `qwen2.unembed` does: test_vlm's tiny config with
    `tie_word_embeddings=False`, the dense and the chunked loss, and every
    gradient leaf of `multimodal_loss`, `lm_head` included.
  - A tiny llava_gemma VLM (test_vlm's tiny VLM with a Gemma LM of 2 heads
    of 256 over one KV head, GELU, `1 + w` norms, scaled embeddings) through
    `make_train_step`: loss and every gradient leaf at each of two steps,
    and the parameters after them.
  - A tiny untied Llama text step (`make_text_train_step`), `lm_head`'s
    gradient included.

(The training kernels' plain versions at head dim 256, and chip_smoke's
controls of them, are held in tests/test_torch_flash_bwd.py.)

Weights come from the JAX inits (one `jax.jit` each), converted with
`convert`; batches from numpy. Tolerances are tests/test_torch_train.py's:
losses to LOSS_TOL, gradients to GRAD_TOL, parameters after AdamW steps to
PARAM_ATOL. JAX on the CPU runs XLA attention and the dense loss; the
port's CPU tensors take the plain versions of its kernels.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.config import LMConfig
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.ops import flash_bwd
from memory_augmented_vlm_torch.train import trainer as ttrainer
from tests.test_torch_train import (GRAD_TOL, LOSS_TOL, OPT, PARAM_ATOL, ST, _assert_tree_close,
                                    _batch, _port_opt)
from tests.test_vlm import TINY

UNTIED = dataclasses.replace(TINY, lm=dataclasses.replace(TINY.lm, tie_word_embeddings=False))
# 2 heads of 256 over one KV head at test_vlm's widths; the vocabulary
# (50000) holds the memory's prompt ids (up to 48876)
GEMMA_VLM = dataclasses.replace(TINY, lm=dataclasses.replace(
    TINY.lm, num_attention_heads=2, num_key_value_heads=1, head_dim=256,
    mlp_act="gelu_pytorch_tanh", norm_plus_one=True, scale_embeddings=True))
LLAMA = dataclasses.replace(TINY, lm=LMConfig(
    vocab_size=TINY.lm.vocab_size, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=500000.0,
    tie_word_embeddings=False, attention_bias=False, dtype="float32"))


def _noisy_norms(lm, rng):
    """Every LM norm weight 0.1 N(0, 1) away from JAX's init, so that
    Gemma's `1 + w` and a plain `w` both see weights off their constant."""
    out = dict(lm, norm=lm["norm"] + 0.1 * rng.standard_normal(lm["norm"].shape)
               .astype(np.float32))
    layers = dict(lm["layers"])
    for name in ("input_layernorm", "post_attention_layernorm"):
        layers[name] = layers[name] + 0.1 * rng.standard_normal(layers[name].shape).astype(
            np.float32)
    out["layers"] = layers
    return out


def _weights(cfg, seed):
    """(JAX params, port params, port config) of `cfg`, from JAX's init
    under one `jax.jit`, norms drawn away from their constant."""
    jp = jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=0)(
        cfg, jax.random.key(seed)))
    jp = dict(jp, language_model=_noisy_norms(jp["language_model"],
                                              np.random.default_rng(seed + 1)))
    pcfg = convert.config_from_fields(cfg)
    return jp, convert.from_jax_params(jp, pcfg, device="cpu"), pcfg


@pytest.fixture(scope="module")
def untied():
    return _weights(UNTIED, 40)


# ------------------------------------------------------- the untied head

@pytest.mark.parametrize("kind", ["dense", "chunked"])
def test_untied_head_loss_matches_jax(untied, kind):
    """The loss of an untied LM takes `lm_head`, as JAX's takes it through
    `qwen2.unembed`: against `embed_tokens` it lands elsewhere."""
    jp, tp, pcfg = untied
    assert "lm_head" in tp["language_model"]
    rng = np.random.default_rng(41)
    hidden = rng.standard_normal((2, 37, UNTIED.lm.hidden_size)).astype(np.float32)
    labels = rng.integers(0, UNTIED.lm.vocab_size, size=(2, 37)).astype(np.int32)
    labels[:, :5] = constants.IGNORE_INDEX
    valid = np.array([37, 20], np.int32)
    chunk = {"chunk": 8} if kind == "chunked" else {}
    want = getattr(jtrainer, f"{kind}_cross_entropy")(
        jp, UNTIED, jnp.asarray(hidden), jnp.asarray(labels), jnp.asarray(valid), **chunk)
    got = getattr(ttrainer, f"{kind}_cross_entropy")(
        tp, pcfg, torch.from_numpy(hidden), torch.from_numpy(labels), torch.from_numpy(valid),
        **chunk)
    assert int(got[1]) == int(want[1])
    np.testing.assert_allclose(float(got[0]), float(want[0]), **LOSS_TOL)
    tied = dict(tp, language_model={k: v for k, v in tp["language_model"].items()
                                    if k != "lm_head"})
    other = getattr(ttrainer, f"{kind}_cross_entropy")(
        tied, pcfg, torch.from_numpy(hidden), torch.from_numpy(labels),
        torch.from_numpy(valid), **chunk)
    assert abs(float(other[0]) - float(want[0])) > 1e-3


def test_untied_head_multimodal_grads_match_jax(untied):
    """Every gradient leaf of `multimodal_loss` on the untied LM, `lm_head`
    included (nonzero), against JAX's, and `embed_tokens` gets only the
    text rows' gradient, as in JAX."""
    jp, tp, pcfg = untied
    jb, tb, nseg = _batch(42, 16)
    (jloss, _), jgrads = jax.jit(lambda p: jtrainer.value_and_grad_params(
        lambda q: jtrainer.multimodal_loss(q, UNTIED, jb, nseg=nseg), p))(jp)
    (tloss, _), tgrads = ttrainer.value_and_grad_params(
        lambda q: ttrainer.multimodal_loss(q, pcfg, tb, nseg=nseg), tp)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree_close(tgrads, jgrads, **GRAD_TOL)
    assert float(tgrads["language_model"]["lm_head"].abs().max()) > 0


# ------------------------------------------------------ Gemma and Llama steps

def test_gemma_vlm_train_steps_match_jax():
    """Two `make_train_step` steps of the tiny llava_gemma VLM (two
    segments, so the memory's evolve is differentiated; the LM's attention
    at head dim 256): before each step, the loss and every gradient leaf of
    `multimodal_loss` against JAX's; after each, the loss, grad_norm and
    parameters."""
    jp, tp, pcfg = _weights(GEMMA_VLM, 43)
    cfg = dataclasses.replace(OPT, warmup_ratio=0.0)
    batches = [_batch(44 + i, 16) for i in range(2)]
    nseg = batches[0][2]
    assert nseg == 2
    jstep_fn = jtrainer.make_train_step(GEMMA_VLM, cfg, nseg=nseg)

    @jax.jit
    def jgrad_and_step(state, b):  # one compile for both
        grads = jtrainer.value_and_grad_params(
            lambda q: jtrainer.multimodal_loss(q, GEMMA_VLM, b, nseg=nseg), state.params)
        return grads, jstep_fn(state, b)

    tstep = ttrainer.make_train_step(pcfg, _port_opt(cfg), nseg=nseg)
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), cfg)
    tstate = ttrainer.init_train_state(tp, _port_opt(cfg))
    for jb, tb, _ in batches:
        ((jloss, jm), jgrads), (jnext, jsm) = jgrad_and_step(jstate, jb)
        (tloss, tm), tgrads = ttrainer.value_and_grad_params(
            lambda q: ttrainer.multimodal_loss(q, pcfg, tb, nseg=nseg), tstate.params)
        assert int(tm["target_tokens"]) == int(jm["target_tokens"]) == (ST - 3) + (ST - 6)
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
        _assert_tree_close(tgrads, jgrads, **GRAD_TOL)
        layer = tgrads["language_model"]["layers"][0]
        assert float(layer["q_proj"]["kernel"].abs().max()) > 0
        jstate = jnext
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jsm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jsm["grad_norm"]), rtol=1e-5)
        _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
    assert pcfg.lm.head_dim == flash_bwd.D256


def test_untied_llama_text_step_matches_jax():
    """`make_text_train_step` on a tiny untied Llama LM: the loss and every
    gradient leaf (`lm_head`'s among them) against JAX's, then the step's
    loss, grad_norm and parameters."""
    jp, tp, pcfg = _weights(LLAMA, 45)
    rng = np.random.default_rng(46)
    ids = rng.integers(5, 1000, size=(2, 24)).astype(np.int32)
    labels = ids.copy()
    labels[:, :4] = constants.IGNORE_INDEX
    text_len = np.array([24, 17], np.int32)
    jb = jtrainer.TextBatch(jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(text_len))
    tb = ttrainer.TextBatch(*(torch.from_numpy(x) for x in (ids, labels, text_len)))
    cfg = dataclasses.replace(OPT, warmup_ratio=0.0)
    jstep_fn = jtrainer.make_text_train_step(LLAMA, cfg)

    @jax.jit
    def jgrad_and_step(state):  # one compile for both
        grads = jtrainer.value_and_grad_params(lambda q: jtrainer.text_loss(q, LLAMA, jb),
                                               state.params)
        return grads, jstep_fn(state, jb)

    ((jloss, _), jgrads), (jstate, jm) = jgrad_and_step(
        jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), cfg))
    (tloss, _), tgrads = ttrainer.value_and_grad_params(
        lambda q: ttrainer.text_loss(q, pcfg, tb), tp)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree_close(tgrads, jgrads, **GRAD_TOL)
    assert float(tgrads["language_model"]["lm_head"].abs().max()) > 0
    tstate, tm = ttrainer.make_text_train_step(pcfg, _port_opt(cfg))(
        ttrainer.init_train_state(tp, _port_opt(cfg)), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
    assert not torch.equal(tstate.params["language_model"]["lm_head"],
                           tp["language_model"]["lm_head"])
