"""The port's logits processing (`memory_augmented_vlm_torch/models/sampling.py`)
against the JAX package's on seeded fp32 logits, with ties planted at the
top-k and top-p thresholds: every function equal element for element
(the same fp32 operations on the same values), and the stop-sequence
packing and matching equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import sampling as jsampling
from memory_augmented_vlm_torch.models import sampling as tsampling


def _logits(seed, b=4, v=64, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal((b, v))).astype(np.float32)


def _tied_at(logits, k):
    """Every row's k-th largest value copied onto its k+1-th and k+2-th
    largest, and row 0's top value onto its second."""
    out = logits.copy()
    for row in out:
        order = np.argsort(-row, kind="stable")
        row[order[k:k + 2]] = row[order[k - 1]]
    out[0, np.argsort(-out[0])[1]] = out[0].max()
    return out


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw))
    got = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw).numpy()
    return got, want


def test_neg_inf_equals_jax():
    assert tsampling.NEG_INF == jsampling.NEG_INF


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.7])
def test_repetition_penalty_matches_jax(penalty):
    logits = _logits(0)
    presence = np.random.default_rng(1).random(logits.shape) < 0.3
    got, want = _both(jsampling.apply_repetition_penalty, tsampling.apply_repetition_penalty,
                      logits, presence, penalty=penalty)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 5, 17, 64])
@pytest.mark.parametrize("tied", [False, True])
def test_top_k_matches_jax(k, tied):
    logits = _logits(2)
    if tied and 0 < k < 62:
        logits = _tied_at(logits, k)
    got, want = _both(jsampling.apply_top_k, tsampling.apply_top_k, logits, k=k)
    np.testing.assert_array_equal(got, want)
    if tied and 0 < k < 62:  # the ties at the k-th value survive
        assert ((got > tsampling.NEG_INF).sum(-1) >= k + 2).all()


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.95, 1.0])
def test_top_p_matches_jax(top_p):
    got, want = _both(jsampling.apply_top_p, tsampling.apply_top_p, _logits(3), top_p=top_p)
    np.testing.assert_array_equal(got, want)


def test_top_p_keeps_ties_at_its_threshold():
    """Rows of a few distinct values, each repeated: the cut falls inside a
    run of equal logits, and the whole run survives in both packages."""
    rng = np.random.default_rng(4)
    levels = np.array([-2.0, -1.0, 0.0, 0.5, 1.0], np.float32)
    logits = levels[rng.integers(0, 5, size=(6, 40))]
    for top_p in (0.2, 0.5, 0.9):
        got, want = _both(jsampling.apply_top_p, tsampling.apply_top_p, logits, top_p=top_p)
        np.testing.assert_array_equal(got, want)
        kept = got > tsampling.NEG_INF
        for row, keep in zip(logits, kept):  # a value is kept whole or dropped whole
            for value in np.unique(row):
                assert len(set(keep[row == value])) == 1


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(temperature=0.7),
    dict(temperature=0.7, top_k=9),
    dict(temperature=1.3, top_p=0.85),
    dict(temperature=0.6, top_k=12, top_p=0.9, repetition_penalty=1.2),
])
def test_process_logits_matches_jax(knobs):
    logits = _tied_at(_logits(5), 9)
    presence = np.random.default_rng(6).random(logits.shape) < 0.2
    got, want = _both(jsampling.process_logits, tsampling.process_logits, logits, presence,
                      **knobs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("knobs", [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=9, top_p=1.0),
    dict(temperature=1.3, top_k=0, top_p=0.85),
    dict(temperature=0.6, top_k=12, top_p=0.9),
    dict(temperature=0.8, top_k=64, top_p=0.5),
    dict(temperature=0.8, top_k=1, top_p=0.95),
])
def test_warp_with_tensor_settings_matches_jax(knobs):
    """`warp`, the captured decode's processors with the settings as 0-d
    tensors (one sort for top-k and top-p), equals JAX's process_logits
    with Python settings, ties planted at the top-k threshold."""
    logits = _tied_at(_logits(7), 9)
    want = np.asarray(jsampling.process_logits(jnp.asarray(logits), None, **knobs))
    got = tsampling.warp(torch.from_numpy(logits), torch.tensor(knobs["temperature"]),
                         torch.tensor(knobs["top_k"]), torch.tensor(1.0 - knobs["top_p"]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sequences", [(), ((7,),), ((1, 2, 3), (4,), (5, 6))])
def test_pack_stop_sequences_matches_jax(sequences):
    for got, want in zip(tsampling.pack_stop_sequences(sequences),
                         jsampling.pack_stop_sequences(sequences)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sequences", [(), ((3,),), ((1, 2, 3), (4,), (2, 3))])
def test_stop_sequence_hit_matches_jax(sequences):
    """Random tails over a small alphabet (so matches happen) with -1 fill,
    and generated counts around each sequence's length."""
    rng = np.random.default_rng(7)
    seqs, lens = jsampling.pack_stop_sequences(sequences)
    recent = rng.integers(0, 6, size=(64, seqs.shape[1])).astype(np.int32)
    recent[:8, :1] = -1
    n_generated = rng.integers(0, 5, size=(64,)).astype(np.int32)
    got, want = _both(jsampling.stop_sequence_hit, tsampling.stop_sequence_hit, recent, seqs,
                      lens, n_generated)
    np.testing.assert_array_equal(got, want)
    if sequences:
        assert want.any() and not want.all()
