"""The port's trainer and optimizer (`memory_augmented_vlm_torch/train`)
against the JAX package's on the tiny config of tests/test_vlm.py, fp32.

Same converted weights and numpy batches on both sides: B=2 with different
`image_pos` and text lengths. JAX runs on the CPU as its trainer does there
(dense loss, XLA attention); the port's CPU tensors take the plain versions
of its kernels. Losses and gradients agree to fp32 summation order
(GRAD_TOL, on every leaf). Params after AdamW steps are held to
PARAM_ATOL, far above the 3.6e-6 these batches give: a first Adam step
moves a leaf by about lr * sign(grad) whatever the gradient's size (lr
here 1e-3), so a gradient within rounding of zero could step the other
way, by 2e-3; these batches hit no such leaf. Frozen leaves must stay
bit-identical.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from memory_augmented_vlm_tpu import constants as jconstants
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.train import optimizer as jopt
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_tpu.utils.tree import path_str as jpath_str
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.train import optimizer as topt
from memory_augmented_vlm_torch.train import trainer as ttrainer
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str, tree_map
from test_vlm import TINY

PCFG = convert.config_from_fields(TINY)
ST = 12
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-4
OPT = jopt.OptimizerConfig(learning_rate=1e-3, memory_transformer_lr=2e-3,
                           memory_key_value_lr=3e-3, mm_vision_tower_lr=None,
                           total_steps=20, warmup_ratio=0.1, weight_decay=0.01,
                           max_grad_norm=1.0)


def _port_opt(cfg):
    return topt.OptimizerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    return jp, convert.from_jax_params(jp, PCFG, device="cpu")


def _batch(seed, num_frames):
    rng = np.random.default_rng(seed)
    fmax = jvlm.pad_frames_to_segment_multiple(num_frames, TINY.memory.segment_frames)
    pixels = np.zeros((2, fmax, 56, 56, 3), np.float32)
    pixels[:, :num_frames] = rng.standard_normal((2, num_frames, 56, 56, 3))
    ids = rng.integers(5, 1000, size=(2, ST)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = jconstants.IGNORE_INDEX
    fine = jvlm.fine_frame_indices(num_frames, TINY.memory.num_fine_frames)
    arrays = dict(
        pixels=pixels,
        frame_indices=np.broadcast_to(np.arange(fmax, dtype=np.int32), (2, fmax)).copy(),
        frame_valid=np.broadcast_to(np.arange(fmax) < num_frames, (2, fmax)).copy(),
        fine_idx=np.broadcast_to(fine.astype(np.int32), (2, len(fine))).copy(),
        input_ids=ids, labels=labels,
        image_pos=np.array([2, 7], np.int32),
        text_len=np.array([ST, ST - 3], np.int32))
    jb = jtrainer.TrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = ttrainer.TrainBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jb, tb, min(fmax // TINY.memory.segment_frames, TINY.memory.cache_cap)


def _assert_tree_close(port_tree, jax_tree, **tol):
    got = convert.to_jax_layout(port_tree)
    for path, want in jax.tree_util.tree_leaves_with_path(jax_tree):
        have = got
        for p in path:
            have = have[p.key] if hasattr(p, "key") else have[p.idx]
        np.testing.assert_allclose(np.asarray(have, np.float64), np.asarray(want, np.float64),
                                   err_msg=jpath_str(path), **tol)


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("rule", ["trainable_mask", "lr_group_labels", "decay_mask"])
def test_optimizer_labels_match_jax_leaf_for_leaf(weights, rule):
    jp, tp = weights
    cfg = dataclasses.replace(OPT, mm_projector_lr=4e-3, mm_vision_tower_lr=5e-3)
    parts = "larimar_model,recurrent_model,mm_language_model,mm_mlp_adapter"
    want = {"trainable_mask": lambda p: jopt.trainable_mask(p, parts),
            "lr_group_labels": lambda p: jopt.lr_group_labels(p, cfg),
            "decay_mask": jopt.decay_mask}[rule](jp)
    got = {"trainable_mask": lambda p: topt.trainable_mask(p, parts),
           "lr_group_labels": lambda p: topt.lr_group_labels(p, _port_opt(cfg)),
           "decay_mask": topt.decay_mask}[rule](tp)
    got = convert.to_jax_layout(got)
    seen = set()
    for path, label in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for p in path:
            have = have[p.key] if hasattr(p, "key") else have[p.idx]
        assert np.all(np.asarray(have) == label), (jpath_str(path), have, label)
        seen.add(str(label))
    assert len(seen) > 1  # the rule tells leaves apart


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_matches_optax(schedule):
    cfg = dataclasses.replace(OPT, schedule=schedule, total_steps=40, warmup_ratio=0.1)
    want = jopt.make_schedule(cfg, 3e-4)
    got = topt.make_schedule(_port_opt(cfg), 3e-4)
    counts = range(0, 46)
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-10)  # JAX evaluates in fp32
    bench = dataclasses.replace(OPT, total_steps=100, warmup_ratio=0.03)
    assert topt.make_schedule(_port_opt(bench), 1e-5)(0) == 0.0  # step 0 does not move


def test_optimizer_updates_match_optax_with_clip_and_frozen_leaves(weights):
    """Two updates on given grads: the global norm is far above max_grad_norm
    (the clip acts), weight decay follows `decay_mask`, the frozen tower,
    projector and PE get zero updates though their grads are not zero."""
    jp, tp = weights
    rng = np.random.default_rng(11)
    jgrads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
              for _ in range(2)]
    jtx = jopt.build_optimizer(jp, OPT)
    ttx = topt.build_optimizer(tp, _port_opt(OPT))
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    jparams, tparams = jp, tp
    for g in jgrads:
        tg = convert.from_jax_params(g, PCFG, device="cpu")
        assert float(topt.global_norm(tg)) > 100 * OPT.max_grad_norm
        jup, jstate = jax.jit(jtx.update)(jax.tree.map(jnp.asarray, g), jstate, jparams)
        tup, tstate = ttx.update(tg, tstate, tparams)
        _assert_tree_close(tup, jup, rtol=1e-5, atol=1e-9)
        jparams = optax.apply_updates(jparams, jup)
        tparams = tree_map(lambda p, u: p + u, tparams, tup)
    frozen = topt.trainable_mask(tp, OPT.mm_tunable_parts)
    for (path, p0), (_, p1), (_, train) in zip(leaves_with_path(tp), leaves_with_path(tparams),
                                               leaves_with_path(frozen)):
        assert train or torch.equal(p0, p1), path_str(path)
    assert tstate.count == {"default": 2, "memory_transformer": 2, "memory_kv": 2}


def test_bf16_first_update_matches_optax_bit_for_bit(weights):
    """bf16 params and grads: the first AdamW update (the clip acting) is
    optax's to the bit, because every constant is rounded to bf16 as JAX
    rounds it (b2 = 0.999 becomes 1.0). Later updates differ where optax's
    bf16 global norm (summed leaf by leaf in bf16) differs from the port's
    fp32 one."""
    jp, _ = weights
    rng = np.random.default_rng(12)
    g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), jp)
    bf = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), t)  # noqa: E731
    jparams, jg = bf(jp), bf(g)
    tparams = convert.from_jax_params(jp, PCFG, device="cpu", dtype=torch.bfloat16)
    tg = convert.from_jax_params(g, PCFG, device="cpu", dtype=torch.bfloat16)
    jtx = jopt.build_optimizer(jparams, OPT)
    ttx = topt.build_optimizer(tparams, _port_opt(OPT))
    jup, _ = jax.jit(jtx.update)(jg, jtx.init(jparams), jparams)
    tup, _ = ttx.update(tg, ttx.init(tparams), tparams)
    assert float(topt.global_norm(tg)) > OPT.max_grad_norm
    _assert_tree_close(tup, jup, rtol=0, atol=0)


def test_grad_accumulation_is_not_ported(weights):
    with pytest.raises(NotImplementedError):
        topt.build_optimizer(weights[1], topt.OptimizerConfig(grad_accum_steps=2))


# ------------------------------------------------------------ loss pieces

@pytest.mark.parametrize("kind", ["dense", "chunked"])
def test_cross_entropy_matches_jax(weights, kind):
    jp, tp = weights
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 37, TINY.lm.hidden_size)).astype(np.float32)
    labels = rng.integers(0, TINY.lm.vocab_size, size=(2, 37)).astype(np.int32)
    labels[:, :5] = constants.IGNORE_INDEX
    valid = np.array([37, 20], np.int32)
    if kind == "dense":
        want = jtrainer.dense_cross_entropy(jp, TINY, jnp.asarray(hidden), jnp.asarray(labels),
                                            jnp.asarray(valid))
        got = ttrainer.dense_cross_entropy(tp, PCFG, torch.from_numpy(hidden),
                                           torch.from_numpy(labels), torch.from_numpy(valid))
    else:
        want = jtrainer.chunked_cross_entropy(jp, TINY, jnp.asarray(hidden),
                                              jnp.asarray(labels), jnp.asarray(valid), chunk=8)
        got = ttrainer.chunked_cross_entropy(tp, PCFG, torch.from_numpy(hidden),
                                             torch.from_numpy(labels), torch.from_numpy(valid),
                                             chunk=8)
    assert int(got[1]) == int(want[1]) == (36 - 4) + (19 - 4)
    np.testing.assert_allclose(float(got[0]), float(want[0]), **LOSS_TOL)


def test_splice_batched_matches_jax():
    rng = np.random.default_rng(4)
    text = rng.standard_normal((2, 6, 5)).astype(np.float32)
    visual = rng.standard_normal((2, 4, 5)).astype(np.float32)
    pos = np.array([0, 6], np.int32)
    labels = rng.integers(0, 9, size=(2, 6)).astype(np.int32)
    want = jtrainer._splice_batched(jnp.asarray(text), jnp.asarray(visual), jnp.asarray(pos),
                                    jnp.asarray(labels), -100)
    got = ttrainer._splice_batched(torch.from_numpy(text), torch.from_numpy(visual),
                                   torch.from_numpy(pos), torch.from_numpy(labels), -100)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------------- the train step

# one segment; two (evolve is differentiated); 12 for a cache of 10 (it rolls)
@pytest.mark.parametrize("num_frames", [8, 16, 96])
def test_multimodal_loss_and_every_grad_match_jax(weights, num_frames):
    jp, tp = weights
    jb, tb, nseg = _batch(num_frames, num_frames)

    (jloss, jm), jgrads = jax.jit(lambda p: jtrainer.value_and_grad_params(
        lambda q: jtrainer.multimodal_loss(q, TINY, jb, nseg=nseg), p))(jp)
    (tloss, tm), tgrads = ttrainer.value_and_grad_params(
        lambda q: ttrainer.multimodal_loss(q, PCFG, tb, nseg=nseg), tp)
    assert int(tm["target_tokens"]) == int(jm["target_tokens"]) == (ST - 3) + (ST - 3 - 3)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree_close(tgrads, jgrads, **GRAD_TOL)
    # frozen PE gets a real gradient; the detached tower and projector none
    assert float(tgrads["positional_encoding"]["frame_embed"].abs().max()) > 0
    assert float(tgrads["vision_tower"]["layers"][0]["fc1"]["kernel"].abs().max()) == 0
    if nseg == 2:  # evolve is differentiated
        upd = tgrads["memory"]["recurrent_memory_transformer"]["memory_update_attention"]
        assert float(upd["q_proj"]["kernel"].abs().max()) > 0


def test_three_train_steps_match_jax(weights):
    jp, tp = weights
    cfg = dataclasses.replace(OPT, warmup_ratio=0.0)
    batches = [_batch(20 + i, 16) for i in range(3)]
    nseg = batches[0][2]
    jstep = jax.jit(jtrainer.make_train_step(TINY, cfg, nseg=nseg))
    tstep = ttrainer.make_train_step(PCFG, _port_opt(cfg), nseg=nseg)
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), cfg)
    tstate = ttrainer.init_train_state(tp, _port_opt(cfg))
    for jb, tb, _ in batches:
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
    assert tstate.step == int(jstate.step) == 3
    mask = topt.trainable_mask(tp, cfg.mm_tunable_parts)
    for (path, p0), (_, p3), (_, train) in zip(leaves_with_path(tp),
                                               leaves_with_path(tstate.params),
                                               leaves_with_path(mask)):
        if train:
            assert not torch.equal(p0, p3), path_str(path)
        else:
            assert torch.equal(p0, p3), path_str(path)


def test_text_train_step_matches_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(9)
    ids = rng.integers(5, 1000, size=(2, 24)).astype(np.int32)
    labels = ids.copy()
    labels[:, :4] = constants.IGNORE_INDEX
    text_len = np.array([24, 17], np.int32)
    jb = jtrainer.TextBatch(jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(text_len))
    tb = ttrainer.TextBatch(*(torch.from_numpy(x) for x in (ids, labels, text_len)))
    cfg = dataclasses.replace(OPT, warmup_ratio=0.0)
    jstate, jm = jax.jit(jtrainer.make_text_train_step(TINY, cfg))(
        jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), cfg), jb)
    tstate, tm = ttrainer.make_text_train_step(PCFG, _port_opt(cfg))(
        ttrainer.init_train_state(tp, _port_opt(cfg)), tb)
    assert int(tm["target_tokens"]) == int(jm["target_tokens"]) == 20 + 13
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)


def test_position_skipping_is_not_ported(weights):
    _, tb, nseg = _batch(0, 8)
    with pytest.raises(NotImplementedError):
        ttrainer.multimodal_loss(weights[1], PCFG, tb, nseg=nseg, pos_skip_key=0)
