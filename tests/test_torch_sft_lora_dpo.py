"""The port's SFT, LoRA and DPO trainers (`memory_augmented_vlm_torch/train/
sft.py`, `lora.py`, `dpo.py`) against the JAX package's, on the tiny config
of tests/test_vlm.py, fp32, with JAX's weights (and LoRA factors) carried
across by `convert`. Packing and completion-only labels are numpy and
bit-equal; losses, gradients and parameters are held to the tolerances of
tests/test_torch_train.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.train import dpo as jdpo
from memory_augmented_vlm_tpu.train import lora as jlora
from memory_augmented_vlm_tpu.train import sft as jsft
from memory_augmented_vlm_tpu.train import optimizer as jopt
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.train import dpo as tdpo
from memory_augmented_vlm_torch.train import lora as tlora
from memory_augmented_vlm_torch.train import sft as tsft
from memory_augmented_vlm_torch.train import trainer as ttrainer
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str, tree_map
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_ATOL, _assert_tree_close
from tests.test_vlm import TINY

PCFG = convert.config_from_fields(TINY)
OPT = jopt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                           mm_vision_tower_lr=None, weight_decay=0.01)
TOPT = OptimizerConfig(**dataclasses.asdict(OPT))


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda key: jvlm.init_params(TINY, key))(jax.random.key(0)))  # one compile
    return jp, convert.from_jax_params(jp, PCFG, device="cpu")


def _jstate(jp, cfg=OPT):
    return jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), cfg)


# ------------------------------------------------------------------ SFT

@pytest.mark.parametrize("append,shuffle", [(True, False), (False, False), (True, True)])
def test_pack_constant_length_matches_jax(append, shuffle):
    rng = np.random.default_rng(1)
    seqs = [rng.integers(5, 90, size=n).tolist() for n in (7, 3, 12, 1, 9, 5)]
    kw = dict(append_concat_token=append, shuffle=shuffle, seed=3)
    got = tsft.pack_constant_length(seqs, 8, 2, **kw)
    want = jsft.pack_constant_length(seqs, 8, 2, **kw)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["single", "none", "multi_turn", "response_first", "trailing"])
def test_completion_only_labels_match_jax(case):
    resp, instr = [7, 8], [5, 6]
    ids = {"single": [1, 5, 6, 9, 7, 8, 10, 11, 7, 8, 12],
           "none": [1, 2, 3, 4],
           "multi_turn": [5, 6, 9, 9, 7, 8, 10, 11, 5, 6, 13, 7, 8, 14, 15],
           "response_first": [7, 8, 20, 5, 6, 21, 7, 8, 22],
           "trailing": [5, 6, 9, 7, 8, 10, 5, 6, 11]}[case]
    for template in ((None,) if case == "single" else (None, instr)):
        got = tsft.completion_only_labels(np.asarray(ids), resp, template)
        want = jsft.completion_only_labels(np.asarray(ids), resp, template)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_sft_step_matches_jax(weights):
    """One packed-text SFT step: loss, supervised tokens, grad norm and params."""
    jp, tp = weights
    rng = np.random.default_rng(4)
    packed = tsft.pack_constant_length(
        [rng.integers(5, 1000, size=n).tolist() for n in (13, 21, 9, 30)], 16, 3)
    ids = np.stack(packed[:2]).astype(np.int32)
    labels = np.stack([tsft.completion_only_labels(x, [ids[0, 2], ids[0, 3]]) for x in ids]
                      ).astype(np.int32)
    valid = np.array([16, 12], np.int32)
    jstate, jm = jax.jit(jsft.make_sft_train_step(TINY, OPT))(
        _jstate(jp), *(jnp.asarray(x) for x in (ids, labels, valid)))
    tstate, tm = tsft.make_sft_train_step(PCFG, TOPT)(
        ttrainer.init_train_state(tp, TOPT), *(torch.from_numpy(x) for x in (ids, labels, valid)))
    assert int(tm["supervised_tokens"]) == int(jm["supervised_tokens"]) > 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)


# ----------------------------------------------------------------- LoRA

def _factors(jp, seed=1, r=4, bump=True):
    """JAX's factors (B moved off zero when `bump`) and the port's copy."""
    cfg = jlora.LoraConfig(r=r, alpha=2 * r)
    jl = jlora.init_lora(jax.tree.map(jnp.asarray, jp), cfg, jax.random.key(seed))
    if bump:
        rng = np.random.default_rng(seed)
        jl = jax.tree.map(lambda x: x + jnp.asarray(
            rng.standard_normal(x.shape) * 0.01, x.dtype), jl)
    jl = jax.tree.map(np.asarray, jl)
    return cfg, jl, convert.lora_from_jax(jl, PCFG, device="cpu")


def test_lora_identity_at_init_and_targets(weights):
    jp, tp = weights
    cfg = tlora.LoraConfig(r=4, alpha=8)
    factors = tlora.init_lora(tp, cfg, torch.Generator().manual_seed(0))
    merged = tlora.apply_lora(tp, factors, cfg)
    for (path, a), (_, b) in zip(leaves_with_path(tp), leaves_with_path(merged)):
        assert torch.equal(a, b), path_str(path)
    names = {path_str(p) for p, _ in leaves_with_path(factors)}
    assert len(names) == 2 * 7 * PCFG.lm.num_hidden_layers
    assert all(n.startswith("language_model.layers.") for n in names)
    a = factors["language_model"]["layers"][0]["q_proj"]["kernel"]["a"]
    assert a.shape == (PCFG.lm.hidden_size, 4) and float(a.std()) > 0
    # the same targets and shapes as JAX's factor tree
    _, jl, tl = _factors(jp, bump=False)
    assert {path_str(p) for p, _ in leaves_with_path(tl)} == names
    assert tlora.lora_trainable_mask(tp, factors)[1]["language_model"]["layers"][0][
        "q_proj"]["kernel"]["a"] is True


def test_lora_merged_forward_and_factor_grads_match_jax(weights):
    """JAX's factors, B moved off zero: the merged params equal JAX's
    merge, and the gradients of a text loss reach the factors alone, as
    JAX's do."""
    jp, tp = weights
    cfg, jl, tl = _factors(jp)
    tcfg = tlora.LoraConfig(r=cfg.r, alpha=cfg.alpha)
    jmerged = jlora.merge_and_unload(jax.tree.map(jnp.asarray, jp), jl, cfg)
    _assert_tree_close(tlora.merge_and_unload(tp, tl, tcfg), jmerged, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 1000, size=(2, 12)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = constants.IGNORE_INDEX
    tl_len = np.array([12, 9], np.int32)
    jb = jtrainer.TextBatch(*(jnp.asarray(x) for x in (ids, labels, tl_len)))
    tb = ttrainer.TextBatch(*(torch.from_numpy(x) for x in (ids, labels, tl_len)))

    def jloss(f):
        return jtrainer.text_loss(jlora.apply_lora(jax.tree.map(jnp.asarray, jp), f, cfg,
                                                   freeze_base=True), TINY, jb)[0]

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, jl))
    (tval, _), tgrads = ttrainer.value_and_grad_params(
        lambda f: ttrainer.text_loss(tlora.apply_lora(tp, f, tcfg, freeze_base=True), PCFG, tb),
        tl)
    np.testing.assert_allclose(float(tval), float(jval), **LOSS_TOL)
    _assert_tree_close(tgrads, {"language_model": {"layers": jgrads["language_model"]["layers"]}},
                       **GRAD_TOL)


def test_lora_train_step_moves_only_the_factors(weights):
    jp, tp = weights
    cfg, _, tl = _factors(jp)
    tcfg = tlora.LoraConfig(r=cfg.r, alpha=cfg.alpha)
    rng = np.random.default_rng(6)
    ids = rng.integers(5, 1000, size=(1, 10))
    batch = ttrainer.TextBatch(torch.from_numpy(ids), torch.from_numpy(ids),
                               torch.tensor([10]))
    base = tree_map(lambda x: x.clone(), tp)
    state = ttrainer.init_train_state(tl, TOPT)
    state, m = tlora.make_lora_train_step(PCFG, TOPT, tcfg)(state, base, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for (path, a), (_, b) in zip(leaves_with_path(tp), leaves_with_path(base)):
        assert torch.equal(a, b), path_str(path)
    for (path, a), (_, b) in zip(leaves_with_path(tl), leaves_with_path(state.params)):
        assert not torch.equal(a, b), path_str(path)


def test_qlora_over_int8_base_matches_jax_and_int4_raises(weights):
    """Factors over JAX's int8 LM (`prequantize_int8(bits=8)`): the merged
    (dequantized bf16) kernels equal JAX's to the bit, the stored base
    stays int8, and a bf16 model's gradients reach the factors."""
    jp, _ = weights
    jq = dict(jp, language_model=jax.tree.map(np.asarray, jqwen2.prequantize_int8(
        jax.tree.map(jnp.asarray, jp["language_model"]), TINY.lm, bits=8)))
    cfg = jlora.LoraConfig(r=4, alpha=8)
    jl = jlora.init_lora(jq, cfg, jax.random.key(1))
    jl = jax.tree.map(lambda x: np.asarray(x + 0.01, x.dtype), jl)  # B off zero
    tl = convert.lora_from_jax(jl, PCFG, device="cpu")
    up = tl["language_model"]["layers"][0]["up_proj"]["kernel_int8"]
    assert up["a"].dtype == torch.bfloat16 and up["a"].shape == (32, 4)
    tcfg = tlora.LoraConfig(r=4, alpha=8)
    tq = convert.from_jax_params(jq, PCFG, device="cpu")
    tmerged = tlora.apply_lora(tq, tl, tcfg, freeze_base=True)["language_model"]
    jmerged = jlora.apply_lora(jq, jl, cfg, freeze_base=True)["language_model"]
    for name in tcfg.target_modules:
        want = np.asarray(jmerged["layers"][name]["kernel"], np.float32)
        got = np.stack([lyr[name]["kernel"].float().numpy() for lyr in tmerged["layers"]])
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert set(tmerged["layers"][0][name]) == set(jmerged["layers"][name])
    assert tq["language_model"]["layers"][0]["up_proj"]["kernel_int8"].dtype == torch.int8
    # a bf16 model over the int8 base: gradients reach the factors
    tq16 = convert.from_jax_params(jq, PCFG, device="cpu", dtype=torch.bfloat16)
    emb = tqwen2.embed_tokens(tq16["language_model"], torch.arange(6)[None])
    pos = torch.arange(6)[None]

    def loss(f):
        m = tlora.apply_lora(tq16, f, tcfg, freeze_base=True)
        h, _ = tqwen2.forward(m["language_model"], PCFG.lm, emb, pos, need_cache=False)
        return (h.float() ** 2).mean(), {}

    (_, _), grads = ttrainer.value_and_grad_params(loss, tl)
    assert float(grads["language_model"]["layers"][0]["up_proj"]["kernel_int8"]["b"]
                 .abs().max()) > 0
    int4 = {"language_model": {"layers": [{"up_proj": {"kernel_int4": torch.zeros(
        16, 64, dtype=torch.uint8), "scale": torch.ones(64)}}]}}
    with pytest.raises(NotImplementedError, match="int4"):
        tlora.init_lora(int4, tcfg, torch.Generator())
    with pytest.raises(NotImplementedError, match="int4"):
        tlora.apply_lora(int4, {}, tcfg)


# ------------------------------------------------------------------ DPO

@pytest.mark.parametrize("ls", [0.0, 0.2])
def test_dpo_loss_matches_jax(ls):
    rng = np.random.default_rng(7)
    lps = [rng.standard_normal(5).astype(np.float32) * 3 for _ in range(4)]
    jcfg = jdpo.DPOConfig(beta=0.3, label_smoothing=ls)
    tcfg = tdpo.DPOConfig(beta=0.3, label_smoothing=ls)
    want = jdpo.dpo_loss(*(jnp.asarray(x) for x in lps), jcfg)
    got = tdpo.dpo_loss(*(torch.from_numpy(x) for x in lps), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    same = tdpo.dpo_loss(torch.tensor([1.0, -2.0]), torch.tensor([0.0, -3.0]),
                         torch.tensor([1.0, -2.0]), torch.tensor([0.0, -3.0]),
                         tdpo.DPOConfig(beta=0.1))
    np.testing.assert_allclose(same[0].numpy(), np.log(2.0), rtol=1e-6)


def _dpo_batch(b=2, fmax=8, nfine=4, st=6):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, size=(b, st)).astype(np.int32)
    worse = rng.integers(5, 100, size=(b, st)).astype(np.int32)
    arrays = dict(
        pixels=rng.standard_normal((b, fmax, 56, 56, 3)).astype(np.float32),
        frame_indices=np.broadcast_to(np.arange(fmax, dtype=np.int32), (b, fmax)).copy(),
        frame_valid=np.ones((b, fmax), bool),
        fine_idx=np.broadcast_to(jvlm.fine_frame_indices(fmax, nfine).astype(np.int32),
                                 (b, nfine)).copy(),
        chosen_ids=ids, chosen_labels=ids.copy(), rejected_ids=worse,
        rejected_labels=worse.copy(), image_pos=((np.arange(b) % 3) + 1).astype(np.int32),
        chosen_len=np.full((b,), st, np.int32), rejected_len=np.array([st, st - 2], np.int32))
    return (jdpo.DPOBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tdpo.DPOBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_dpo_step_matches_jax(weights):
    """One DPO step from a policy that differs from the reference (its LM
    moved by noise of 1e-2), so the DPO term and rewards are not their init
    values: loss, every metric, grad norm and params."""
    jp, tp = weights
    jb, tb = _dpo_batch()
    dcfg = dict(beta=0.5, gamma=0.1, label_smoothing=0.1)
    rng = np.random.default_rng(8)
    jpol = dict(jp, language_model=jax.tree.map(
        lambda x: (x + rng.standard_normal(x.shape) * 1e-2).astype(x.dtype),
        jp["language_model"]))
    jstate, jm = jax.jit(jdpo.make_dpo_train_step(TINY, OPT, jdpo.DPOConfig(**dcfg), nseg=1))(
        _jstate(jpol), jax.tree.map(jnp.asarray, jp), jb)
    tpol = convert.from_jax_params(jpol, PCFG, device="cpu")
    tstate, tm = tdpo.make_dpo_train_step(PCFG, TOPT, tdpo.DPOConfig(**dcfg), nseg=1)(
        ttrainer.init_train_state(tpol, TOPT), tp, tb)
    assert set(tm) == set(jm)
    # the rewards are beta times differences of sequence log-prob sums (a
    # sequence's mean NLL times its 5 targets): held to rtol 1e-5 of those
    # sums, not of the small difference
    lp_scale = dcfg["beta"] * float(jm["sft_loss"]) * 5
    for k in jm:
        atol = 1e-5 * lp_scale if k.startswith("reward") else 1e-6
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=atol, err_msg=k)
    assert float(tm["rewards_chosen"]) != 0
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
