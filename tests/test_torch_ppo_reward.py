"""The port's PPO, reward and iterative-SFT trainers
(`memory_augmented_vlm_torch/train/ppo.py`, `reward.py`,
`iterative_sft.py`) against the JAX package's, on the tiny LM of the JAX
tests (tests/test_ppo_sft.py, test_reward_iterative.py) in fp32, JAX's
weights and value head carried across by `convert.from_jax_params`'s
text-only path, the same numpy inputs.

The statistics are held to rtol 1e-6; the steps' statistics, grad_norm and
params to tests/test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_ATOL;
the host-side batch preparation bit for bit.
"""

import dataclasses
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.config import LMConfig, VLMConfig
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.train import iterative_sft as jisft
from memory_augmented_vlm_tpu.train import optimizer as jopt
from memory_augmented_vlm_tpu.train import ppo as jppo
from memory_augmented_vlm_tpu.train import reward as jreward
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.train import iterative_sft as tisft
from memory_augmented_vlm_torch.train import optimizer as topt
from memory_augmented_vlm_torch.train import ppo as tppo
from memory_augmented_vlm_torch.train import reward as treward
from memory_augmented_vlm_torch.train import trainer as ttrainer
from test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_ATOL, _assert_tree_close

TINY_LM = dict(vocab_size=50000, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, rope_theta=10000.0,
               tie_word_embeddings=True, dtype="float32")
JCFG = VLMConfig(lm=LMConfig(**TINY_LM))
PCFG = convert.config_from_fields(JCFG)
STAT = dict(rtol=1e-6, atol=1e-7)
# the advantages' elements near 0 also get an absolute 1e-6 (they are O(1)):
# XLA fuses some of the whitening's multiply-adds, which the port rounds twice
ADV = dict(rtol=1e-6, atol=1e-6)
OPT = jopt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0,
                           mm_tunable_parts="mm_language_model,value_head")


def _port_opt(cfg):
    return topt.OptimizerConfig(**dataclasses.asdict(cfg))


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_tree(seed: int = 0, value_head: bool = True):
    """A tiny-LM tree in JAX's layout, (LM, value head) or the LM alone: the
    shapes of JAX's init filled from numpy (norms near 1, the head at 0.2,
    the rest at 0.02), so that no JAX random draw compiles."""
    def init(k0, k1):
        tree = {"language_model": jqwen2.init_params(JCFG.lm, k0)}
        if value_head:
            tree["value_head"] = jppo.init_value_head(JCFG.lm.hidden_size, k1)
        return tree

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape)
        if "norm" in name:
            return (1 + 0.1 * x).astype(np.float32)
        return ((0.2 if "value_head" in name else 0.02) * x).astype(np.float32)

    shapes = jax.eval_shape(init, jax.random.key(0), jax.random.key(1))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def policy():
    """JAX's (LM, value head) tree and the port's, converted."""
    jp = jax_tree()
    return jp, convert.from_jax_params(jp, PCFG, device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _stats_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], err_msg=k, **tol)


def test_from_jax_params_carries_a_text_only_tree(policy):
    """The RL trees hold no tower or memory: only their parts come across,
    the value head in JAX's (H, 1) layout; an unknown part raises."""
    jp, tp = policy
    assert set(tp) == {"language_model", "value_head"}
    assert len(tp["language_model"]["layers"]) == JCFG.lm.num_hidden_layers
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(tp["value_head"]["summary"][key].numpy(),
                                      jp["value_head"]["summary"][key])
    assert tp["value_head"]["summary"]["kernel"].shape == (32, 1)
    with pytest.raises(ValueError, match="critic"):
        convert.from_jax_params({**jp, "critic": {}}, PCFG, device="cpu")


# ------------------------------------------------------------- statistics

def _values_and_mask(seed=0, shape=(4, 12)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    m = (rng.random(shape) > 0.3).astype(np.float32)
    return x, m


@pytest.mark.parametrize("stat", ["mean", "mean_axis1", "var", "var_biased", "whiten",
                                  "whiten_no_shift", "entropy"])
def test_masked_statistics_match_jax(stat):
    x, m = _values_and_mask()
    fns = {"mean": lambda mod, a, b: mod.masked_mean(a, b),
           "mean_axis1": lambda mod, a, b: mod.masked_mean(a, b, axis=1),
           "var": lambda mod, a, b: mod.masked_var(a, b),
           "var_biased": lambda mod, a, b: mod.masked_var(a, b, unbiased=False),
           "whiten": lambda mod, a, b: mod.masked_whiten(a, b),
           "whiten_no_shift": lambda mod, a, b: mod.masked_whiten(a, b, shift_mean=False),
           "entropy": lambda mod, a, b: mod.entropy_from_logits(a)}
    got = fns[stat](tppo, _t(x), _t(m))
    want = fns[stat](jppo, jnp.asarray(x), jnp.asarray(m))
    _close(got, want, **STAT)


@pytest.mark.parametrize("kind", ["kl", "abs", "mse", "full"])
def test_kl_penalty_matches_jax(kind):
    rng = np.random.default_rng(1)
    shape = (2, 5, 11) if kind == "full" else (2, 5)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "full":
        a = np.asarray(jax.nn.log_softmax(a, axis=-1))
        b = np.asarray(jax.nn.log_softmax(b, axis=-1))
    _close(tppo.kl_penalty(_t(a), _t(b), kind), jppo.kl_penalty(a, b, kind), **STAT)
    if kind == "kl":
        with pytest.raises(NotImplementedError):
            tppo.kl_penalty(_t(a), _t(b), "bogus")


@pytest.mark.parametrize("kind", ["kl", "abs", "mse", "full_kls", "full_dists"])
def test_compute_rewards_matches_jax(kind):
    """Row 2's mask is all zero: the score lands at t - 1 in both."""
    rng = np.random.default_rng(2)
    b, t, v = 3, 7, 9
    scores = rng.standard_normal(b).astype(np.float32)
    masks = np.ones((b, t), np.float32)
    masks[0, 5:] = 0
    masks[1, 2:] = 0
    masks[2] = 0
    shape = (b, t, v) if kind == "full_dists" else (b, t)
    lp, ref = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "full_dists":
        lp, ref = (np.asarray(jax.nn.log_softmax(x, axis=-1)) for x in (lp, ref))
    full = np.abs(rng.standard_normal((b, t))).astype(np.float32)
    kw = {"full_kls": full} if kind == "full_kls" else {}
    jkind = "full" if kind.startswith("full") else kind
    want = jppo.compute_rewards(jnp.asarray(scores), jnp.asarray(lp), jnp.asarray(ref),
                                jnp.asarray(masks), jnp.asarray(0.2, jnp.float32), jkind,
                                **{k: jnp.asarray(x) for k, x in kw.items()})
    got = tppo.compute_rewards(_t(scores), _t(lp), _t(ref), _t(masks),
                               torch.tensor(0.2), jkind, **{k: _t(x) for k, x in kw.items()})
    for g, w in zip(got, want):
        _close(g, w, **STAT)
    # the score at each row's last mask index; t - 1 for the empty row
    bonus = (got[0] - got[1]).numpy()
    assert [int(np.flatnonzero(r)[0]) for r in bonus] == [4, 1, t - 1]
    if kind == "full_kls":
        with pytest.raises(ValueError):
            tppo.compute_rewards(_t(scores), _t(lp), _t(ref), _t(masks), 0.2, "full")


@pytest.mark.parametrize("whiten", [False, True])
def test_compute_advantages_matches_jax(whiten):
    rng = np.random.default_rng(3)
    values = rng.standard_normal((3, 9)).astype(np.float32)
    rewards = rng.standard_normal((3, 9)).astype(np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[1, 6:] = 0
    cfg = dict(whiten_rewards=whiten, gamma=0.99, lam=0.9)
    want = jax.jit(lambda *a: jppo.compute_advantages(*a, jppo.PPOConfig(**cfg)))(
        jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(mask))
    got = tppo.compute_advantages(_t(values), _t(rewards), _t(mask), tppo.PPOConfig(**cfg))
    for g, w in zip(got, want):
        _close(g, w, **ADV)
    assert not got[1].requires_grad


@pytest.mark.parametrize("case", ["random", "zeroed"])
def test_ppo_loss_matches_jax(case):
    """`zeroed`: ratios of e^5 pass the threshold, so both losses are 0."""
    rng = np.random.default_rng(4)
    b, t, v = 2, 6, 10
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((b, t), (b, t), (b, t, v), (b, t), (b, t))]
    old_lp, values, logits, vpreds, lp = arrays
    if case == "zeroed":
        lp = old_lp + 5.0
    mask = np.ones((b, t), np.float32)
    mask[1, 4:] = 0
    adv, ret = (rng.standard_normal((b, t)).astype(np.float32) for _ in range(2))
    args = (old_lp, values, logits, vpreds, lp, mask, adv, ret)
    want = jax.jit(lambda *a: jppo.ppo_loss(*a, jppo.PPOConfig()))(*map(jnp.asarray, args))
    got = tppo.ppo_loss(*map(_t, args), tppo.PPOConfig())
    _close(got[0], want[0], **STAT)
    _close(got[1], want[1], **STAT)
    _stats_close(got[2], want[2], **STAT)
    if case == "zeroed":
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


def test_kl_controllers_match_jax():
    for cfg in (dict(), dict(adap_kl_ctrl=False)):
        jc = jppo.make_kl_controller(jppo.PPOConfig(**cfg))
        tc = tppo.make_kl_controller(tppo.PPOConfig(**cfg))
        assert type(tc).__name__ == type(jc).__name__
        for current in (1.0, 6.5, 40.0):
            jc.update(current, 4)
            tc.update(current, 4)
            assert tc.value == jc.value


def test_response_logprobs_and_full_kl_match_jax():
    rng = np.random.default_rng(5)
    b, s, v, t = 2, 10, 7, 6
    logits, ref = (rng.standard_normal((b, s, v)).astype(np.float32) for _ in range(2))
    ids = rng.integers(0, v, (b, s)).astype(np.int32)
    qlen = np.array([3, 6], np.int32)  # row 1's last positions clip at s - 1
    want = jax.jit(jppo._response_logprobs, static_argnums=3)(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(qlen), t)
    got = tppo._response_logprobs(_t(logits), _t(ids), _t(qlen), t)
    for g, w in zip(got, want):
        _close(g, w, **STAT)
    _close(tppo.response_full_kl(_t(logits), _t(ref), _t(qlen), t),
           jppo.response_full_kl(jnp.asarray(logits), jnp.asarray(ref), jnp.asarray(qlen), t),
           **STAT)


# ---------------------------------------------------------------- the model

def test_value_head_init_and_promotion():
    """The head's draws come from the caller's generator (the card by
    default); bf16 hidden states meet the fp32 head in fp32, as in JAX."""
    params = inspect.signature(tppo.init_value_head).parameters
    assert params["device"].default == "cuda"
    head = tppo.init_value_head(32, torch.Generator().manual_seed(0), device="cpu")
    assert head["summary"]["kernel"].shape == (32, 1) and not head["summary"]["bias"].any()
    hidden = np.random.default_rng(6).standard_normal((2, 3, 32)).astype(np.float32)
    bf16 = torch.from_numpy(hidden).to(torch.bfloat16)
    got = tppo.value_head(head, bf16)
    want = jppo.value_head(jax.tree.map(lambda x: jnp.asarray(x.numpy()), head),
                           jnp.asarray(bf16.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, **STAT)


def test_forward_with_value_matches_jax(policy):
    jp, tp = policy
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 1000, (2, 12)).astype(np.int32)
    valid = np.array([12, 9], np.int32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    jemb = jqwen2.embed_tokens(jp["language_model"], jnp.asarray(ids), JCFG.lm)
    want = jax.jit(lambda p, e: jppo.forward_with_value(p, JCFG, e, jnp.asarray(pos),
                                                        jnp.asarray(valid)))(jp, jemb)
    temb = tqwen2.embed_tokens(tp["language_model"], _t(ids), PCFG.lm)
    got = tppo.forward_with_value(tp, PCFG, temb, _t(pos), _t(valid))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


def _ppo_batch(seed, kind):
    """B 2, S 16, T 6; rollout log-probs near the model's (-log 50000), so
    the ratio is near 1 and the clip is partly active."""
    rng = np.random.default_rng(seed)
    b, s, t = 2, 16, 6
    mask = np.ones((b, t), np.float32)
    mask[1, 5:] = 0
    arrays = dict(
        input_ids=rng.integers(0, 1000, (b, s)).astype(np.int32),
        response_mask=mask,
        query_len=np.array([8, 7], np.int32),
        seq_len=np.array([14, 12], np.int32),
        old_logprobs=(-np.log(50000) + 0.2 * rng.standard_normal((b, t))).astype(np.float32),
        old_values=(0.1 * rng.standard_normal((b, t))).astype(np.float32),
        scores=np.array([1.0, -0.5], np.float32),
        ref_logprobs=(-np.log(50000) + 0.2 * rng.standard_normal((b, t))).astype(np.float32))
    if kind == "full":
        arrays["full_kls"] = np.abs(0.1 * rng.standard_normal((b, t))).astype(np.float32)
    return (jppo.PPOBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tppo.PPOBatch(**{k: _t(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("kind", ["kl", "full"])
def test_ppo_train_step_matches_jax(policy, kind):
    jp, tp = policy
    jb, tb = _ppo_batch(9, kind)
    jstate, jstats = jax.jit(jppo.make_ppo_train_step(JCFG, OPT, jppo.PPOConfig(kl_penalty=kind)))(
        jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), OPT), jb,
        jnp.asarray(0.2, jnp.float32))
    step = tppo.make_ppo_train_step(PCFG, _port_opt(OPT), tppo.PPOConfig(kl_penalty=kind))
    tstate, tstats = step(ttrainer.init_train_state(tp, _port_opt(OPT)), tb, 0.2)
    grad_norm = tstats.pop("grad_norm")
    _close(grad_norm, jstats.pop("grad_norm"), rtol=GRAD_TOL["rtol"])
    _stats_close(tstats, jstats, **LOSS_TOL)
    assert 0 < float(tstats["policy/clipfrac"]) < 1
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
    assert tstate.step == 1
    assert not torch.equal(tstate.params["value_head"]["summary"]["kernel"],
                           tp["value_head"]["summary"]["kernel"])


# ------------------------------------------------------------------- reward

def test_sequence_reward_matches_jax(policy):
    """Pooled at the last valid token of unequal lengths; right padding
    changes nothing."""
    jp, tp = policy
    rng = np.random.default_rng(9)
    ids = rng.integers(5, 1000, (2, 12)).astype(np.int32)
    valid = np.array([12, 7], np.int32)
    want = jax.jit(lambda p, x, n: jreward.sequence_reward(p, JCFG, x, n))(
        jp, jnp.asarray(ids), jnp.asarray(valid))
    for x in (ids, np.pad(ids, ((0, 0), (0, 4)))):
        _close(treward.sequence_reward(tp, PCFG, _t(x), _t(valid)), want,
               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("margin", [False, True])
def test_reward_loss_matches_jax(margin):
    rng = np.random.default_rng(10)
    rc, rr, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    want = jreward.reward_loss(jnp.asarray(rc), jnp.asarray(rr),
                               jnp.asarray(m) if margin else None)
    got = treward.reward_loss(_t(rc), _t(rr), _t(m) if margin else None)
    _close(got, want, **STAT)


def test_reward_train_step_matches_jax(policy):
    jp, tp = policy
    rng = np.random.default_rng(11)
    arrays = dict(chosen_ids=rng.integers(5, 1000, (2, 10)).astype(np.int32),
                  chosen_len=np.array([10, 9], np.int32),
                  rejected_ids=rng.integers(5, 1000, (2, 10)).astype(np.int32),
                  rejected_len=np.array([10, 7], np.int32),
                  margin=np.array([0.5, -0.25], np.float32))
    jstate, jm = jax.jit(jreward.make_reward_train_step(JCFG, OPT))(
        jtrainer.init_train_state(jax.tree.map(jnp.asarray, jp), OPT),
        jreward.RewardBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    tstate, tm = treward.make_reward_train_step(PCFG, _port_opt(OPT))(
        ttrainer.init_train_state(tp, _port_opt(OPT)),
        treward.RewardBatch(**{k: _t(v) for k, v in arrays.items()}))
    _close(tm.pop("grad_norm"), jm.pop("grad_norm"), rtol=GRAD_TOL["rtol"])
    _stats_close(tm, jm, **LOSS_TOL)
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)


def test_init_reward_params_attaches_a_head():
    lm = {"embed_tokens": torch.zeros(3, 32)}
    params = treward.init_reward_params(PCFG, lm, torch.Generator().manual_seed(1),
                                        device="cpu")
    assert params["language_model"] is lm
    assert params["value_head"]["summary"]["kernel"].shape == (32, 1)


# ------------------------------------------------------------ iterative SFT

@pytest.mark.parametrize("kw", [dict(), dict(attention_mask=[[1, 1, 0, 1, 1, 1], [1, 1]]),
                                dict(labels=[[9, 9, 9, 9, 9, 9], [8, 8]]),
                                dict(max_length=4, truncation_mode="keep_end"),
                                dict(max_length=4, truncation_mode="keep_start"),
                                dict(pad_to_multiple=3)])
def test_prepare_model_inputs_bit_equal(kw):
    ids = [[1, 2, 3, 4, 5, 6], [7, 8]]
    want = jisft.prepare_model_inputs(ids, **kw)
    got = tisft.prepare_model_inputs(ids, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tisft.prepare_model_inputs(ids, max_length=4, truncation_mode="bogus")


def test_iterative_sft_two_steps_match_jax(policy):
    jp, tp = policy
    opt = jopt.OptimizerConfig(learning_rate=5e-3, warmup_ratio=0.0, schedule="constant",
                               total_steps=50, mm_tunable_parts="mm_language_model")
    jtr = jisft.IterativeSFT(JCFG, opt, {"language_model": jax.tree.map(
        jnp.asarray, jp["language_model"])}, batch_size=2, seed=3)
    ttr = tisft.IterativeSFT(PCFG, _port_opt(opt), {"language_model": tp["language_model"]},
                             batch_size=2, seed=3)
    rng = np.random.default_rng(12)
    samples = [list(rng.integers(5, 50, size=rng.integers(6, 12))) for _ in range(4)]
    for _ in range(2):
        want, got = jtr.step(input_ids=samples), ttr.step(input_ids=samples)
        assert got["num_minibatches"] == want["num_minibatches"] == 2
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    _assert_tree_close(ttr.state.params, jtr.state.params, rtol=0, atol=PARAM_ATOL)
    with pytest.raises(ValueError):
        ttr.step(None)
