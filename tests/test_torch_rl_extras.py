"""The port's best-of-N sampler, tool-use text environment and DDPO trainer
(`memory_augmented_vlm_torch/train/best_of_n.py`, `text_environment.py`,
`ddpo.py`) against the JAX package's, on the tiny LM of the JAX tests in
fp32 (tests/test_torch_ppo_reward.py's `jax_tree`, carried across by
`convert.from_jax_params`).

Host bookkeeping (length draws, query forms, histories, the stat tracker)
bit for bit; decoded tokens equal, the sampler's from JAX's Gumbel draws
(the port's decode call wrapped to take them, `noise=`); DDPO's loss at
rtol 1e-6 and one trainer step's params at PARAM_ATOL.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from memory_augmented_vlm_tpu.train import best_of_n as jbon
from memory_augmented_vlm_tpu.train import ddpo as jddpo
from memory_augmented_vlm_tpu.train import text_environment as jenv
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import vlm as tvlm
from memory_augmented_vlm_torch.train import best_of_n as tbon
from memory_augmented_vlm_torch.train import ddpo as tddpo
from memory_augmented_vlm_torch.train import text_environment as tenv
from test_torch_generate import _jax_gumbel
from test_torch_ppo_reward import JCFG, PCFG, jax_tree
from test_torch_train import PARAM_ATOL

V = JCFG.lm.vocab_size


@pytest.fixture(scope="module")
def lm():
    jp = jax_tree(seed=1, value_head=False)
    return jp, convert.from_jax_params(jp, PCFG, device="cpu")


# --------------------------------------------------------------- best-of-N

def test_length_sampler_draws_jax_lengths():
    j, t = jbon.LengthSampler(4, 30, seed=5), tbon.LengthSampler(4, 30, seed=5)
    assert [t() for _ in range(20)] == [j() for _ in range(20)]
    with pytest.raises(ValueError):
        tbon.LengthSampler(3, 3)


@pytest.mark.parametrize("form", ["ints", "tuple", "lists", "array_1d", "array_2d",
                                  "ragged_arrays"])
def test_query_batch_forms_match_jax(form):
    q = {"ints": [5, 17, 23], "tuple": (5, 17, 23), "lists": [[5, 17, 23], [40, 2]],
         "array_1d": np.array([5, 17, 23], np.int64),
         "array_2d": np.array([[5, 17], [23, 40]], np.int64),
         "ragged_arrays": [np.array([1, 2, 3]), np.array([4])]}[form]
    want = jbon.BestOfNSampler._as_query_batch(q)
    got = tbon.BestOfNSampler._as_query_batch(q)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_query_batch_rejects_bad_forms():
    for bad in ([], np.zeros((2, 2, 2), np.int32)):
        with pytest.raises(ValueError):
            tbon.BestOfNSampler._as_query_batch(bad)


def _decode(ids):
    return " ".join(f"t{int(i)}" for i in ids)


def _scores(texts):
    """Distinct tokens, ties broken by the text's byte sum."""
    return [len(set(t.split())) + 1e-9 * sum(map(ord, t)) for t in texts]


def test_best_of_n_matches_jax_given_its_draws(lm, monkeypatch):
    """Two queries, 4 samples each, the best 2 kept: the texts JAX scored,
    and the winners in the same order. Each query's decode runs JAX's
    32-token bucket, trimmed to the sampled lengths (4 to 29)."""
    jp, tp = lm
    queries = [[5, 17, 23], [40, 2, 9, 11]]
    kw = dict(decode=_decode, sample_size=4, seed=7, n_candidates=2, eos_token_ids=(49999,))
    seen = {"jax": [], "port": []}

    def scorer(name):
        def fn(texts):
            seen[name].append(texts)
            return _scores(texts)
        return fn

    want = jbon.BestOfNSampler(jax.tree.map(jnp.asarray, jp), JCFG, scorer("jax"),
                               jbon.LengthSampler(4, 30, seed=2), **kw).generate(queries)
    key, draws = jax.random.key(7), []
    for _ in queries:  # the sampler splits its key once per query
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(_jax_gumbel(sub, 32, (4, V))))
    calls = iter(draws)
    monkeypatch.setattr(tvlm, "generate_batched", _with_noise(tvlm.generate_batched, calls))
    got = tbon.BestOfNSampler(tp, PCFG, scorer("port"), tbon.LengthSampler(4, 30, seed=2),
                              **kw).generate(queries)
    assert seen["port"] == seen["jax"]
    assert got == want
    lengths = [len(t.split()) - len(q) for texts, q in zip(seen["port"], queries) for t in texts]
    assert min(lengths) >= 4 and max(lengths) < 30


def _with_noise(fn, draws):
    def call(*args, **kw):
        assert kw["do_sample"] and kw["rng"] is not None
        return fn(*args, noise=next(draws), **kw)
    return call


def test_best_of_n_validates_args(lm):
    _, tp = lm
    scores = lambda texts: [0.0 for _ in texts]  # noqa: E731
    make = functools.partial(tbon.BestOfNSampler, tp, PCFG, scores, tbon.LengthSampler(4, 5),
                             decode=_decode)
    for bad in (dict(n_candidates=9), dict(sample_size=0), dict(n_candidates=0)):
        with pytest.raises(ValueError):
            make(**bad)
    with pytest.raises(TypeError):
        make().generate([1, 2], num_beams=2)
    with pytest.raises(ValueError):
        make().generate([])
    with pytest.raises(ValueError):  # one score per sample
        tbon.BestOfNSampler(tp, PCFG, lambda texts: [0.0], tbon.LengthSampler(4, 5),
                            decode=_decode, eos_token_ids=(49999,)).generate([1, 2])


# -------------------------------------------------------- text environment

def _encode(s):
    return [ord(c) for c in s]


def _chars(ids):
    return "".join(chr(int(t)) for t in ids)


def _scripted(turns):
    """generate_fn replaying per-turn outputs for every active row."""
    state = {"i": 0}

    def fn(rows):
        out = [_encode(turns[min(state["i"], len(turns) - 1)]) for _ in rows]
        state["i"] += 1
        return out

    return fn


def _mixed(calls):
    """Row "a" submits on turn 1; the others keep calling the tool."""
    def fn(rows):
        calls.append(len(rows))
        return [_encode(f"done{tenv.SUBMIT_TOKEN}") if _chars(r).startswith("P: a")
                else _encode(f"{tenv.REQUEST_TOKEN}<Calc>1+1{tenv.CALL_TOKEN}") for r in rows]
    return fn


def _boom(q):
    raise RuntimeError("nope")


R, C, S = tenv.REQUEST_TOKEN, tenv.CALL_TOKEN, tenv.SUBMIT_TOKEN
CALC = {"Calc": lambda q: str(eval(q))}
# JAX's scripted cases (tests/test_text_environment.py): (turns or a batch
# generate_fn factory, queries, environment keywords)
ENV_CASES = {
    "tool_call_then_submit": ([f"{R}<Calc>2+2{C}", f"The answer is 4.{S}"],
                              ["what is 2+2?"], {}),
    "unknown_tool": ([f"{R}<Nope>x{C}", f"done{S}"], ["t"], {}),
    "malformed_call": ([f"{R}no name here{C}", f"done{S}"], ["t"], {}),
    "trim_non_atomic_markers": ([f"{R}<Calc>2+2{C}overrun text", f"ok{S}trailing junk"],
                                ["q"], {}),
    "tool_error": ([f"{R}<Calc>1{C}", f"x{S}"], ["t"], {"tools": {"Calc": _boom}}),
    "response_truncated": ([f"{R}<Calc>9{C}", f"x{S}"], ["t"],
                           {"tools": {"Calc": lambda q: "z" * 50}, "max_tool_response": 10}),
    "no_request_ends": (["just rambling"], ["t"], {}),
    "eos_text_ends": (["oops <eos> trailing"], ["t"], {}),
    "max_length_truncates": ([f"{R}<Calc>2+2{C}"] * 8, ["a long task string"],
                             {"max_length": 20}),
    "max_turns_bounds": ([f"{R}<Calc>1+1{C}"] * 10, ["t"], {"max_turns": 3}),
    "batch_mixed_completion": (_mixed, ["a", "b", "c"], {"max_turns": 2}),
}
HISTORY_FIELDS = ("text", "tokens", "text_spans", "token_spans", "system_spans", "token_masks",
                  "completed", "truncated", "reward")


def _run_env(mod, case):
    turns, queries, kw = ENV_CASES[case]
    kw = dict(kw)
    calls = []
    gen = turns(calls) if callable(turns) else _scripted(turns)
    env = mod.TextEnvironment(encode=_encode, decode=_chars, tools=kw.pop("tools", CALC),
                              reward_fn=lambda texts: [float(len(t)) for t in texts],
                              generate_fn=gen, eos_text="<eos>", prompt="P: ", **kw)
    return env.run(queries), calls


def _assert_runs_equal(got, want):
    for g, w in zip(got[:3], want[:3]):  # queries, responses, masks
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    for hg, hw in zip(got[4], want[4]):
        for field in HISTORY_FIELDS:
            assert getattr(hg, field) == getattr(hw, field), field


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_text_environment_scripted_turns_match_jax(case):
    (got, calls_t), (want, calls_j) = _run_env(tenv, case), _run_env(jenv, case)
    _assert_runs_equal(got, want)
    assert calls_t == calls_j
    for h in got[4]:  # the split agrees with the history's spans
        q, r, m = h.split_query_response_tokens()
        assert list(q) + list(r) == h.tokens and len(r) == len(m)
        model = [s for s, system in zip(h.token_spans[1:], h.system_spans[1:]) if not system]
        assert int(m.sum()) == sum(b - a for a, b in model)


def test_parse_tool_call_and_trim_match_jax():
    for text in (f"{R}<Wiki>a>b{C}", "no markers", f"{R}x{C}", f"a{S}b{C}c", f"a{C}b{S}"):
        assert tenv.TextEnvironment.parse_tool_call(text) == \
            jenv.TextEnvironment.parse_tool_call(text)
        assert tenv.TextEnvironment._trim_at_stop(text) == \
            jenv.TextEnvironment._trim_at_stop(text)
    with pytest.raises(ValueError):
        tenv.TextHistory("", [1])
    with pytest.raises(ValueError):
        tenv.TextEnvironment(encode=_encode, decode=_chars, tools={}, reward_fn=list)


def test_text_environment_real_lm_turn_matches_jax(lm):
    """The default batched decode on the tiny LM (greedy, stop sequences
    `<call>` and `<submit>`): JAX's tokens, histories and split."""
    jp, tp = lm

    def run(mod, params, cfg):
        env = mod.TextEnvironment(
            params, cfg, encode=lambda s: [ord(c) % V for c in s],
            decode=lambda ids: "".join(chr(32 + int(t) % 90) for t in ids),
            tools=CALC, reward_fn=lambda t: [0.5] * len(t), eos_text="§",
            eos_token_ids=(49999,), max_new_tokens=8, max_turns=2)
        return env.run(["hi", "there"])

    want = run(jenv, jax.tree.map(jnp.asarray, jp), JCFG)
    got = run(tenv, tp, PCFG)
    _assert_runs_equal(got, want)
    assert all(h.completed for h in got[4]) and all(len(r) == 8 for r in got[1])


# -------------------------------------------------------------------- DDPO

def test_per_prompt_stat_tracker_bit_equal():
    j, t = jddpo.PerPromptStatTracker(4, 3), tddpo.PerPromptStatTracker(4, 3)
    for prompts, rewards in ((["a", "a", "b"], [1.0, 2.0, 10.0]), (["a", "a"], [3.0, 4.0]),
                             (["a", "b", "a"], [5.0, 6.0, 7.0])):
        np.testing.assert_array_equal(t.update(prompts, rewards), j.update(prompts, rewards))
    assert t.get_stats() == j.get_stats()


def test_calculate_loss_matches_jax():
    rng = np.random.default_rng(0)
    lp_new = rng.standard_normal(16).astype(np.float32)
    lp_old = (lp_new + rng.standard_normal(16) * 0.3).astype(np.float32)
    adv = (rng.standard_normal(16) * 8).astype(np.float32)  # the +/-5 clamp acts
    want = jddpo.calculate_loss(jnp.asarray(lp_new), jnp.asarray(lp_old), jnp.asarray(adv),
                                clip_range=0.2, adv_clip_max=5.0)
    got = tddpo.calculate_loss(torch.from_numpy(lp_new), torch.from_numpy(lp_old),
                               torch.from_numpy(adv), clip_range=0.2, adv_clip_max=5.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    np.testing.assert_allclose(
        float(tddpo.ddpo_loss(torch.from_numpy(adv), 0.2, torch.from_numpy(np.exp(lp_new)))),
        float(jddpo.ddpo_loss(jnp.asarray(adv), 0.2, jnp.asarray(np.exp(lp_new)))), rtol=1e-6)


def test_adamw_matches_optax():
    """Three updates of a two-leaf tree from the same gradients."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jtx = optax.adamw(0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    ttx = tddpo.adamw(0.05, 0.9, 0.999, 1e-8, 1e-2)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tparams)
        tparams = {k: tparams[k] + tu[k] for k in tparams}
    for k in params:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7)


SIGMA = 0.3


def _rollouts(seed, batches, b, steps):
    """Fixed rollouts of JAX's toy Gaussian policy (tests/test_ddpo.py) at
    mu = 0, drawn with numpy: (latents (B, T+1), log_probs (B, T))."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        lat = [np.zeros(b, np.float32)]
        lps = []
        for _ in range(steps):
            mean = lat[-1] * 0.5
            nxt = (mean + SIGMA * rng.standard_normal(b)).astype(np.float32)
            lps.append((-0.5 * ((nxt - mean) / SIGMA) ** 2 - np.log(SIGMA)
                        - 0.5 * np.log(2 * np.pi)).astype(np.float32))
            lat.append(nxt)
        out.append((np.stack(lat, 1), np.stack(lps, 1)))
    return out


def _ddpo_run(mod, xp, rollouts, cfg):
    """One step of `mod`'s trainer over `rollouts` (its sample_fn hands them
    out in order and ignores its random source)."""
    it = iter(rollouts)

    def sample_fn(params, rng, prompt_embeds, num_steps):
        lat, lps = next(it)
        return {"latents": xp(lat), "log_probs": xp(lps),
                "timesteps": xp(np.broadcast_to(np.arange(num_steps), lps.shape).copy()),
                "images": xp(lat[:, -1])}

    def logprob_fn(params, latents, timesteps, next_latents, prompt_embeds):
        mu = prompt_embeds @ params["mu"]
        mean = latents + 0.5 * (mu - latents)
        return (-0.5 * ((next_latents - mean) / SIGMA) ** 2
                - np.log(SIGMA) - 0.5 * np.log(2 * np.pi))

    prompts = iter(["a", "b"] * 100)
    trainer = mod.DDPOTrainer(
        cfg, {"mu": xp(np.zeros(2, np.float32))}, sample_fn=sample_fn, logprob_fn=logprob_fn,
        prompt_fn=lambda: (next(prompts), None),
        reward_fn=lambda images, ps, meta: (-np.abs(np.asarray(images) - 1.0), None),
        embed_fn=lambda ps: xp(np.asarray([[1.0, 0.0] if p == "a" else [0.0, 1.0] for p in ps],
                                          np.float32)))
    step, metrics = trainer.step(0, 0)
    return trainer, step, metrics


@pytest.mark.parametrize("tracking", [False, True])
def test_ddpo_step_matches_jax(tracking):
    """sample batches 2 x 4, train batch 2, 3 denoising steps, 2 inner
    epochs: 24 updates after JAX's numpy shuffles, then the params."""
    cfg = dict(sample_num_steps=3, sample_batch_size=4, sample_num_batches_per_epoch=2,
               train_batch_size=2, train_num_inner_epochs=2, train_learning_rate=0.05,
               train_clip_range=0.2, per_prompt_stat_tracking=tracking,
               per_prompt_stat_tracking_buffer_size=8, per_prompt_stat_tracking_min_count=2,
               seed=1)
    rollouts = _rollouts(3, 2, 4, 3)
    jt, jstep, jm = _ddpo_run(jddpo, jnp.asarray, rollouts, jddpo.DDPOConfig(**cfg))
    tt, tstep, tm = _ddpo_run(tddpo, torch.from_numpy, rollouts, tddpo.DDPOConfig(**cfg))
    assert tstep == jstep == 24
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tt.params["mu"].numpy(), np.asarray(jt.params["mu"]), rtol=0,
                               atol=PARAM_ATOL)
    assert np.abs(tt.params["mu"].numpy()).max() > 10 * PARAM_ATOL
    if tracking:
        assert tt.stat_tracker.get_stats() == jt.stat_tracker.get_stats()
