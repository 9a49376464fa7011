"""The port's generation surface (`memory_augmented_vlm_torch/models/vlm.py`:
`generate`, `generate_batched`, `generate_stream`; `qwen2.forward_chunk`
and `decode_chunk_batched`) against the JAX package's on the tiny config of
tests/test_vlm.py, fp32, the same converted weights and numpy inputs.

Two LMs: the seeded init ("flat": greedy repeats one token, which the
tests of acceptance want) and the same weights with every matrix times 5
("lively": varied tokens, so an eos and a stop sequence taken from the
model's own output fire mid-run). Tokens and counts equal; hidden states
within 1e-5; caches equal. Sampling takes JAX's Gumbel draws, and
`jax.random.categorical` is checked to be the argmax of the logits plus
those draws. 13 new tokens: not a multiple of the port's 8-step decode
chunk, so the port's longer cache (smax + 16 positions) runs against JAX's
exact bound (smax + 13).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import vlm as tvlm
from test_vlm import TINY

PCFG = convert.config_from_fields(TINY)
MAX_NEW = 13
HID = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    lively = dict(jp, language_model=jax.tree.map(lambda a: a * 5 if a.ndim >= 2 else a,
                                                  jp["language_model"]))
    return {name: (p, convert.from_jax_params(p, PCFG, device="cpu"))
            for name, p in (("flat", jp), ("lively", lively))}


def _batch(seed=0, valid=(40, 23, 31)):
    emb = (0.5 * np.random.default_rng(seed).standard_normal((len(valid), 40, 32))
           ).astype(np.float32)
    return emb, np.asarray(valid, np.int32)


def _single(seed=1, s=29):
    return (0.5 * np.random.default_rng(seed).standard_normal((s, 32))).astype(np.float32)


def _first_new(tokens, at_least):
    """The first step >= at_least whose token did not occur before it."""
    for i in range(at_least, len(tokens)):
        if tokens[i] not in tokens[:i]:
            return i
    raise AssertionError(f"no new token after step {at_least}: {tokens}")


def _jax_gumbel(key, steps, shape):
    """The Gumbel draws JAX's decode takes: step t draws from the t-th
    split of the key."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


def _equal(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(want.num_tokens))


# ------------------------------------------------------ generate_batched

@pytest.mark.parametrize("case", ["plain", "eos", "stop", "eos_and_stop", "penalty",
                                  "penalty_eos_stop"])
def test_generate_batched_greedy_matches_jax(models, case):
    """B = 3 rows of unequal valid length (40, 23, 31). The penalty cases
    run the flat LM, whose greedy rows repeat one token until a repetition
    penalty of 3 moves them."""
    penalty = "penalty" in case
    jp, tp = models["flat" if penalty else "lively"]
    emb, valid = _batch()
    base = dict(repetition_penalty=3.0) if penalty else {}

    def jax_run(**kw):
        return jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                     max_new_tokens=MAX_NEW, **base, **kw)

    free = np.asarray(jax_run().tokens)
    kw, fires = {}, {}
    if "eos" in case:
        i = _first_new(free[0], 4)
        kw["eos_token_ids"] = (int(free[0, i]),)
        fires[0] = i + 1
    if "stop" in case:
        j = _first_new(free[2], 6)
        kw["stop_sequences"] = (tuple(int(t) for t in free[2, j - 1:j + 1]), (49999, 1, 2))
        fires[2] = j + 1
    want = jax_run(**kw)
    got = tvlm.generate_batched(tp, PCFG, torch.from_numpy(emb), torch.from_numpy(valid),
                                max_new_tokens=MAX_NEW, **base, **kw)
    _equal(got, want)
    for row, n in fires.items():  # the stop fired mid-run at the step planned
        assert int(got.num_tokens[row]) == n < MAX_NEW
        assert not got.tokens[row, n:].any()
    if penalty:
        plain = jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                      max_new_tokens=MAX_NEW)
        assert not np.array_equal(np.asarray(plain.tokens), free)


def test_generate_matches_jax_with_eos_and_stop(models):
    jp, tp = models["lively"]
    emb = _single()
    free = np.asarray(jvlm.generate(jp, TINY, jnp.asarray(emb), max_new_tokens=MAX_NEW).tokens)
    i = _first_new(free, 7)
    kw = dict(eos_token_ids=(int(free[i]), 3), stop_sequences=((int(free[2]), int(free[3])),))
    want = jvlm.generate(jp, TINY, jnp.asarray(emb), max_new_tokens=MAX_NEW, **kw)
    got = tvlm.generate(tp, PCFG, torch.from_numpy(emb), max_new_tokens=MAX_NEW, **kw)
    _equal(got, want)
    assert got.tokens.shape == (MAX_NEW,) and int(got.num_tokens) == 4  # the stop sequence


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """What the port's sampling assumes of jax.random.categorical, checked on
    JAX's own function: the argmax of the logits plus gumbel(key) draws."""
    logits = 2.0 * np.random.default_rng(8).standard_normal((3, 500)).astype(np.float32)
    logits[:, 100:] = -1e30  # a warped row: most of it masked
    key = jax.random.key(11)
    for _ in range(20):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.categorical(sub, jnp.asarray(logits), axis=-1))
        draws = np.asarray(jax.random.gumbel(sub, logits.shape, jnp.float32))
        np.testing.assert_array_equal(np.argmax(draws + logits, axis=-1), want)


@pytest.mark.parametrize("knobs", [dict(temperature=0.8), dict(temperature=0.7, top_k=20),
                                   dict(temperature=1.2, top_p=0.9),
                                   dict(temperature=0.7, top_k=50, top_p=0.8,
                                        repetition_penalty=1.2)])
def test_sampled_generate_batched_takes_jax_draws(models, knobs):
    jp, tp = models["lively"]
    emb, valid = _batch(seed=2)
    key = jax.random.key(3)
    want = jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                 max_new_tokens=MAX_NEW, do_sample=True, rng=key, **knobs)
    noise = _jax_gumbel(key, MAX_NEW, (3, TINY.lm.vocab_size))
    got = tvlm.generate_batched(tp, PCFG, torch.from_numpy(emb), torch.from_numpy(valid),
                                max_new_tokens=MAX_NEW, do_sample=True,
                                noise=torch.from_numpy(noise), **knobs)
    _equal(got, want)
    greedy = jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                   max_new_tokens=MAX_NEW)
    assert not np.array_equal(np.asarray(greedy.tokens), np.asarray(want.tokens))


def test_longer_cache_gives_jax_tokens_at_its_exact_bound(models):
    """JAX sizes the cache smax + max_new (53 positions); the port's decoder
    holds smax + ceil(max_new / chunk) * chunk (56 at its chunk of 8).
    decode_attention masks by length and the RoPE has no length-dependent
    basis, so the tokens are JAX's, and a decoder whose chunk is the whole
    budget (cache 53) picks them from the same logits."""
    jp, tp = models["lively"]
    emb, valid = _batch(seed=4)
    want = jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                 max_new_tokens=MAX_NEW, eos_token_ids=())
    got, rows = tvlm.generate_batched(tp, PCFG, torch.from_numpy(emb),
                                      torch.from_numpy(valid), max_new_tokens=MAX_NEW,
                                      eos_token_ids=(), return_logits=True)
    _equal(got, want)
    lm = tp["language_model"]
    st = tvlm._settings(MAX_NEW, (), (), False, 0.0, 1.0, 0, 1.0)
    for chunk, positions in ((tvlm.DECODE_CHUNK, 40 + 16), (MAX_NEW, 40 + MAX_NEW)):
        lay = tvlm._layout(torch.from_numpy(emb), st, chunk, False, True)
        with tvlm._decoder(lm, PCFG, lay, "cpu") as dec:
            assert dec.cache.k.shape[2] == positions
            dec.start(torch.from_numpy(emb), torch.from_numpy(valid), st)
            for _ in range(-(-MAX_NEW // chunk)):
                dec.run_chunk()
        np.testing.assert_array_equal(dec.state["tokens"][:, :MAX_NEW].numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(dec.state["rows"][:MAX_NEW].numpy(), rows.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_no_graph_is_built_on_the_cpu(models, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    tvlm.clear_decoders()
    _, tp = models["lively"]
    emb, valid = _batch()
    tvlm.generate_batched(tp, PCFG, torch.from_numpy(emb), torch.from_numpy(valid),
                          max_new_tokens=MAX_NEW)
    list(tvlm.generate_stream(tp, PCFG, torch.from_numpy(_single()), max_new_tokens=5))
    assert not tvlm._decoders


# ------------------------------------------------------------- stream

@pytest.mark.parametrize("chunk_size", [1, 3, 8])
@pytest.mark.parametrize("sampled", [False, True])
def test_generate_stream_chunks_match_jax(models, chunk_size, sampled):
    jp, tp = models["lively"]
    emb = _single(seed=5)
    free = np.asarray(jvlm.generate(jp, TINY, jnp.asarray(emb), max_new_tokens=MAX_NEW).tokens)
    kw = dict(max_new_tokens=MAX_NEW, eos_token_ids=(int(free[_first_new(free, 9)]),))
    key = jax.random.key(5)
    if sampled:
        kw["temperature"] = 0.9
    want = list(jvlm.generate_stream(jp, TINY, jnp.asarray(emb), chunk_size=chunk_size,
                                     rng=key, **kw))
    noise = torch.from_numpy(_jax_gumbel(key, MAX_NEW, (1, TINY.lm.vocab_size)))
    got = list(tvlm.generate_stream(tp, PCFG, torch.from_numpy(emb), chunk_size=chunk_size,
                                    noise=noise, **kw))
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    whole = tvlm.generate(tp, PCFG, torch.from_numpy(emb), noise=noise, **kw)
    assert np.concatenate(got).tolist() == whole.tokens[:int(whole.num_tokens)].tolist()


# -------------------------------------------------- forward_chunk family

def _prefill(jlm, emb, valid, smax):
    positions = jnp.arange(emb.shape[1])[None]
    return jqwen2.forward(jlm, TINY.lm, jnp.asarray(emb), positions,
                          valid_len=jnp.asarray(valid), cache_max_len=smax)[1]


def _caches(jcache, kind):
    """The JAX prefill cache in `kind` (bfloat16 or int8) for both packages."""
    if kind == "int8":
        jcache = jqwen2.quantize_cache(jcache)
    else:
        jcache = jcache._replace(k=jcache.k.astype(jnp.bfloat16),
                                 v=jcache.v.astype(jnp.bfloat16))
    parts = [None if a is None else torch.from_numpy(np.array(a.astype(jnp.float32)
                                                              if a.dtype == jnp.bfloat16
                                                              else a))
             for a in jcache]
    if kind != "int8":
        parts[0], parts[1] = parts[0].to(torch.bfloat16), parts[1].to(torch.bfloat16)
    return jcache, tqwen2.KVCache(*parts)


def _assert_cache_equal(tcache, jcache):
    """K/V (bf16 values or int8 codes) and lengths equal; an int8 cache's
    fp32 scales within the hidden states' 1e-5, since each is the max of a
    K/V row that the two packages' fp32 projections round apart."""
    names = ["k", "v", "length", "k_scale", "v_scale"]
    for name, got, want in zip(names, tcache, jcache):
        if want is None:
            continue
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=HID["rtol"], atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_forward_chunk_matches_jax(models, kind):
    jp, tp = models["lively"]
    jlm, tlm = jp["language_model"], tp["language_model"]
    emb, valid = _batch(seed=6, valid=(27,))
    jcache, tcache = _caches(_prefill(jlm, emb, valid, 48), kind)
    chunk = (0.5 * np.random.default_rng(7).standard_normal((1, 4, 32))).astype(np.float32)
    for start in (27, 46):  # the second window runs past the cache: the write clamps
        jh, jcache = jqwen2.forward_chunk(jlm, TINY.lm, jnp.asarray(chunk), jcache,
                                          jnp.asarray(start), rope_seq_len=48)
        th, tcache = tqwen2.forward_chunk(tlm, PCFG.lm, torch.from_numpy(chunk), tcache,
                                          torch.tensor(start), rope_seq_len=48)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HID)
        _assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_decode_chunk_batched_matches_jax(models, kind):
    """Row 0 writes inside the cache, row 1 half past its end (those two
    positions drop), row 2 is parked at the bound and writes nothing. The
    port's hidden is JAX's after the final norm, which JAX's function
    leaves out (its forward_chunk and decode_step apply it)."""
    jp, tp = models["lively"]
    jlm, tlm = jp["language_model"], tp["language_model"]
    emb, valid = _batch(seed=8)
    smax = 44
    jcache, tcache = _caches(_prefill(jlm, emb, valid, smax), kind)
    before = [t.clone() for t in tcache if t is not None]
    chunk = (0.5 * np.random.default_rng(9).standard_normal((3, 4, 32))).astype(np.float32)
    starts = np.array([int(valid[0]), smax - 2, smax], np.int32)
    jh, jcache = jqwen2.decode_chunk_batched(jlm, TINY.lm, jnp.asarray(chunk), jcache,
                                             jnp.asarray(starts))
    th, tcache = tqwen2.decode_chunk_batched(tlm, PCFG.lm, torch.from_numpy(chunk), tcache,
                                             torch.from_numpy(starts))
    want = jqwen2._norm(jh, jlm["norm"], TINY.lm)
    np.testing.assert_allclose(th.numpy(), np.asarray(want), **HID)
    _assert_cache_equal(tcache, jcache)
    for old, new in zip(before, [t for t in tcache if t is not None]):
        if new.dim() > 1:  # the parked row is untouched, bit for bit
            assert torch.equal(old[:, 2], new[:, 2])


# ------------------------------------------------- one decoder, any setting

def test_one_decoder_serves_every_setting(models):
    """A decoder's key (`_Layout`) holds shapes, dtypes and which processors
    run, never a setting's value: budgets within one chunk, eos ids, stop
    sequences and sampling values share it. One decoder started with each
    greedy setting in turn gives JAX's tokens and counts for each."""
    jp, tp = models["lively"]
    emb, valid = _batch(seed=6)
    free = np.asarray(jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid),
                                            max_new_tokens=MAX_NEW, eos_token_ids=()).tokens)
    settings = [
        dict(max_new_tokens=MAX_NEW, eos_token_ids=(), stop_sequences=()),
        dict(max_new_tokens=MAX_NEW, eos_token_ids=(int(free[0, 5]),),
             stop_sequences=((int(free[1, 3]), int(free[1, 4])),)),
        dict(max_new_tokens=10, eos_token_ids=(int(free[2, 7]), 1),
             stop_sequences=((int(free[0, 2]),), (5, 6, 7))),
    ]
    sts = [tvlm._settings(kw["max_new_tokens"], kw["eos_token_ids"], kw["stop_sequences"],
                          False, 0.0, 1.0, 0, 1.0) for kw in settings]
    x = torch.from_numpy(emb)
    layouts = {tvlm._layout(x, st, tvlm.DECODE_CHUNK, False, False) for st in sts}
    assert len(layouts) == 1
    sampled = {tvlm._layout(x, tvlm._settings(MAX_NEW, (3,), (), True, t, p, k, 1.0),
                            tvlm.DECODE_CHUNK, False, False)
               for t, p, k in ((0.7, 1.0, 0), (1.3, 0.9, 5), (0.5, 0.5, 40))}
    assert len(sampled) == 1 and not layouts & sampled
    dec = tvlm._Decoder(tp["language_model"], PCFG, layouts.pop(), "cpu", False)
    for kw, st in zip(settings, sts):
        want = jvlm.generate_batched(jp, TINY, jnp.asarray(emb), jnp.asarray(valid), **kw)
        dec.start(x, torch.from_numpy(valid), st)
        for _ in range(-(-st.max_new_tokens // dec.chunk)):
            dec.run_chunk()
        s = dec.state
        num = torch.where(s["done"], s["num"], st.max_new_tokens)
        _equal(tvlm.GenerateResult(s["tokens"][:, :st.max_new_tokens], num), want)


def test_a_held_decoder_is_not_lent_twice(monkeypatch):
    """On the card every entry holds its decoder for the call: a second
    call with the same layout while the first holds it gets a decoder of
    its own, and a later call gets the kept one back."""
    made = []

    class Made:
        def __init__(self, *args):
            self.busy = False
            made.append(self)

    monkeypatch.setattr(tvlm, "_Decoder", Made)
    tvlm.clear_decoders()
    lay = tvlm._Layout(1, 128, 8, 8, torch.float32, torch.float32, 4, (4, 8), False, False,
                       False)
    lm = {}
    with tvlm._decoder(lm, PCFG, lay, "cuda") as a:
        assert a.busy
        with tvlm._decoder(lm, PCFG, lay, "cuda") as b:
            assert b is not a
    with tvlm._decoder(lm, PCFG, lay, "cuda") as c:
        assert c is a
    assert not a.busy and not b.busy and len(made) == 2
    tvlm.clear_decoders()
