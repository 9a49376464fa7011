"""The port's continuous-batching engine (`memory_augmented_vlm_torch/serve/
batch_engine.py`) against the JAX package on the CPU, fp32, on the tiny LM
of tests/test_batch_engine.py (vocab 50,000, hidden 32, 2 layers, 4 heads
over 2 KV heads of 8), the same weights on both sides.

- `qwen2.decode_step` at the cache's bound: JAX drops the write of a row
  whose length reached Smax when B > 1 and clamps it onto Smax - 1 when
  B = 1; the port does the same (it raised before).
- Each device function of the engine against JAX's on the same inputs:
  hidden, logits, fp32 K/V and int8 scales within 1e-5; tokens, int8
  codes and lengths equal. Sampling takes JAX's Gumbel
  draws as `noise`. The speculative step is held to JAX's recomputed with
  the final norm, which JAX's `decode_chunk_batched` leaves out.
- Every case of tests/test_batch_engine.py, the repeats merged into
  parametrised cases: the greedy engine's tokens equal the port's
  `vlm.generate` (itself held to JAX's), exactly.
- The engine against JAX's engine: equal greedy tokens with slot recycling,
  and over an oversubscribed paged pool that preempts.

Every wait is bounded and every engine shut down in `finally`.
"""

import contextlib
import functools
import logging
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.config import LMConfig, VLMConfig
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.serve import batch_engine as jbe
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import vlm as tvlm
from memory_augmented_vlm_torch.serve import batch_engine as tbe

LM = LMConfig(vocab_size=50000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=8, rope_theta=10000.0,
              dtype="float32")
CFG = VLMConfig(lm=LM)
PCFG = convert.config_from_fields(CFG)
EOS = (49999,)
HID = dict(rtol=1e-5, atol=1e-5)
WAIT = 120  # seconds a test waits for one engine output


def lm_to_torch(jlm):
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jlm["layers"])
              for i in range(LM.num_hidden_layers)]
    return convert._tree({**jax.tree.map(np.asarray, jlm), "layers": layers}, "cpu", None)


@functools.lru_cache(maxsize=1)
def tiny_params():
    """(JAX params, port params) of the tiny LM, JAX's init under one jit."""
    jlm = jax.jit(functools.partial(jqwen2.init_params, LM))(jax.random.key(0))
    jlm = jax.tree.map(np.asarray, jlm)
    return {"language_model": jlm}, {"language_model": lm_to_torch(jlm)}


@pytest.fixture(scope="module")
def tiny():
    return tiny_params()


def embeds(tp, ids) -> np.ndarray:
    return tp["language_model"]["embed_tokens"][torch.as_tensor(np.asarray(ids))].numpy()


def reference(tp, ids, n, **kw) -> np.ndarray:
    """The port's single-request greedy decode (held to JAX's elsewhere)."""
    out = tvlm.generate(tp, PCFG, torch.from_numpy(embeds(tp, ids)), max_new_tokens=n,
                        eos_token_ids=EOS, pad_to_multiple=128, **kw)
    return out.tokens[:int(out.num_tokens)].numpy()


def collect(out) -> np.ndarray:
    toks = []
    while True:
        item = out.get(timeout=WAIT)
        if item is None:
            return np.concatenate(toks) if toks else np.zeros((0,), np.int32)
        toks.append(item)


@contextlib.contextmanager
def running(engine):
    engine.start()
    try:
        yield engine
    finally:
        engine.shutdown()
        assert not engine._thread.is_alive()


@contextlib.contextmanager
def errors_logged():
    """The engine's log records at ERROR or above while the block runs."""
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = records.append
    log = logging.getLogger("batch_engine")
    log.addHandler(handler)
    try:
        yield records
    finally:
        log.removeHandler(handler)


def serve(engine, tp, prompts, pause_after=(), **kw):
    """Submit every prompt (pausing 50 ms after the indices in
    `pause_after`, so later admissions meet slots mid-decode) and collect
    each request's tokens. Per-request keywords come as lists."""
    outs = []
    for i, ids in enumerate(prompts):
        req_kw = {k: (v[i] if isinstance(v, list) else v) for k, v in kw.items()}
        outs.append(engine.submit(embeds(tp, ids), **req_kw))
        if i in pause_after:
            time.sleep(0.05)
    return [collect(o) for o in outs]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=(n,)) for n in lengths]


# ------------------------------------------------ qwen2.decode_step at its bound

def _random_caches(kind, b, smax, lengths, seed):
    """The same random cache for both packages: fp32 or bf16 values, or
    int8 codes with fp32 scales, (L, B, Smax, Hkv, Dh)."""
    rng = np.random.default_rng(seed)
    shape = (LM.num_hidden_layers, b, smax, LM.num_key_value_heads, LM.head_dim)
    length = np.asarray(lengths, np.int32)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 2e-2, shape[:-1]).astype(np.float32) for _ in range(2))
        jc = jqwen2.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(length),
                            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tc = tqwen2.KVCache(*(torch.from_numpy(a.copy()) for a in (k, v, length, ks, vs)))
        return jc, tc
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.float32, torch.float32) if kind == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jc = jqwen2.KVCache(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt),
                        length=jnp.asarray(length), k_scale=None, v_scale=None)
    tc = tqwen2.KVCache(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                        torch.from_numpy(length))
    return jc, tc


def assert_cache_equal(tcache, jcache):
    """Lengths and int8 codes equal; fp32 K/V and int8 scales within the
    hidden states' 1e-5 (the two packages' fp32 projections round a value,
    or a row's max, apart by an ulp)."""
    for name, got, want in zip(["k", "v", "length", "k_scale", "v_scale"], tcache, jcache):
        if want is None:
            assert got is None, name
            continue
        exact = got.dtype in (torch.int8, torch.int32)
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **HID)


@pytest.mark.parametrize("b", [1, 2], ids=["b1_clamps", "b2_drops"])
@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_decode_step_at_the_cache_bound_matches_jax(tiny, kind, b):
    """Row 0 is at the bound (length Smax); at B = 2 row 1 is inside. JAX
    drops row 0's write at B = 2 and clamps it onto Smax - 1 at B = 1; the
    port raised an IndexError here before. An fp32 cache: JAX's B = 1 write
    takes the activations' dtype only."""
    jp, tp = tiny
    smax = 12
    lengths = [smax, 5][:b]
    jc, tc = _random_caches(kind, b, smax, lengths, seed=1)
    emb = (0.5 * np.random.default_rng(2).standard_normal((b, 1, LM.hidden_size))
           ).astype(np.float32)
    jh, jc = jqwen2.decode_step(jp["language_model"], LM, jnp.asarray(emb), jc)
    before = tc.k.clone()
    th, tc = tqwen2.decode_step(tp["language_model"], PCFG.lm, torch.from_numpy(emb), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HID)
    assert_cache_equal(tc, jc)
    assert tc.length.tolist() == [smax + 1, 6][:b]
    if b == 2:
        assert torch.equal(tc.k[:, 0], before[:, 0])  # row 0 wrote nothing
    else:
        assert not torch.equal(tc.k[:, 0, -1], before[:, 0, -1])  # clamped onto Smax - 1


# ------------------------------------------------------ device functions vs JAX

def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static), static_argnames=("cfg",))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_prefill_into_slot_matches_jax(tiny, kind):
    """A 7-token prompt padded to 8 into slot 1 of 3: logits, and the whole
    slot row written (zeros past the pad, quantized for int8)."""
    jp, tp = tiny
    smax = 16
    jc, tc = _random_caches(kind, 3, smax, [4, 9, 2], seed=3)
    emb = np.zeros((1, 8, LM.hidden_size), np.float32)
    emb[0, :7] = embeds(tp, np.arange(100, 107))
    jl, jc = _jit(jbe._prefill_into_slot, max_len=smax)(
        jp, CFG, jnp.asarray(emb), jnp.asarray([7], jnp.int32), 1, jc)
    tl, tc = tbe._prefill_into_slot(tp, PCFG, torch.from_numpy(emb),
                                    torch.tensor([7], dtype=torch.int32), 1, tc, max_len=smax)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_cache_equal(tc, jc)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_prefill_chunk_into_slot_matches_jax(tiny, kind):
    """Two chunks of slot 2: a full one at offset 3 and a last partial one
    (2 valid rows of 4) at offset 7."""
    jp, tp = tiny
    smax = 16
    jc, tc = _random_caches(kind, 3, smax, [4, 9, 3], seed=4)
    fn = _jit(jbe._prefill_chunk_into_slot, max_len=smax)
    rng = np.random.default_rng(5)
    for off, cv in ((3, 4), (7, 2)):
        chunk = (0.5 * rng.standard_normal((1, 4, LM.hidden_size))).astype(np.float32)
        chunk[0, cv:] = 0
        jl, jc = fn(jp, CFG, jnp.asarray(chunk), off, cv, 2, jc)
        tl, tc = tbe._prefill_chunk_into_slot(tp, PCFG, torch.from_numpy(chunk), off, cv, 2,
                                              tc, max_len=smax)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
        assert_cache_equal(tc, jc)


def jax_gumbel(key, shape):
    """The draws `jax.random.categorical(key, logits)` adds to the logits."""
    return np.asarray(jax.random.gumbel(key, shape, jnp.float32))


def _decode_inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((b, LM.vocab_size))).astype(np.float32)
    return logits, np.array([True, False, True][:b])


# (temperatures, top_p): greedy; sampled; sampled with top-p on one row
PICKS = {"greedy": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
         "sampled": ([0.7, 0.9, 1.3], [1.0, 1.0, 1.0]),
         "top_p": ([0.7, 0.0, 1.3], [0.9, 1.0, 1.0])}


@pytest.mark.parametrize("pick", list(PICKS))
@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_decode_step_matches_jax(tiny, kind, pick):
    """One tick over three slots (slot 1 inactive: it picks 0 and decodes
    garbage into its own row) from given logits: tokens, next logits and
    cache; sampling with JAX's draws for its key."""
    jp, tp = tiny
    temps, top_ps = (np.asarray(x, np.float32) for x in PICKS[pick])
    logits, active = _decode_inputs(6)
    jc, tc = _random_caches(kind, 3, 16, [5, 16, 9], seed=7)
    key = jax.random.key(11)
    jt, jl, jc = jax.jit(jbe._decode_step, static_argnames=("cfg",))(
        jp, CFG, jnp.asarray(logits), jc, jnp.asarray(active), jnp.asarray(temps),
        jnp.asarray(top_ps), key)
    noise = _t(jax_gumbel(key, logits.shape)) if temps[active].max() > 0 else None
    tt, tl, tc = tbe._decode_step(tp, PCFG, _t(logits), tc, _t(active), _t(temps), _t(top_ps),
                                  noise, bool(top_ps.min() < 1.0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_cache_equal(tc, jc)
    if pick != "greedy":  # a sampled token is not the argmax somewhere
        assert (tt.numpy()[active] != logits.argmax(-1)[active]).any()


def test_decode_multi_step_matches_jax(tiny):
    """Four dependent steps in one call, each sampled row drawing from its
    step's split of the key (JAX's `jax.random.split(rng, steps)`)."""
    jp, tp = tiny
    temps, top_ps = (np.asarray(x, np.float32) for x in PICKS["top_p"])
    logits, active = _decode_inputs(8)
    jc, tc = _random_caches("float32", 3, 16, [5, 2, 9], seed=9)
    key = jax.random.key(12)
    jt, jl, jc = _jit(jbe._decode_multi_step, steps=4)(
        jp, CFG, jnp.asarray(logits), jc, jnp.asarray(active), jnp.asarray(temps),
        jnp.asarray(top_ps), key)
    noise = np.stack([jax_gumbel(k, logits.shape) for k in jax.random.split(key, 4)])
    tt, tl, tc = tbe._decode_multi_step(tp, PCFG, _t(logits), tc, _t(active), _t(temps),
                                        _t(top_ps), _t(noise), True, steps=4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_cache_equal(tc, jc)


def _jax_verify_with_norm(params, cfg, logits, drafts, cache, active, *, max_len):
    """JAX's `_spec_verify_step` with the final norm before the unembedding
    (JAX's `decode_chunk_batched` leaves it out; the port's applies it)."""
    lm = params["language_model"]
    g0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    chunk_toks = jnp.concatenate([g0[:, None], drafts], axis=1)
    starts = jnp.where(active, cache.length, max_len)
    emb = jqwen2.embed_tokens(lm, chunk_toks, cfg.lm).astype(jnp.float32)
    hidden, cache = jqwen2.decode_chunk_batched(lm, cfg.lm, emb, cache, starts,
                                                rope_seq_len=max_len)
    logits_all = jqwen2.unembed(lm, cfg.lm, jqwen2._norm(hidden, lm["norm"], cfg.lm))
    preds = jnp.argmax(logits_all, axis=-1).astype(jnp.int32)
    acc = jnp.cumprod((preds[:, :-1] == chunk_toks[:, 1:]).astype(jnp.int32), axis=1)
    n_acc = jnp.sum(acc, axis=1)
    next_logits = jnp.take_along_axis(logits_all, n_acc[:, None, None], axis=1)[:, 0]
    length = jnp.where(active, cache.length + 1 + n_acc, cache.length)
    packed = jnp.concatenate([n_acc[:, None], chunk_toks], axis=1)
    return packed, next_logits, cache._replace(length=length), preds


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_spec_verify_step_matches_jax_with_the_norm(tiny, kind):
    """Row 0's drafts are the chunk's own predictions (all 3 accepted), row
    1's first draft only (1 accepted), row 2 inactive (parked at the bound:
    writes nothing, length kept)."""
    jp, tp = tiny
    smax = 24
    logits, _ = _decode_inputs(10)
    active = np.array([True, True, False])
    fn = jax.jit(functools.partial(_jax_verify_with_norm, max_len=smax),
                 static_argnames=("cfg",))
    drafts = np.zeros((3, 3), np.int32)
    for _ in range(3):  # row 0's drafts become the chunk's own predictions
        jc, _ = _random_caches(kind, 3, smax, [6, 11, 4], seed=13)
        preds = np.asarray(fn(jp, CFG, jnp.asarray(logits), jnp.asarray(drafts), jc,
                              jnp.asarray(active))[3])
        drafts[0] = preds[0, :3]
    drafts[1] = [preds[1, 0], (preds[1, 1] + 1) % LM.vocab_size, 0]
    jc, tc = _random_caches(kind, 3, smax, [6, 11, 4], seed=13)
    jpk, jl, jc, _ = fn(jp, CFG, jnp.asarray(logits), jnp.asarray(drafts), jc,
                        jnp.asarray(active))
    tpk, tl, tc = tbe._spec_verify_step(tp, PCFG, _t(logits), _t(drafts), tc, _t(active),
                                        max_len=smax)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    assert tpk[:2, 0].tolist() == [3, 1]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_cache_equal(tc, jc)


# ---------------------------------------------- the engine against the reference

# JAX's concurrent cases, one parametrised test: (engine keywords, prompt
# lengths, new tokens, prompt seed, pause after these submissions)
CONCURRENT = {
    # 4 requests over 3 slots: a slot is recycled
    "plain": (dict(num_slots=3), (4, 7, 3, 5), 8, 0, (1,)),
    # the int8 slot cache gives the float cache's greedy tokens
    "kv_int8": (dict(num_slots=2, kv_int8=True), (5, 3, 6), 8, 7, (0,)),
    # 20 and 25 tokens take 3-4 chunks, 5 the one-shot path
    "chunked": (dict(num_slots=2, chunk_prefill=8), (20, 25, 5), 8, 9, (0, 1, 2)),
    "chunked_int8": (dict(num_slots=2, chunk_prefill=8, kv_int8=True), (20, 25, 5), 8, 9,
                     (0, 1, 2)),
    # max_new_tokens 7 and 9 are not multiples of K = 4
    "multi_tick": (dict(num_slots=2, decode_ticks=4), (5, 3, 6), [10, 7, 9], 3, (0,)),
    # batched prompt-lookup verification: the plain engine's greedy tokens
    "speculative": (dict(num_slots=2, speculative=4), (6, 4, 7), 10, 43, (0,)),
    "speculative_int8": (dict(num_slots=2, speculative=4, kv_int8=True), (6, 4, 7), 10, 43,
                         (0,)),
    # the paged pool; every page back on the free list at the end
    "paged": (dict(num_slots=2, paged_page_size=64), (5, 3, 6), 8, 21, (0,)),
    "paged_chunked": (dict(num_slots=2, chunk_prefill=8, paged_page_size=32), (20, 25, 5), 8,
                      23, (0, 1, 2)),
}


@pytest.mark.parametrize("mode", list(CONCURRENT))
def test_concurrent_greedy_matches_reference(tiny, mode):
    jp, tp = tiny
    kw, lengths, new, seed, pauses = CONCURRENT[mode]
    prompts = _prompts(seed, lengths)
    news = new if isinstance(new, list) else [new] * len(prompts)
    want = [reference(tp, p, n) for p, n in zip(prompts, news)]
    with running(tbe.BatchEngine(tp, PCFG, max_len=256, **kw)) as engine:
        extra = {"draft_ids": list(prompts)} if "speculative" in kw else {}
        got = serve(engine, tp, prompts, pauses, max_new_tokens=news, eos_token_ids=EOS,
                    **extra)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        if engine.paged:
            assert len(engine._free) == engine.num_pages
        if kw.get("kv_int8"):
            assert engine._cache.k.dtype == torch.int8 and engine._cache.k_scale is not None


def test_eos_frees_slot_for_queued_request(tiny):
    jp, tp = tiny
    a, b = _prompts(1, (4, 6))
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=256)) as engine:
        for ids in (a, b):
            got = collect(engine.submit(embeds(tp, ids), max_new_tokens=5, eos_token_ids=EOS))
            np.testing.assert_array_equal(got, reference(tp, ids, 5))


@pytest.mark.parametrize("paged", [0, 16], ids=["contiguous", "paged"])
def test_top_p_zero_keeps_top_token(tiny, paged):
    """top_p ~ 0 restricts a sampled row to its argmax (min_tokens_to_keep
    = 1). Paged: decode_ticks = 4, and 21 tokens cross a 16-row page
    boundary mid-run and are not a multiple of K (the trailing in-graph
    tokens are discarded)."""
    jp, tp = tiny
    (ids,) = _prompts(25 if paged else 4, (5,))
    kw = dict(paged_page_size=16, decode_ticks=4) if paged else {}
    with running(tbe.BatchEngine(tp, PCFG, num_slots=2 if paged else 1,
                                 max_len=256 if paged else 128, **kw)) as engine:
        want = reference(tp, ids, 21 if paged else 6)
        if paged:
            np.testing.assert_array_equal(
                collect(engine.submit(embeds(tp, ids), max_new_tokens=21, eos_token_ids=EOS)),
                want)
        sampled = collect(engine.submit(embeds(tp, ids), max_new_tokens=6, eos_token_ids=EOS,
                                        temperature=0.8, top_p=1e-6))
        np.testing.assert_array_equal(sampled, want[:6])
        if paged:
            assert len(engine._free) == engine.num_pages


def test_engine_stop_sequences(tiny):
    jp, tp = tiny
    (ids,) = _prompts(5, (4,))
    full = reference(tp, ids, 8)
    assert len(full) >= 3
    stop = tuple(int(t) for t in full[1:3])
    want = reference(tp, ids, 8, stop_sequences=(stop,))
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=128)) as engine:
        got = collect(engine.submit(embeds(tp, ids), max_new_tokens=8, eos_token_ids=EOS,
                                    stop_sequences=(stop,)))
    np.testing.assert_array_equal(got, want)
    assert len(want) < len(full)  # the stop truncated


def test_quantize_kv_rows_matches_jax():
    """Per-row symmetric int8: JAX's codes and scales, and a dequantization
    error within half a step."""
    x = np.random.default_rng(3).standard_normal((2, 4, 3, 16)).astype(np.float32)
    q, s = tqwen2.quantize_kv_rows(torch.from_numpy(x))
    jq, js = jqwen2.quantize_kv_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert q.dtype == torch.int8 and s.shape == x.shape[:-1]
    err = np.abs(q.numpy().astype(np.float32) * s.numpy()[..., None] - x)
    assert err.max() <= s.numpy().max() * 0.51


@pytest.mark.parametrize("chunk,kv_int8,paged_pages,plen", [
    (0, False, 0, 11), (8, False, 0, 11), (8, True, 0, 11), (0, False, 40, 16),
    (0, False, 40, 11)], ids=["oneshot", "chunked", "chunked-int8", "paged-page-aligned",
                              "paged-cow"])
def test_prefix_caching_matches_full_prompt(tiny, chunk, kv_int8, paged_pages, plen):
    """set_prefix + use_prefix: the shared prefix's K/V computed once, the
    suffix prefilled at offset P, the full prompt's greedy tokens. Paged:
    the prefix's whole pages are shared and stay held; a partial last page
    is copied per request, and every private page comes back."""
    jp, tp = tiny
    rng = np.random.default_rng(24 if paged_pages else 13)
    prefix = rng.integers(0, 1000, size=(plen,))
    kw = dict(paged_page_size=8, paged_pages=paged_pages) if paged_pages else {}
    with running(tbe.BatchEngine(tp, PCFG, num_slots=2, max_len=256, chunk_prefill=chunk,
                                 kv_int8=kv_int8, **kw)) as engine:
        engine.set_prefix(embeds(tp, prefix))
        shared = plen // 8
        if paged_pages:
            assert len(engine._free) == paged_pages - shared
        for suf in [rng.integers(0, 1000, size=(n,)) for n in (7, 18)]:
            got = collect(engine.submit(embeds(tp, suf), max_new_tokens=6, eos_token_ids=EOS,
                                        use_prefix=True))
            np.testing.assert_array_equal(got, reference(tp, np.concatenate([prefix, suf]), 6))
        if paged_pages:
            assert len(engine._free) == paged_pages - shared
        plain = rng.integers(0, 1000, size=(5,))  # requests without the prefix beside them
        np.testing.assert_array_equal(
            collect(engine.submit(embeds(tp, plain), max_new_tokens=6, eos_token_ids=EOS)),
            reference(tp, plain, 6))


def test_chunked_prefill_near_max_len(tiny):
    """The last chunk of a prompt near max_len is capped at max_len - off
    (a padded window would clamp backwards over valid rows): chunks at 0,
    16, 32 (8 wide); with a 5-token prefix, chunks at 5, 13, 21, 29, the
    last 3 wide."""
    jp, tp = tiny
    rng = np.random.default_rng(33)
    ids = rng.integers(0, 1000, size=(39,))
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=40,
                                 chunk_prefill=16)) as engine:
        got = collect(engine.submit(embeds(tp, ids), max_new_tokens=1, eos_token_ids=EOS))
        np.testing.assert_array_equal(got, reference(tp, ids, 1))
    prefix, suffix = rng.integers(0, 1000, size=(5,)), rng.integers(0, 1000, size=(26,))
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=32,
                                 chunk_prefill=8)) as engine:
        engine.set_prefix(embeds(tp, prefix))
        got = collect(engine.submit(embeds(tp, suffix), max_new_tokens=1, eos_token_ids=EOS,
                                    use_prefix=True))
        np.testing.assert_array_equal(got, reference(tp, np.concatenate([prefix, suffix]), 1))


def test_empty_suffix_rejected(tiny):
    """An empty suffix (and any empty prompt) gets the sentinel alone; the
    engine serves on."""
    jp, tp = tiny
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=64,
                                 chunk_prefill=8)) as engine:
        engine.set_prefix(embeds(tp, [3, 5, 7]))
        empty = np.zeros((0, LM.hidden_size), np.float32)
        for use_prefix in (True, False):
            out = engine.submit(empty, max_new_tokens=3, use_prefix=use_prefix,
                                eos_token_ids=EOS)
            assert collect(out).shape == (0,)
        ids = np.array([4, 9, 2])
        np.testing.assert_array_equal(
            collect(engine.submit(embeds(tp, ids), max_new_tokens=3, eos_token_ids=EOS)),
            reference(tp, ids, 3))


def test_engine_speculative_sampled_falls_back(tiny):
    """A sampled request in the pool forces plain ticks; the greedy one
    beside it keeps the reference's tokens."""
    jp, tp = tiny
    rng = np.random.default_rng(47)
    greedy_ids, sampled_ids = rng.integers(0, 1000, size=(5,)), rng.integers(0, 1000, size=(4,))
    with running(tbe.BatchEngine(tp, PCFG, num_slots=2, max_len=128,
                                 speculative=4)) as engine:
        got_g, got_s = serve(engine, tp, [greedy_ids, sampled_ids], max_new_tokens=6,
                             eos_token_ids=EOS, temperature=[0.0, 0.9],
                             draft_ids=[greedy_ids, sampled_ids])
    np.testing.assert_array_equal(got_g, reference(tp, greedy_ids, 6))
    assert len(got_s) == 6


@pytest.mark.parametrize("case", ["engages", "no_lookup_hit", "cooldown"])
def test_engine_speculation_stats(tiny, case):
    """engages: on a model whose greedy output repeats, more tokens than LM
    forwards. no_lookup_hit: unique bigrams and 4 new tokens, so no lookup
    can hit: no verify forward, 4 plain ones. cooldown: a repeated bigram
    whose continuation the model does not emit: speculation engages but
    accepts nothing, and the backoff keeps verify forwards to a minority."""
    jp, tp = tiny
    ids, new = {"engages": (_prompts(53, (5,))[0], 16),
                "no_lookup_hit": (np.arange(100, 108), 4),
                "cooldown": (np.array([7, 8, 101, 102, 7, 8, 103, 104, 7, 8]), 16)}[case]
    with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=256 if case == "cooldown"
                                 else 128, speculative=4)) as engine:
        got = collect(engine.submit(embeds(tp, ids), max_new_tokens=new, eos_token_ids=EOS,
                                    draft_ids=ids))
        st = engine.stats
    np.testing.assert_array_equal(got, reference(tp, ids, new))
    if case == "engages":
        assert len(got) == 16 and st["spec_forwards"] > 0
        assert st["tokens"] > st["decode_forwards"], st
    elif case == "no_lookup_hit":
        assert st["spec_forwards"] == 0 and st["decode_forwards"] == 4, st
    else:
        assert st["spec_forwards"] >= 1, st
        if st["tokens"] == st["decode_forwards"]:  # nothing accepted
            assert st["spec_forwards"] * 2 <= st["decode_forwards"], st


def test_multi_tick_eos_and_kv_int8(tiny):
    """A slot that hits eos mid-multi-tick emits exactly the tokens of a
    one-token-tick engine (the in-graph continuation past eos is
    discarded), with the int8 KV cache."""
    jp, tp = tiny
    ids = np.random.default_rng(4).integers(0, 1000, size=(5,))
    want = reference(tp, ids, 24)
    eos = int(want[7]) if len(want) > 7 else 49999  # an early stop
    results = []
    for ticks in (5, 1):
        with running(tbe.BatchEngine(tp, PCFG, num_slots=1, max_len=256, decode_ticks=ticks,
                                     kv_int8=True)) as engine:
            results.append(collect(engine.submit(embeds(tp, ids), max_new_tokens=24,
                                                 eos_token_ids=(49999, eos))))
    np.testing.assert_array_equal(results[0], results[1])
    if len(want) > 7:
        assert int(results[0][-1]) == eos and len(results[0]) <= 9


def test_paged_oversubscribed_pool_preempts_exact(tiny):
    """A pool below the slots' combined worst case (2 slots x
    ceil(155 / 16) = 10 pages > 18) preempts under growth, and the greedy
    tokens are an uninterrupted run's."""
    jp, tp = tiny
    prompts = _prompts(22, (5, 3, 6))
    want = [reference(tp, p, 150) for p in prompts]
    with running(tbe.BatchEngine(tp, PCFG, num_slots=2, max_len=256, paged_page_size=16,
                                 paged_pages=18)) as engine:
        got = serve(engine, tp, prompts, max_new_tokens=150, eos_token_ids=EOS)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert engine.stats["preemptions"] >= 1
        assert len(engine._free) == engine.num_pages


@pytest.mark.parametrize("kw,match", [
    (dict(paged_page_size=16, kv_int8=True), "kv_int8"),
    (dict(paged_page_size=16, speculative=4), "speculative"),
    (dict(max_len=100, paged_page_size=16), "multiple"),
    (dict(max_len=256, paged_page_size=16, paged_pages=8), "worst case"),
    (dict(decode_ticks=0), "decode_ticks"),
    (dict(speculative=1), "speculative")])
def test_config_validation(tiny, kw, match):
    jp, tp = tiny
    with pytest.raises(ValueError, match=match):
        tbe.BatchEngine(tp, PCFG, **kw)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8kv"])
def test_idle_slot_past_max_len(tiny, kv_int8):
    """Requests one at a time on 2 slots: slot 1 never gets one, and its
    length grows by one a tick (JAX's decode over the whole pool) past
    max_len = 32 within the 4 x 10 ticks. Its writes drop there, as JAX's
    do; the port's decode raised and dropped the request before. Every
    request keeps the reference's tokens and nothing is logged at ERROR."""
    jp, tp = tiny
    with errors_logged() as errors, running(tbe.BatchEngine(
            tp, PCFG, num_slots=2, max_len=32, kv_int8=kv_int8)) as engine:
        for ids in _prompts(61, (4, 6, 5, 4)):
            got = collect(engine.submit(embeds(tp, ids), max_new_tokens=10, eos_token_ids=EOS))
            np.testing.assert_array_equal(got, reference(tp, ids, 10))
        assert engine.stats["decode_rounds"] > 32 and engine._len[1] == 0
        assert int(engine._cache.length[1]) > 32
    assert not errors, [r.getMessage() for r in errors]


# ------------------------------------------------ the engine against JAX's engine

@contextlib.contextmanager
def _jax_engine(jp, **kw):
    engine = jbe.BatchEngine(jp, CFG, **kw).start()
    try:
        yield engine
    finally:
        engine.shutdown()


@pytest.mark.parametrize("mode", ["recycling", "paged_preempting"])
def test_engine_matches_jax_engine(tiny, mode):
    """The same requests through JAX's engine and the port's: equal greedy
    tokens; 4 requests over 3 slots, or an oversubscribed paged pool that
    preempts in both."""
    jp, tp = tiny
    if mode == "recycling":
        kw, prompts, new = dict(num_slots=3, max_len=256), _prompts(0, (4, 7, 3, 5)), 8
    else:  # two requests of 5 pages (66 positions) each over 8 pages
        kw, prompts, new = (dict(num_slots=2, max_len=128, paged_page_size=16, paged_pages=8),
                            _prompts(22, (5, 3, 6)), 60)
    with _jax_engine(jp, **kw) as jengine:
        want = serve(jengine, tp, prompts, max_new_tokens=new, eos_token_ids=EOS)
        jstats = dict(jengine.stats)
    with running(tbe.BatchEngine(tp, PCFG, **kw)) as engine:
        got = serve(engine, tp, prompts, max_new_tokens=new, eos_token_ids=EOS)
        stats = dict(engine.stats)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(w) == new
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    if mode == "paged_preempting":
        assert jstats["preemptions"] >= 1 and stats["preemptions"] >= 1
