"""The port's paged KV cache (`memory_augmented_vlm_torch/models/paged.py`)
against JAX's `models/paged.py` on the CPU, fp32, on the tiny LM of
tests/test_batch_engine.py: each function on the same pool, tables and
inputs. Logits and the pool's values within 1e-5 (fp32 projections round
apart by an ulp), tokens, tables and lengths equal. Each case's writes
land on distinct (page, row) places, the trash page's included, so the
whole pool is compared: the prefill's pad page, a chunk's pad row and an
inactive slot's decode row go to the trash page."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import paged as jpaged
from memory_augmented_vlm_torch.models import paged as tpaged
from test_torch_serve_engine import (CFG, HID, LM, PCFG, PICKS, _decode_inputs, _t, embeds,
                                     jax_gumbel, tiny_params)

PS, NUM_PAGES, MAX_LEN = 4, 9, 16  # 4 pages a slot; page 9 is the trash page


@pytest.fixture(scope="module")
def tiny():
    return tiny_params()


def _pools(tables, lengths, seed):
    """The same random pool, tables and lengths for both packages."""
    rng = np.random.default_rng(seed)
    shape = (LM.num_hidden_layers, NUM_PAGES + 1, PS, LM.num_key_value_heads, LM.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.asarray(tables, np.int32)
    length = np.asarray(lengths, np.int32)
    jc = jpaged.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), table=jnp.asarray(table),
                             length=jnp.asarray(length))
    tc = tpaged.PagedKVCache(*(torch.from_numpy(a.copy()) for a in (k, v, table, length)))
    return jc, tc


def assert_pool_equal(tc, jc):
    for name, got, want in zip(["k", "v", "table", "length"], tc, jc):
        got, want = got.numpy(), np.asarray(want)
        if name in ("k", "v"):
            np.testing.assert_allclose(got, want, err_msg=name, **HID)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static), static_argnames=("cfg",))


T = NUM_PAGES  # the trash page's id
TABLES = [[0, 1, T, T], [3, 6, T, T], [8, 2, 5, T]]


def test_zeros_matches_jax():
    jc = jpaged.PagedKVCache.zeros(LM, 3, MAX_LEN, page_size=PS, num_pages=NUM_PAGES,
                                   dtype=jnp.float32)
    tc = tpaged.PagedKVCache.zeros(PCFG.lm, 3, MAX_LEN, page_size=PS, num_pages=NUM_PAGES,
                                   device="cpu", dtype=torch.float32)
    assert_pool_equal(tc, jc)
    assert (tc.page_size, tc.trash, tc.max_pages) == (PS, T, 4)
    with pytest.raises(ValueError, match="multiple"):
        tpaged.PagedKVCache.zeros(PCFG.lm, 3, 15, page_size=PS, num_pages=NUM_PAGES,
                                  device="cpu")


def test_prefill_into_pages_matches_jax(tiny):
    """9 valid tokens padded to 4 pages into slot 1: pages 7, 4, 0 and the
    trash page for the pad page; the slot's table row and length set."""
    jp, tp = tiny
    jc, tc = _pools(TABLES, [4, 6, 9], seed=1)
    emb = np.zeros((1, 16, LM.hidden_size), np.float32)
    emb[0, :9] = embeds(tp, np.arange(200, 209))
    pages = np.array([7, 4, 0, T], np.int32)
    jl, jc = _jit(jpaged.prefill_into_pages, rope_seq_len=MAX_LEN)(
        jp, CFG, jnp.asarray(emb), jnp.asarray([9], jnp.int32), jnp.asarray(pages), 1, jc)
    tl, tc = tpaged.prefill_into_pages(tp, PCFG, torch.from_numpy(emb),
                                       torch.tensor([9], dtype=torch.int32),
                                       torch.from_numpy(pages), 1, tc, rope_seq_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_pool_equal(tc, jc)
    assert tc.table[1].tolist() == [7, 4, 0, T] and int(tc.length[1]) == 9


def test_chunk_into_pages_matches_jax(tiny):
    """Slot 1 (pages 3, 6): a full chunk at offset 1, then a last one at
    offset 5 with 3 valid rows, whose pad row at position 8 maps to the
    trash page."""
    jp, tp = tiny
    jc, tc = _pools(TABLES, [4, 1, 9], seed=2)
    fn = _jit(jpaged.chunk_into_pages, rope_seq_len=MAX_LEN)
    rng = np.random.default_rng(3)
    for off, cv in ((1, 4), (5, 3)):
        chunk = (0.5 * rng.standard_normal((1, 4, LM.hidden_size))).astype(np.float32)
        chunk[0, cv:] = 0
        jl, jc = fn(jp, CFG, jnp.asarray(chunk), off, cv, 1, jc)
        tl, tc = tpaged.chunk_into_pages(tp, PCFG, torch.from_numpy(chunk), off, cv, 1, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
        assert_pool_equal(tc, jc)
    assert tc.length.tolist() == [4, 8, 9]


@pytest.mark.parametrize("pick", list(PICKS))
def test_decode_step_paged_matches_jax(tiny, pick):
    """One tick over three slots; slot 1 is inactive at length 16 = max_len
    (its write goes to the trash page, row 0, and its length stays), slot
    2 crosses into its third page."""
    jp, tp = tiny
    temps, top_ps = (np.asarray(x, np.float32) for x in PICKS[pick])
    logits, active = _decode_inputs(4)
    jc, tc = _pools(TABLES, [6, 16, 8], seed=5)
    key = jax.random.key(13)
    jt, jl, jc = _jit(jpaged.decode_step_paged, rope_seq_len=MAX_LEN)(
        jp, CFG, jnp.asarray(logits), jc, jnp.asarray(active), jnp.asarray(temps),
        jnp.asarray(top_ps), key)
    noise = _t(jax_gumbel(key, logits.shape)) if temps[active].max() > 0 else None
    trash_before = tc.k[:, T].clone()
    tt, tl, tc = tpaged.decode_step_paged(tp, PCFG, _t(logits), tc, _t(active), _t(temps),
                                          _t(top_ps), noise, bool(top_ps.min() < 1.0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_pool_equal(tc, jc)
    assert tc.length.tolist() == [7, 16, 9] and int(tt[1]) == 0
    assert not torch.equal(tc.k[:, T, 0], trash_before[:, 0])
    assert torch.equal(tc.k[:, T, 1:], trash_before[:, 1:])


def test_decode_multi_step_paged_matches_jax(tiny):
    """Three dependent steps, each sampled row drawing from its step's split
    of the key; slot 0 crosses from its second page into its third."""
    jp, tp = tiny
    temps, top_ps = (np.asarray(x, np.float32) for x in PICKS["top_p"])
    logits, active = _decode_inputs(6)
    tables = [[0, 1, 4, T], [3, 6, T, T], [8, 2, 5, T]]
    jc, tc = _pools(tables, [7, 3, 9], seed=7)
    key = jax.random.key(14)
    jt, jl, jc = _jit(jpaged.decode_multi_step_paged, steps=3, rope_seq_len=MAX_LEN)(
        jp, CFG, jnp.asarray(logits), jc, jnp.asarray(active), jnp.asarray(temps),
        jnp.asarray(top_ps), key)
    noise = np.stack([jax_gumbel(k, logits.shape) for k in jax.random.split(key, 3)])
    tt, tl, tc = tpaged.decode_multi_step_paged(tp, PCFG, _t(logits), tc, _t(active),
                                                _t(temps), _t(top_ps), _t(noise), True, steps=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HID)
    assert_pool_equal(tc, jc)


def test_prefix_page_writes_match_jax():
    """A prefix's two whole pages into pages 4 and 1, then a partial last
    page of 3 rows copied into page 5 (rows 0-2; row 3 untouched)."""
    jc, tc = _pools(TABLES, [4, 6, 9], seed=8)
    rng = np.random.default_rng(9)
    shape = (LM.num_hidden_layers, 2 * PS, LM.num_key_value_heads, LM.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pages = np.array([4, 1], np.int32)
    jc = jax.jit(jpaged.write_prefix_pages)(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
                                            jc)
    tc = tpaged.write_prefix_pages(_t(k), _t(v), _t(pages), tc)
    assert_pool_equal(tc, jc)
    rk, rv = k[:, :3], v[:, :3]
    jc = jax.jit(jpaged.write_partial_page)(jnp.asarray(rk), jnp.asarray(rv), 5, jc)
    tc = tpaged.write_partial_page(_t(rk), _t(rv), 5, tc)
    assert_pool_equal(tc, jc)
    np.testing.assert_array_equal(tc.k[:, 5, :3].numpy(), rk)
