"""The port's training attention (`ops/flash_bwd.py`) and the backward of its
forward kernel (`ops/flash.py`) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode with 128-row blocks,
at the shapes of tests/test_flash_bwd.py; the port runs the plain versions
of its CUDA kernels, which is what CPU tensors take. Same numpy inputs on
both sides. fp32 tolerances: the forward and lse to 2e-5 (the two sides
sum in another order), gradients to rtol 5e-4 / atol 5e-5 as in
tests/test_flash_bwd.py. The bf16 case is held to the bf16 class (one
bf16 step, 2^-8 relative, of the largest element).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from memory_augmented_vlm_tpu.ops import pallas_flash
from memory_augmented_vlm_tpu.ops.attention import repeat_kv
from memory_augmented_vlm_tpu.ops.pallas_flash_bwd import (_backward, _forward_with_lse,
                                                           flash_attention_train)
from memory_augmented_vlm_torch.ops import flash, flash_bwd

BLOCK = 128
CASES = [
    # (B, Sq, Skv, H, D, causal, valid)
    (1, 256, 256, 2, 64, True, None),
    (2, 384, 384, 2, 64, True, (300, 384)),      # padded rows + multi-batch
    (1, 256, 512, 2, 64, False, None),           # cross-attention
    (2, 128, 384, 3, 128, False, (200, 384)),    # cross + padding + D=128
]
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _inputs(case, seed=0, hkv=None):
    b, sq, skv, h, d, causal, valid = case
    rng = np.random.default_rng(seed + sum(case[:5]))
    q = (rng.standard_normal((b, sq, h, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv or h, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, skv, hkv or h, d)) * 0.3).astype(np.float32)
    vl = np.asarray(valid if valid else [skv] * b, np.int32)
    return q, k, v, vl


def _weights(shape):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32) / n).reshape(shape)


def _jax_grads(fn, q, k, v):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out.astype(jnp.float32) * _weights(out.shape))

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _torch_grads(fn, q, k, v, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    (out.float() * torch.from_numpy(_weights(tuple(out.shape)))).sum().backward()
    return out, [t.grad for t in ts]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", CASES)
def test_forward_with_lse_matches_pallas(case):
    b, sq, skv, h, d, causal, _ = case
    q, k, v, vl = _inputs(case)
    scale = d ** -0.5
    jout, jlse = _forward_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(vl), causal, scale, BLOCK, BLOCK, True)
    out, lse = flash_bwd.forward_with_lse(_t(q), _t(k), _t(v), _t(vl), causal=causal,
                                          scale=scale)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0, :sq], **OUT_TOL)


# (B, Sq, Skv, H, H_kv, causal, valid): causal GQA with a ragged batch;
# causal with a batch of valid length 0; cross attention with Sq != Skv and
# valid length 0; GQA with a prefix valid length
TILED_CASES = [
    (2, 200, 200, 4, 2, True, (200, 131)),
    (2, 150, 150, 2, 2, True, (0, 150)),
    (2, 130, 300, 2, 2, False, (300, 0)),
    (1, 257, 257, 6, 2, False, (100,)),
]


def _tiled_case(case, d, seed=14):
    b, sq, skv, h, hkv, causal, valid = case
    rng = np.random.default_rng(seed + d + sq)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return arrays, [torch.from_numpy(x).to(torch.bfloat16) for x in arrays]


@pytest.mark.parametrize("d", [64, 72, 112, 128])
@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_forward_with_lse_matches_pallas_interpret(d, case):
    """`forward_with_lse_reference(block_k=64)` is the function of
    `_forward_with_lse` at 64-row, 64-key blocks in bf16 (JAX repeats K/V
    for GQA): out bit for bit but for XLA's CPU rounding (the share of
    tests/test_torch_flash.py, TILED_MIN_SHARE; one bf16 step at most), lse
    to 1e-6 relative (the two sides sum l in another order) on its finite
    rows and -inf on the same rows."""
    from tests.test_torch_flash import TILED_MIN_SHARE

    b, sq, skv, h, hkv, causal, valid = case
    (q, k, v), (tq, tk, tv) = _tiled_case(case, d)
    g = h // hkv
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jout, jlse = _forward_with_lse(jq, repeat_kv(jk, g), repeat_kv(jv, g),
                                   jnp.asarray(valid, jnp.int32), causal, d ** -0.5, 64, 64, True)
    jout = np.asarray(jout.astype(jnp.float32))
    jlse = np.asarray(jlse)[:, :, 0, :sq]
    out, lse = flash_bwd.forward_with_lse_reference(
        tq, tk, tv, torch.tensor(valid, dtype=torch.int32), causal=causal, scale=d ** -0.5,
        kv_groups=g, block_k=64)
    out, lse = out.float().numpy(), lse.numpy()
    assert float((out == jout).mean()) >= TILED_MIN_SHARE
    assert np.abs(out - jout).max() <= 2.0 ** -7 * np.abs(jout).max()
    fin = np.isfinite(jlse)
    assert np.array_equal(np.isfinite(lse), fin) and (lse[~fin] < 0).all()
    np.testing.assert_allclose(lse[fin], jlse[fin], rtol=1e-6, atol=1e-6)


def _lse_control_case():
    case = (1, 512, 512, 4, 2, True, (500,))
    _, (q, k, v) = _tiled_case(case, 64, seed=15)
    vl = torch.tensor(case[-1], dtype=torch.int32)
    kw = dict(causal=True, scale=64 ** -0.5, kv_groups=2)
    return q, k, v, vl, kw


def test_chip_smoke_lse_controls_fail_its_check():
    """chip_smoke holds the lse of flash_fwd_lse to every element within
    1e-5 + 1e-5 |ref| of the tiled plain version on its finite rows. Its two
    controls fail that rule here too: the lse in natural-log units, and the
    online softmax with the causal diagonal moved by one key."""
    import chip_smoke

    q, k, v, vl, kw = _lse_control_case()
    _, lse = flash_bwd.forward_with_lse_reference(q, k, v, vl, block_k=64, **kw)
    fin = torch.isfinite(lse)
    _, moved = chip_smoke._online_variant(q, k, v, vl, causal=True, kv_groups=2, block_k=64,
                                          diagonal=1)
    for control in (lse * np.log(2.0), moved):
        assert chip_smoke._f32_close("control", control[fin], lse[fin])["outside"] > 0
    assert chip_smoke._f32_close("self", lse[fin].clone(), lse[fin])["outside"] == 0


def test_chip_smoke_lse_check_holds_the_tpu_kernel():
    """JAX's `_forward_with_lse` at 64-key blocks (interpret mode) passes
    the lse rule against the tiled plain version."""
    import chip_smoke

    q, k, v, vl, kw = _lse_control_case()
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    _, jlse = _forward_with_lse(jq, repeat_kv(jk, 2), repeat_kv(jv, 2), jnp.asarray(vl.numpy()),
                                True, kw["scale"], 64, 64, True)
    jlse = torch.from_numpy(np.array(jlse)[:, :, 0, :512])
    _, lse = flash_bwd.forward_with_lse_reference(q, k, v, vl, block_k=64, **kw)
    fin = torch.isfinite(lse)
    assert chip_smoke._f32_close("pallas", jlse[fin], lse[fin])["outside"] == 0


@pytest.mark.parametrize("case", CASES)
def test_backward_kernels_match_pallas_on_saved_residuals(case):
    """dQ and dK/dV from JAX's own (out, lse), on both sides."""
    b, sq, skv, h, d, causal, _ = case
    q, k, v, vl = _inputs(case, seed=1)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv, jvl = (jnp.asarray(x) for x in (q, k, v, vl))
    jout, jlse = _forward_with_lse(jq, jk, jv, jvl, causal, scale, BLOCK, BLOCK, True)
    want = _backward(jq, jk, jv, jout, jlse, jnp.asarray(g), jvl, causal, scale, BLOCK,
                     BLOCK, True)
    lse = _t(np.asarray(jlse)[:, :, 0, :sq]).contiguous()
    delta = flash_bwd.attention_delta(_t(jout), _t(g))
    kw = dict(causal=causal, scale=scale)
    dq = flash_bwd.backward_dq(_t(q), _t(k), _t(v), _t(g), lse, delta, _t(vl), **kw)
    dk, dv = flash_bwd.backward_dkv(_t(q), _t(k), _t(v), _t(g), lse, delta, _t(vl), **kw)
    for name, got, ref in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_train_grads_match_pallas(case):
    b, sq, skv, h, d, causal, _ = case
    q, k, v, vl = _inputs(case, seed=2)
    want = _jax_grads(lambda q, k, v: flash_attention_train(
        q, k, v, causal=causal, kv_valid_len=jnp.asarray(vl), block_q=BLOCK, block_k=BLOCK,
        interpret=True), q, k, v)
    _, got = _torch_grads(lambda q, k, v: flash_bwd.flash_attention_train(
        q, k, v, _t(vl), causal=causal), q, k, v)
    for name, a, ref in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=f"d{name}")


def test_gqa_grads_match_pallas_after_repeat_kv():
    """The port takes 2 KV heads for 6 query heads; JAX repeats K/V first,
    so its dK/dV arrive summed over each group."""
    case = (2, 256, 256, 6, 64, True, (256, 200))
    q, k, v, vl = _inputs(case, seed=3, hkv=2)
    want = _jax_grads(lambda q, k, v: flash_attention_train(
        q, repeat_kv(k, 3), repeat_kv(v, 3), causal=True, kv_valid_len=jnp.asarray(vl),
        block_q=BLOCK, block_k=BLOCK, interpret=True), q, k, v)
    _, got = _torch_grads(lambda q, k, v: flash_bwd.flash_attention_train(
        q, k, v, _t(vl), causal=True, kv_groups=3), q, k, v)
    assert got[1].shape == k.shape
    for name, a, ref in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=f"d{name}")


def test_bf16_grads_match_pallas_to_the_bf16_class():
    case = (1, 256, 256, 2, 64, True, None)
    q, k, v, vl = _inputs(case, seed=4)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = _jax_grads(lambda q, k, v: flash_attention_train(
        bf(q), bf(k), bf(v), causal=True, block_q=BLOCK, block_k=BLOCK, interpret=True),
        q, k, v)
    _, got = _torch_grads(lambda q, k, v: flash_bwd.flash_attention_train(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True), q, k, v)
    for name, a, ref in zip("qkv", got, want):
        ref = np.asarray(ref, np.float32)
        step = 2.0 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(a.float().numpy(), ref, rtol=0, atol=2 * step,
                                   err_msg=f"d{name}")


def test_padded_keys_get_zero_grads_and_empty_batch_is_zero():
    """Keys at or past the valid length get exactly zero dK/dV; a batch with
    valid length 0 gives out = 0, lse = -inf and zero grads."""
    case = (2, 160, 160, 2, 64, False, (0, 97))
    q, k, v, vl = _inputs(case, seed=5)
    out, (dq, dk, dv) = _torch_grads(lambda q, k, v: flash_bwd.flash_attention_train(
        q, k, v, _t(vl), causal=False), q, k, v)
    _, lse = flash_bwd.forward_with_lse(_t(q), _t(k), _t(v), _t(vl), causal=False,
                                        scale=64 ** -0.5)
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all() and torch.isfinite(lse[1]).all()
    assert out[0].abs().max() == 0
    for g in (dq[0], dk[0], dv[0], dk[1, 97:], dv[1, 97:]):
        assert g.abs().max() == 0
    assert dk[1, :97].abs().max() > 0 and dv[1, :97].abs().max() > 0
    want = _jax_grads(lambda q, k, v: flash_attention_train(
        q, k, v, causal=False, kv_valid_len=jnp.asarray(vl), block_q=BLOCK, block_k=BLOCK,
        interpret=True), q, k, v)
    for name, a, ref in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=f"d{name}")


def test_flash_forward_backward_matches_pallas_vjp():
    """#1's backward (plain recompute of `_xla_attention`) against the
    grads of `pallas_flash_attention` in interpret mode: the memory's
    cross-attention shape class, D=112, non-causal, a prefix valid length."""
    case = (1, 128, 384, 4, 112, False, (200,))
    q, k, v, vl = _inputs(case, seed=6)
    want = _jax_grads(lambda q, k, v: pallas_flash.pallas_flash_attention(
        q, k, v, causal=False, kv_valid_len=jnp.asarray(vl), block_q=BLOCK, block_k=BLOCK,
        interpret=True), q, k, v)
    out, got = _torch_grads(lambda q, k, v: flash.flash_attention(
        q, k, v, _t(vl), causal=False), q, k, v)
    jout = pallas_flash.pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_valid_len=jnp.asarray(vl), block_q=BLOCK, block_k=BLOCK, interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **OUT_TOL)
    for name, a, ref in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=f"d{name}")


# ------------------------------------ the bf16 backward's work split


def _reachable(sq, skv, causal, block_q, block_k):
    """(query tile, key tile) pairs in which some query sees some key when
    every key is valid, from the element mask."""
    rows = np.arange(sq)[:, None]
    cols = np.arange(skv)[None, :]
    mask = (cols <= rows) if causal else np.ones((sq, skv), bool)
    return {(int(r) // block_q, int(c) // block_k) for r, c in zip(*np.nonzero(mask))}


@settings(max_examples=60, deadline=None)
@given(s=st.integers(1, 700), s_kv=st.integers(1, 700), b=st.integers(1, 2),
       h=st.integers(1, 3), causal=st.booleans(), kind=st.sampled_from(["dq", "dkv"]),
       block_q=st.sampled_from([32, 64, 128]), block_k=st.sampled_from([32, 64, 128]))
def test_work_list_covers_each_reachable_tile_pair_once(s, s_kv, b, h, causal, kind, block_q,
                                                        block_k):
    """Each (batch, query tile, key tile, head) that the mask reaches is
    visited by exactly one item's loop, and nothing else is; items come
    longest loop first."""
    sq, skv = s, (s if causal else s_kv)
    items = flash_bwd.work_list(kind, b, sq, skv, h, causal, block_q, block_k)
    visited, lengths = [], []
    for bi, hi, tile in items:
        if kind == "dq":
            loop = [(tile, n) for n in flash_bwd.dq_key_tiles(tile, sq, skv, causal, block_q,
                                                              block_k)]
        else:
            loop = [(m, tile) for m in flash_bwd.dkv_query_tiles(tile, sq, skv, causal, block_q,
                                                                 block_k)]
        visited += [(bi, hi, m, n) for m, n in loop]
        lengths.append(len(loop))
    want = {(bi, hi, m, n) for bi in range(b) for hi in range(h)
            for m, n in _reachable(sq, skv, causal, block_q, block_k)}
    assert len(visited) == len(set(visited)) and set(visited) == want
    assert lengths == sorted(lengths, reverse=True)
    tiles = -(-sq // block_q) if kind == "dq" else -(-skv // block_k)
    assert sorted(items) == [(bi, hi, i) for bi in range(b) for hi in range(h)
                             for i in range(tiles)]


@pytest.mark.parametrize("kind,items,longest,total", [("dq", 2100, 150, 158550),
                                                       ("dkv", 1050, 150, 79800)])
def test_work_list_at_the_train_shape_is_balanced(kind, items, longest, total):
    """At the LM's train shape (head dim 64) no item's loop is longer than
    150 tiles, under 1/7 of the 1050 that the longest block of a
    group-per-block dK/dV split runs."""
    s = 9557
    bq, bk = ((flash_bwd.dq_block_q(64), flash_bwd.DQ_BLOCK_K) if kind == "dq"
              else (flash_bwd.DKV_BLOCK_Q, flash_bwd.dkv_block_k(64)))
    work = flash_bwd.work_list(kind, 1, s, s, 14, True, bq, bk)
    loop = (flash_bwd.dq_key_tiles if kind == "dq" else flash_bwd.dkv_query_tiles)
    lengths = [len(loop(t, s, s, True, bq, bk)) for _, _, t in work]
    assert (len(work), max(lengths), sum(lengths)) == (items, longest, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 200, 200, 6, 64, True, (200, 77)),
                                  (1, 128, 300, 4, 128, False, (300,))])
def test_dkv_partials_and_group_sum_are_the_reference(case, dtype):
    """The plain version of the bf16 dK/dV kernel's two passes (per-head fp32
    partials, then the group summed in head order and cast once) equals
    `backward_dkv_reference` bit for bit."""
    b, sq, skv, h, d, causal, valid = case
    q, k, v, vl = _inputs(case, seed=8, hkv=2)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tg = (_t(x).to(getattr(torch, dtype)) for x in (q, k, v, g))
    kw = dict(causal=causal, scale=d ** -0.5, kv_groups=h // 2)
    out, lse = flash_bwd.forward_with_lse(tq, tk, tv, _t(vl), **kw)
    delta = flash_bwd.attention_delta(out, tg)
    pk, pv = flash_bwd.backward_dkv_partials_reference(tq, tk, tv, tg, lse, delta, _t(vl), **kw)
    assert pk.shape == (b, h, skv, d) and pk.dtype == torch.float32
    rk, rv = flash_bwd.backward_dkv_reference(tq, tk, tv, tg, lse, delta, _t(vl), **kw)
    assert torch.equal(flash_bwd.group_sum(pk, h // 2).to(rk.dtype), rk)
    assert torch.equal(flash_bwd.group_sum(pv, h // 2).to(rv.dtype), rv)


def test_dkv_partials_match_pallas_group_sum():
    """The partials' group sum against JAX's Pallas backward in interpret
    mode on the same numpy inputs (JAX repeats K/V, so its dK/dV arrive
    summed over each group), at the file's gradient tolerance."""
    case = (2, 256, 256, 6, 64, True, (256, 200))
    q, k, v, vl = _inputs(case, seed=10, hkv=2)
    g = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    scale = 64 ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, repeat_kv(jnp.asarray(k), 3),
                                           repeat_kv(jnp.asarray(v), 3)))
    jout, jlse = _forward_with_lse(jq, jk, jv, jnp.asarray(vl), True, scale, BLOCK, BLOCK, True)
    _, jdk, jdv = _backward(jq, jk, jv, jout, jlse, jnp.asarray(g), jnp.asarray(vl), True, scale,
                            BLOCK, BLOCK, True)
    lse = _t(np.asarray(jlse)[:, :, 0, :]).contiguous()
    delta = flash_bwd.attention_delta(_t(jout), _t(g))
    pk, pv = flash_bwd.backward_dkv_partials_reference(
        _t(q), _t(k), _t(v), _t(g), lse, delta, _t(vl), causal=True, scale=scale, kv_groups=3)
    jdk, jdv = (np.asarray(x).reshape(2, 256, 2, 3, 64).sum(axis=3) for x in (jdk, jdv))
    np.testing.assert_allclose(flash_bwd.group_sum(pk, 3).numpy(), jdk, **GRAD_TOL)
    np.testing.assert_allclose(flash_bwd.group_sum(pv, 3).numpy(), jdv, **GRAD_TOL)


@pytest.mark.parametrize("control", range(5))
def test_chip_smoke_train_kernel_controls_fail_its_check(control):
    """Each neighbouring function that chip_smoke runs as a control at the
    train shape fails `_train_kernels_case`'s rule (every element within
    1e-2 + 1e-2 |ref|, bf16) here too, on the plain versions at S = 300."""
    import chip_smoke

    case = (1, 300, 300, 4, 64, True, (300,))
    q, k, v, vl = (_t(x) for x in _inputs(case, seed=12, hkv=2))
    q, k, v = (x.bfloat16() for x in (q, k, v))
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(q.shape).astype(np.float32))
    g = g.bfloat16()
    kw = dict(causal=True, scale=64 ** -0.5, kv_groups=2)
    out, lse = flash_bwd.forward_with_lse(q, k, v, vl, **kw)
    delta = flash_bwd.attention_delta(out, g)
    refs = (flash_bwd.backward_dq_reference(q, k, v, g, lse, delta, vl, **kw),
            *flash_bwd.backward_dkv_reference(q, k, v, g, lse, delta, vl, **kw))
    controls = list(chip_smoke._train_controls(q, k, v, g, lse, delta, vl, refs, **kw))
    assert len(controls) == 5
    label, got, ref = controls[control]
    assert chip_smoke._train_outside(got, ref) > 0, label
    assert chip_smoke._train_outside(ref.clone(), ref) == 0
