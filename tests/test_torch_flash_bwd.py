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
