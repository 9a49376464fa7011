"""PyTorch port ops against their JAX counterparts on the CPU.

Same numpy inputs through both; fp32 throughout, and the conftest pins JAX
matmuls to full precision, so the ops agree to fp32 rounding: rtol/atol 1e-5
(1e-6 where the op is elementwise).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.ops import attention as jattn
from memory_augmented_vlm_tpu.ops import norms as jnorms
from memory_augmented_vlm_tpu.ops import pooling as jpool
from memory_augmented_vlm_tpu.ops import rope as jrope
from memory_augmented_vlm_torch.ops import attention as tattn
from memory_augmented_vlm_torch.ops import norms as tnorms
from memory_augmented_vlm_torch.ops import pooling as tpool
from memory_augmented_vlm_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 7, 64), _rand(rng, 64)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm_matches_jax(eps):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 5, 48) * 3 + 1, _rand(rng, 48), _rand(rng, 48)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    d, theta = 16, 10000.0
    inv_j = jrope.compute_rope_freqs(d, theta)
    inv_t = trope.compute_rope_freqs(d, theta, "cpu")
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6)
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [5]], np.int32)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j)
    cos_t, sin_t = trope.rope_cos_sin(torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)
    x = _rand(rng, 2, 40, 3, d)
    want = jrope.apply_rope(jnp.asarray(x), cos_j, sin_j)
    got = trope.apply_rope(torch.from_numpy(x), cos_t, sin_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("side", [27, 4, 5])
def test_spatial_pool_matches_jax(side):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, side * side, 8)
    want = jpool.spatial_pool_2x2(jnp.asarray(x), side)
    got = tpool.spatial_pool_2x2(torch.from_numpy(x), side)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (False, True)])
def test_mha_attention_matches_jax(causal, masked):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 9, 3, 8), _rand(rng, 2, 9, 3, 8), _rand(rng, 2, 9, 3, 8)
    mask = None
    if masked:
        mask = np.arange(9)[None, None, None, :] < np.array([9, 4])[:, None, None, None]
    want = jattn.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask), causal=causal)
    got = tattn.mha_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              None if mask is None else torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_repeat_kv_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 4, 2, 3)).astype(np.float32)
    want = jattn.repeat_kv(jnp.asarray(x), 3)
    got = tattn.repeat_kv(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    q = _rand(rng, 2, 1, 6, 16)
    kc, vc = _rand(rng, 2, 24, 2, 16), _rand(rng, 2, 24, 2, 16)
    lens = np.array([24, 9], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(lens), kv_groups=3)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(lens), kv_groups=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
