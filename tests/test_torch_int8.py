"""The port's int8 serving path against the JAX package on the CPU.

Quantizers give int8 codes equal to JAX's and scales within 1e-7 relative.
Each kernel's plain version is held against its Pallas kernel in interpret
mode (as tests/test_pallas_int8.py and tests/test_pallas_flash.py run
them) at a tower of hidden 144 and 2 heads, so the head dim is 72 as at
full width. Then the int8 tower, the int8 LM with an int8 KV cache and the
whole int8 slice against `bench.build_pipeline(kv_int8=True)`.

Tolerances: products of int8 codes are exact on both sides, so fp32
results differ only by summation order (1e-5); a bf16 output may land one
bf16 step away when an fp32 value sits near a rounding boundary. Whole
modules and the slice compare at 1e-4 to 2e-4: a LayerNorm or softmax
summed in another order can move a value across an int8 rounding tie,
which changes one code by one (the seeds here differ by ~1e-6).
"""

import dataclasses
import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from memory_augmented_vlm_tpu.config import LMConfig, VisionConfig
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.ops import pallas_int8
from memory_augmented_vlm_tpu.ops import quant as jquant
from memory_augmented_vlm_tpu.ops.pallas_flash import flash_attention_merge_heads
from memory_augmented_vlm_tpu.ops.pallas_mlp_int8 import fused_mlp_block_int8
from memory_augmented_vlm_tpu.ops.pallas_qkv_int8 import fused_qkv_int8
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch import convert, pipeline
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.ops import flash, mlp_int8, qkv_int8, quant
from test_vlm import TINY

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = 2.0 ** -7  # the largest spacing of bf16 values relative to their size


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _assert_within_bf16_step(got: torch.Tensor, want, what="", atol=1e-6):
    """Every element equal or one bf16 step apart (relative to its size),
    give or take `atol`."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_less(np.abs(got - want), BF16_STEP * np.abs(want) + atol,
                                 err_msg=what)


# ------------------------------------------------------------ quantizers

def test_quantizers_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 144)) * rng.uniform(0.01, 10, (37, 1))).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the floor
    jq, js = pallas_int8.quantize_rows(jnp.asarray(x))
    tq, ts = quant.quantize_rows(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)

    w = (rng.standard_normal((144, 72)) * 0.02).astype(np.float32)
    w[:, 5] = 0.0
    jw, jws = jquant.prequantize_kernel(jnp.asarray(w))
    tw, tws = quant.prequantize_kernel(_t(w))
    assert tw.t().is_contiguous()  # column-major, the kernels' layout
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=1e-7, atol=0)

    kv = rng.standard_normal((2, 3, 5, 2, 16)).astype(np.float32)
    kv[0, 0, 0] = 0.0
    jk, jks = jqwen2.quantize_kv_rows(jnp.asarray(kv))
    tk, tks = tqwen2.quantize_kv_rows(_t(kv))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 144)).astype(np.float32)
    w = (rng.standard_normal((144, 96)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(96) * 0.1).astype(np.float32)
    jw, js = jquant.prequantize_kernel(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jquant.int8_linear({"kernel_int8": jw, "scale": js, "bias": jnp.asarray(bias)}, jx)
    tw, ts = quant.prequantize_kernel(_t(w))
    got = quant.int8_linear({"kernel_int8": tw, "scale": ts, "bias": _t(bias)},
                            _t(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32  # the fp32 bias promotes, as in JAX
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:  # cast to bf16 before the bias: one bf16 step of the product
        _assert_within_bf16_step(got - _t(bias), np.asarray(want) - bias)


@pytest.mark.parametrize("m", [1, 5, 40])
def test_cpu_int_mm_is_exact(m):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, (m, 144), dtype=np.int8))
    b = quant.column_major(torch.from_numpy(rng.integers(-127, 128, (144, 72), dtype=np.int8)))
    torch.testing.assert_close(quant.int_mm(a, b), a.int() @ b.int(), rtol=0, atol=0)
    with pytest.raises(TypeError):
        quant.int_mm(a.float(), b)
    with pytest.raises(ValueError):
        quant.int_mm(a, b[:100])


# --------------------------------------------------- kernel plain versions

H, NH, I = 144, 2, 208  # head dim 72; I = 208 is a multiple of 16, not of 32


def _int8_weight(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jw, js = jquant.prequantize_kernel(jnp.asarray(w))
    b = (rng.standard_normal(n) * 0.02).astype(np.float32)
    return (jw, js, jnp.asarray(b)), (quant.column_major(_t(jw)), _t(js), _t(b))


def _ln(rng, k):
    w = (1.0 + rng.standard_normal(k) * 0.05).astype(np.float32)
    b = (rng.standard_normal(k) * 0.02).astype(np.float32)
    return (jnp.asarray(w), jnp.asarray(b)), (_t(w), _t(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_int8_reference_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 70, H)).astype(np.float32)  # 70 rows: not a block multiple
    (jlw, jlb), (tlw, tlb) = _ln(rng, H)
    mats = [_int8_weight(rng, H, H) for _ in range(3)]
    jh = jnp.asarray(hidden, getattr(jnp, dtype))
    want = fused_qkv_int8(jh, jlw, jlb, *[x for j, _ in mats for x in j], nh=NH, block_r=32,
                          interpret=True)
    th = _t(hidden).to(getattr(torch, dtype))
    got = qkv_int8.fused_qkv_int8(th, tlw, tlb, *[x for _, t in mats for x in t], nh=NH)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (2, NH, 70, 72) and g.dtype == torch.bfloat16
        _assert_within_bf16_step(g, w[:, :, :70], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h,nh", [
    (1, 1152, 16), (47, 1152, 16), (63, 1152, 16), (65, 1152, 16), (129, 1152, 16),
    (129, 144, 2),  # K and N ragged against the kernel's 128-byte step and tiles
    (129, 144, 8),  # head dim 18: four columns of a store may open the next head
])
def test_fused_qkv_int8_reference_matches_pallas_interpret_at_kernel_edges(rows, h, nh, dtype):
    """The card's edge cases of #3 (chip_smoke.phase_int8_kernels): rows
    ragged against the 128-row tiles at the tower's width, and H 144. At
    1152 wide an LN value now and then sits on an int8 rounding tie that
    XLA and PyTorch round apart (summed in another order): that code one
    step away moves its row's outputs by sx * |w| <= 4.5 / 127 * 0.27 <
    1e-2. So 97% of the elements are held within a bf16 step, and all of
    them within it plus 1e-2."""
    rng = np.random.default_rng(rows + nh)
    hidden = rng.standard_normal((1, rows, h)).astype(np.float32)
    (jlw, jlb), (tlw, tlb) = _ln(rng, h)
    mats = [_int8_weight(rng, h, h) for _ in range(3)]
    want = fused_qkv_int8(jnp.asarray(hidden, getattr(jnp, dtype)), jlw, jlb,
                          *[x for j, _ in mats for x in j], nh=nh, block_r=32, interpret=True)
    got = qkv_int8.fused_qkv_int8(_t(hidden).to(getattr(torch, dtype)), tlw, tlb,
                                  *[x for _, t in mats for x in t], nh=nh)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (1, nh, rows, h // nh) and g.dtype == torch.bfloat16
        w = np.asarray(jnp.asarray(w[:, :, :rows], jnp.float32))
        diff, step = np.abs(g.float().numpy() - w), BF16_STEP * np.abs(w) + 1e-6
        assert (diff <= step).mean() >= 0.97, (name, (diff <= step).mean())
        assert (diff <= step + 1e-2).all(), (name, (diff - step).max())


@pytest.mark.parametrize("valid", [(70, 70), (70, 33), (0, 70)])
def test_merge_heads_reference_matches_pallas_interpret(valid):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, NH, 72, 72)).astype(np.float32) for _ in range(3))
    vl = np.asarray(valid, np.int32)
    want = flash_attention_merge_heads(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                       jnp.asarray(vl), block_q=8, interpret=True)
    got = flash.flash_attention_merge_heads(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                                            _t(vl))
    assert got.shape == (2, 72, NH * 72) and got.dtype == torch.bfloat16
    # exp2 one ulp apart can round a P to the neighbouring bf16 value: an
    # output near 0 then moves by ~p * v * 2^-8 / l, not by its own step
    _assert_within_bf16_step(got, want, atol=1e-3)
    if valid[0] == 0:  # no valid key: the mean of V over all S keys, not zeros
        mean_v = _t(v[0]).to(torch.bfloat16).float().mean(dim=1).reshape(1, -1)
        torch.testing.assert_close(got[0].float(), mean_v.expand(72, -1), rtol=1e-2,
                                   atol=1e-2)


def test_merge_heads_fp32_and_int8_scores():
    """fp32 q/k/v: P is still rounded to bf16 for PV on both sides, and an
    exp2 one ulp apart can round it to the neighbouring bf16 value, which
    moves an output by ~p * v * 2^-8 / l: held at 5e-4."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, NH, 40, 72)).astype(np.float32) for _ in range(3))
    vl = np.asarray([29], np.int32)
    want = flash_attention_merge_heads(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(vl),
                                       block_q=8, interpret=True)
    got = flash.flash_attention_merge_heads(*(_t(x) for x in (q, k, v)), _t(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    # the int8_scores mode on the same fp32 inputs, five 8-row q tiles: its
    # integer products are exact and P is an int8 code, so fp32 sums in
    # another order and exp2 one ulp apart leave it within 5e-4 as well
    want = flash_attention_merge_heads(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(vl),
                                       block_q=8, int8_scores=True, interpret=True)
    got = flash.flash_attention_merge_heads(*(_t(x) for x in (q, k, v)), _t(vl), block_q=8,
                                            int8_scores=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("m", [72, 45])
def test_fused_mlp_block_int8_reference_matches_pallas_interpret(m):
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((m, H)).astype(np.float32)
    (jlw, jlb), (tlw, tlb) = _ln(rng, H)
    (j1, t1), (j2, t2) = _int8_weight(rng, H, I), _int8_weight(rng, I, H)
    want = fused_mlp_block_int8(jnp.asarray(hidden), jlw, jlb, *j1, *j2, block_m=32,
                                interpret=True)
    got = mlp_int8.fused_mlp_block_int8(_t(hidden), tlw, tlb, *t1, *t2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ------------------------------------------------------------- wrappers

def _qkv_args(dtype=torch.float32, s=9):
    rng = np.random.default_rng(7)
    mats = [t for _ in range(3) for t in _int8_weight(rng, H, H)[1]]
    return (_t(rng.standard_normal((1, s, H)).astype(np.float32)).to(dtype),
            *_ln(rng, H)[1], *mats)


def _mlp_args(dtype=torch.float32, m=9):
    rng = np.random.default_rng(8)
    return (_t(rng.standard_normal((m, H)).astype(np.float32)).to(dtype), *_ln(rng, H)[1],
            *_int8_weight(rng, H, I)[1], *_int8_weight(rng, I, H)[1])


def test_int8_wrappers_take_plain_versions_on_cpu():
    before = (qkv_int8.fused_qkv_int8.launches, flash.flash_attention_merge_heads.launches,
              mlp_int8.fused_mlp_block_int8.launches)
    args = _qkv_args()
    for got, want in zip(qkv_int8.fused_qkv_int8(*args, nh=NH),
                         qkv_int8.fused_qkv_int8_reference(*args, nh=NH)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    q = torch.randn(1, NH, 9, 72).to(torch.bfloat16)
    vl = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(flash.flash_attention_merge_heads(q, q, q, vl),
                               flash.flash_attention_merge_heads_reference(q, q, q, vl),
                               rtol=0, atol=0)
    args = _mlp_args()
    torch.testing.assert_close(mlp_int8.fused_mlp_block_int8(*args),
                               mlp_int8.fused_mlp_block_int8_reference(*args), rtol=0, atol=0)
    assert (qkv_int8.fused_qkv_int8.launches, flash.flash_attention_merge_heads.launches,
            mlp_int8.fused_mlp_block_int8.launches) == before  # no kernel on the CPU


def test_int8_wrappers_reject_bad_arguments():
    args = list(_qkv_args())
    with pytest.raises(ValueError):
        qkv_int8.fused_qkv_int8(*args, nh=5)  # 144 does not split into 5 heads
    with pytest.raises(ValueError):
        qkv_int8.fused_qkv_int8(args[0][0], *args[1:], nh=NH)  # not (B, S, H)
    bad = list(args)
    bad[3] = bad[3][:, :100]
    with pytest.raises(ValueError):
        qkv_int8.fused_qkv_int8(*bad, nh=NH)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        qkv_int8.fused_qkv_int8(*meta, nh=NH)

    q = torch.randn(1, NH, 9, 72)
    with pytest.raises(ValueError):
        flash.flash_attention_merge_heads(q, q[:, :, :5], q, torch.tensor([9]))
    with pytest.raises(ValueError):
        flash.flash_attention_merge_heads(q, q, q, torch.tensor([9, 9]))
    with pytest.raises(ValueError):
        flash.flash_attention_merge_heads(*(x.to("meta") for x in (q, q, q)),
                                          torch.tensor([9], device="meta"))

    args = list(_mlp_args())
    with pytest.raises(ValueError):
        mlp_int8.fused_mlp_block_int8(args[0][None], *args[1:])  # not (M, K)
    bad = list(args)
    bad[6] = bad[6][:100]  # w2 not (I, K)
    with pytest.raises(ValueError):
        mlp_int8.fused_mlp_block_int8(*bad)
    with pytest.raises(ValueError):
        mlp_int8.fused_mlp_block_int8(*(a.to("meta") for a in args))
    with pytest.raises(TypeError):
        quant.int8_linear({"kernel_int8": args[3].float(), "scale": args[4]}, args[0])


# ------------------------------------------------------------- the tower

TOWER = VisionConfig(hidden_size=H, intermediate_size=I, num_hidden_layers=3,
                     num_attention_heads=NH, image_size=56, patch_size=14)


@functools.lru_cache(maxsize=1)
def _tiny_params():
    """The float TINY model, shared by the tests below (numpy leaves)."""
    return jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))


@functools.lru_cache(maxsize=1)
def _int8_tower():
    jp = jsiglip.prequantize_int8(jsiglip.init_params(TOWER, jax.random.key(9)))
    # from_jax_params converts a whole model: TINY's other parts ride along
    tp = convert.from_jax_params({**_tiny_params(), "vision_tower": jax.tree.map(np.asarray, jp)},
                                 convert.config_from_fields(_tower_vlm_cfg()), device="cpu")
    return jp, tp["vision_tower"]


def _tower_vlm_cfg():
    return dataclasses.replace(TINY, vision=TOWER)


def test_int8_tower_matches_jax_fused_path():
    jp, tp = _int8_tower()
    assert tp["layers"][0]["fc1"]["kernel_int8"].t().is_contiguous()
    pix = np.random.default_rng(11).standard_normal((3, 56, 56, 3)).astype(np.float32)
    # JAX on the CPU: fused q/k/v (bf16 out) and merge kernels, interpreted;
    # its MLP is the composed int8 path, the fused block's math at fp32
    want = np.asarray(jsiglip.forward(jp, TOWER, jnp.asarray(pix), int8=True, use_flash=True,
                                      _interpret=True))
    got = tsiglip.forward(tp, convert.config_from_fields(_tower_vlm_cfg()).vision,
                          _t(pix), int8=True).numpy()
    assert got.shape == want.shape == (3, 16, H)
    rel = np.abs(got - want).std() / want.std()
    assert rel < 1e-4, rel  # tests/test_siglip_parity.py holds the fused path at 2e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_float_tower_with_int8_flag_raises():
    tp = tsiglip.init_params(tconfig.VisionConfig(**{f.name: getattr(TOWER, f.name) for f in
                                                     dataclasses.fields(tconfig.VisionConfig)}),
                             torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="prequantize_int8"):
        tsiglip.forward(tp, convert.config_from_fields(_tower_vlm_cfg()).vision,
                        torch.zeros(1, 56, 56, 3), int8=True)


# ---------------------------------------------------------------- the LM

LM = LMConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              rope_theta=10000.0, dtype="float32")


def test_int8_lm_prefill_cache_and_decode_match_jax():
    jp = jqwen2.prequantize_int8(jqwen2.init_params(LM, jax.random.key(12)),
                                 include_unembed=True)
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(LM.num_hidden_layers)]
    tp = convert._tree({**jax.tree.map(np.asarray, jp), "layers": layers}, "cpu", None)
    pcfg = tconfig.LMConfig(**{f.name: getattr(LM, f.name)
                               for f in dataclasses.fields(tconfig.LMConfig)})
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).copy()
    valid = np.array([40, 23], np.int32)
    jh, jc = jqwen2.forward(jp, LM, jnp.asarray(x), jnp.asarray(pos),
                            valid_len=jnp.asarray(valid), cache_max_len=44)
    th, tc = tqwen2.forward(tp, pcfg, _t(x), _t(pos), valid_len=_t(valid), cache_max_len=44)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tqwen2.unembed(tp, th[:, -1:]).numpy(),
                               np.asarray(jqwen2.unembed(jp, LM, jh[:, -1:])),
                               rtol=2e-4, atol=2e-4)
    jc, tc = jqwen2.quantize_cache(jc), tqwen2.quantize_cache(tc)
    assert tc.k.dtype == torch.int8 and tc.k_scale.shape == (2, 2, 44, 2)
    assert tqwen2.quantize_cache(tc) is tc
    for step in range(3):
        ids = rng.integers(0, 512, size=(2, 1))
        je = jqwen2.embed_tokens(jp, jnp.asarray(ids))
        jh, jc = jqwen2.decode_step(jp, LM, je, jc)
        th, tc = tqwen2.decode_step(tp, pcfg, tqwen2.embed_tokens(tp, _t(ids)), tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tqwen2.unembed(tp, th).numpy(),
                                   np.asarray(jqwen2.unembed(jp, LM, jh)),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {step}")
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    # codes written during decode agree up to a tie flip; scales to fp32 rounding
    assert np.mean(tc.k.numpy() != np.asarray(jc.k)) < 1e-3
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=1e-4, atol=1e-7)


def test_int8_kv_cache_zeros_has_scales_as_jax():
    """`KVCache.zeros(..., int8)` carries zero fp32 K and V scales of shape
    (L, B, Smax, Hkv), as JAX's does (exact: both are zeros), and
    `decode_step` runs on it, writing one position's codes and scales."""
    pcfg = tconfig.LMConfig(**{f.name: getattr(LM, f.name)
                               for f in dataclasses.fields(tconfig.LMConfig)})
    jc = jqwen2.KVCache.zeros(LM, 2, 9, jnp.int8)
    tc = tqwen2.KVCache.zeros(pcfg, 2, 9, "cpu", torch.int8)
    for name in ("k", "v", "length", "k_scale", "v_scale"):
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name)
        assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert tc.k_scale.data_ptr() != tc.v_scale.data_ptr()  # decode_step writes each in place
    assert tqwen2.KVCache.zeros(pcfg, 2, 9, "cpu").k_scale is None  # bf16: no scales
    jp = jqwen2.prequantize_int8(jqwen2.init_params(LM, jax.random.key(14)))
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(LM.num_hidden_layers)]
    tp = convert._tree({**jax.tree.map(np.asarray, jp), "layers": layers}, "cpu", None)
    ids = np.array([[3], [7]])
    th, tc = tqwen2.decode_step(tp, pcfg, tqwen2.embed_tokens(tp, _t(ids)), tc)
    jh, jc = jqwen2.decode_step(jp, LM, jqwen2.embed_tokens(jp, jnp.asarray(ids)), jc)
    # 2e-4 as in the prefill/decode test above: an fp32 sum in another order
    # can flip one int8 code at a tie (module docstring)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-4)
    assert tc.length.tolist() == [1, 1]
    assert (tc.k_scale[:, :, 0] > 0).all() and not tc.k_scale[:, :, 1:].any()
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=1e-4, atol=1e-7)


# -------------------------------------------------------------- the slice

MAX_NEW = 6
TEXT_BEFORE = np.array([11, 872, 198], np.int32)
TEXT_AFTER = np.array([3838, 374, 12482, 304, 419, 2766, 30, 4545, 198, 1644, 7791, 198],
                      np.int32)
SLICE_TOL = 1e-4


@pytest.fixture(scope="module")
def int8_weights():
    cfg = dataclasses.replace(TINY, pipeline=dataclasses.replace(TINY.pipeline,
                                                                 tower_int8=True))
    params = jax.tree.map(jnp.asarray, _tiny_params())
    params["vision_tower"] = jsiglip.prequantize_int8(params["vision_tower"])
    params["language_model"] = jqwen2.prequantize_int8(params["language_model"],
                                                       include_unembed=True)
    port = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   convert.config_from_fields(cfg), device="cpu")
    return cfg, params, port


@pytest.mark.parametrize("num_frames", [12, 96])
def test_int8_pipeline_matches_bench(int8_weights, monkeypatch, num_frames):
    cfg, jparams, tparams = int8_weights
    # the JAX tower's fused path (bf16 q/k/v) is TPU-gated: force it, interpreted
    monkeypatch.setattr(jsiglip, "forward", functools.partial(jsiglip.forward, use_flash=True,
                                                              _interpret=True))
    pix = np.random.default_rng(num_frames).standard_normal(
        (num_frames, 56, 56, 3)).astype(np.float32)
    jfn, jnseg = bench.build_pipeline(cfg, num_frames, kv_int8=True,
                                      return_prefill_logits=True, max_new_tokens=MAX_NEW)
    jtok, js, jlogits = jax.jit(jfn)(jparams, jnp.asarray(pix), jnp.asarray(TEXT_BEFORE),
                                     jnp.asarray(TEXT_AFTER))
    pcfg = convert.config_from_fields(cfg)
    assert pcfg.pipeline.tower_int8
    tfn, tnseg = pipeline.build_pipeline(pcfg, num_frames, kv_int8=True, return_logits=True,
                                         max_new_tokens=MAX_NEW)
    ttok, ts, tlogits = tfn(tparams, _t(pix), _t(TEXT_BEFORE), _t(TEXT_AFTER))
    assert tnseg == jnseg and ts == int(js)
    np.testing.assert_allclose(tlogits[0].numpy(), np.asarray(jlogits), rtol=SLICE_TOL,
                               atol=SLICE_TOL)
    # greedy tokens agree while the port's top-2 margin exceeds the tolerance
    compared = 0
    for step in range(MAX_NEW):
        top2 = torch.topk(tlogits[step, 0], 2).values
        if float(top2[0] - top2[1]) <= SLICE_TOL:
            break
        assert int(ttok[step, 0]) == int(np.asarray(jtok)[step, 0]), step
        compared += 1
    assert compared >= 1


def test_port_prequantize_matches_jax(int8_weights):
    """The port's own prequantizers (what chip_smoke.py runs on the card) on
    converted float weights give the JAX-prequantized tree: equal codes,
    scales to fp32 rounding, the int8 kernels column-major."""
    cfg, _, want = int8_weights
    floats = convert.from_jax_params(_tiny_params(), convert.config_from_fields(cfg),
                                     device="cpu")
    got = pipeline.int8_serving_params(floats)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for name, g in got_leaves.items():
        w = want_leaves[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.int8:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
            if name.endswith("kernel_int8"):
                assert g.t().is_contiguous() and w.t().is_contiguous(), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-7, atol=0, msg=name)


# ------------------------------------------------------------ conversion

def test_convert_defaults_to_the_card_and_accepts_tower_int8():
    assert inspect.signature(convert.from_jax_params).parameters["device"].default == "cuda"
    cfg = dataclasses.replace(TINY, pipeline=dataclasses.replace(TINY.pipeline,
                                                                 tower_int8=True))
    assert convert.config_from_fields(cfg).pipeline.tower_int8

