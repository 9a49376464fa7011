"""The port's approximate int8 attention and its micro-benchmark kernels
against the JAX package on the CPU.

- The `int8_scores` mode of the merge-heads attention against
  `flash_attention_merge_heads(int8_scores=True, interpret=True)`, alone
  and inside the tiny int8 tower (the merge entry swapped in both
  packages, as `tools_attn_int8_ab.py` swaps it).
- The fused attention half-block against `fused_attn_block_int8(
  interpret=True)` at `tests/test_attn_block.py`'s cases.
- The int8 ceiling GEMM and the decode GEMV against their Pallas kernel
  bodies rebuilt in jnp (the tools run their whole benchmark when
  imported, so they are not imported here).
- The wrappers' CPU dispatch and argument checks.

Tolerances: int8 products are exact on both sides. The int8_scores codes
are `x * (1/s)`, as the port's other quantizers; XLA's jitted CPU code
evaluates that product as `x / s` at times, which puts a value sitting on a
rounding tie one code away (one q code of 3 x 16 x 72 in the tower test).
So kernels are held as `_assert_close_but_for_flips` holds them: most
elements to the tight tolerance, all of them to it plus a stated code step.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.ops import pallas_flash
from memory_augmented_vlm_tpu.ops.pallas_attn_block import fused_attn_block_int8 as jattn_block
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.microbench import gemv as tgemv
from memory_augmented_vlm_torch.microbench import int8_ceiling
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.ops import attn_block, flash, quant
from test_torch_int8 import TOWER, _int8_tower, _t, _tower_vlm_cfg
from test_torch_int8_fused import _assert_close_but_for_flips

# ------------------------------------------------------- int8_scores (#2)


def _qkv(rng, b, nh, s, d):
    return [rng.standard_normal((b, nh, s, d)).astype(np.float32) for _ in range(3)]


def _jax_merge(q, k, v, valid, **kw):
    return flash_merge(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                       jnp.asarray(valid, jnp.int32), interpret=True, **kw)


flash_merge = pallas_flash.flash_attention_merge_heads


@pytest.mark.parametrize("b,nh,s,d,valid,block_q", [
    (2, 4, 256, 64, (256, 200), 128),  # tests/test_pallas_flash.py:178's inputs
    (2, 2, 72, 72, (72, 33), 8),       # D 72, nine q tiles: one q scale each
    (2, 2, 40, 72, (0, 40), 16),       # valid length 0; block_q 16 halves to 8 rows
])
def test_int8_scores_matches_pallas_interpret(b, nh, s, d, valid, block_q):
    rng = np.random.default_rng(30)
    q, k, v = _qkv(rng, b, nh, s, d)
    want = _jax_merge(q, k, v, valid, block_q=block_q, int8_scores=True)
    got = flash.flash_attention_merge_heads(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                                            _t(np.asarray(valid, np.int32)), block_q=block_q,
                                            int8_scores=True)
    assert got.shape == (b, s, nh * d) and got.dtype == torch.bfloat16
    # one P code step moves an output by |v code| * (sv / 127) / l <= max|v| / 127
    # (l >= 1); a bf16 v is within a bf16 step of v
    _assert_close_but_for_flips(got, want, flip=float(np.abs(v).max()) / 127)
    if valid[0] == 0:  # every key takes p = 1: the mean of the dequantised V
        vb = _t(v[0]).to(torch.bfloat16).float()
        sv = vb.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
        mean_v = (torch.round(vb * (1.0 / sv)) * sv).mean(dim=1)  # (NH, D)
        torch.testing.assert_close(got[0].float(), mean_v.reshape(1, -1).expand(s, -1),
                                   rtol=1e-2, atol=1e-2)


def test_int8_scores_tile_scale_is_per_tile():
    """A q row 100 times larger than the rest sets its own tile's scale:
    with 8-row tiles the other tiles keep their resolution, so the port
    holds JAX's result with block_q 8 and not with one tile."""
    rng = np.random.default_rng(31)
    q, k, v = _qkv(rng, 1, 2, 64, 72)
    q[0, :, 3] *= 100.0
    per_tile = _jax_merge(q, k, v, (64,), block_q=8, int8_scores=True)
    one_tile = _jax_merge(q, k, v, (64,), block_q=64, int8_scores=True)
    args = [_t(x).to(torch.bfloat16) for x in (q, k, v)] + [_t(np.asarray([64], np.int32))]
    got = flash.flash_attention_merge_heads(*args, block_q=8, int8_scores=True)
    _assert_close_but_for_flips(got, per_tile, flip=float(np.abs(v).max()) / 127)
    gap = np.abs(np.asarray(one_tile, np.float32) - np.asarray(per_tile, np.float32)).max()
    assert gap > 0.1, gap  # the two tilings are two functions
    assert [flash.merge_q_tile(s) for s in (729, 736, 256, 16, 40, 1)] == [32, 32, 128, 16, 40, 8]
    assert flash.merge_q_tile(256, 100) == 1  # JAX's halving: 100, 50, 25, 12, 6, 3, 1


def test_int8_scores_within_jax_bound_of_exact_mode():
    """JAX's own bound (tests/test_pallas_flash.py:178) on its inputs: the
    approximate mode within 3% of the exact one (std of |difference| over
    std), correlation above 0.999."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 256, 64))).to(torch.bfloat16)
               for _ in range(3))
    vl = torch.tensor([256, 200], dtype=torch.int32)
    exact = flash.flash_attention_merge_heads(q, k, v, vl).float().numpy()
    got = flash.flash_attention_merge_heads(q, k, v, vl, int8_scores=True).float().numpy()
    rel = np.abs(got - exact).std() / exact.std()
    assert rel < 0.03, rel
    corr = np.corrcoef(got.ravel(), exact.ravel())[0, 1]
    assert corr > 0.999, corr


def test_int8_scores_tower_matches_jax(monkeypatch):
    """The tiny int8 tower (S = 16, one q tile on both sides) with the merge
    entry swapped for its int8_scores mode in both packages. Tie flips of
    the q codes (see the module docstring) cascade through the three layers,
    so the port is held by the spread of the difference: within 5e-4 of the
    output's spread, and under half the distance between JAX's int8_scores
    and exact towers (the port follows the approximate mode, not the exact
    one)."""
    jp, tp = _int8_tower()
    pix = np.random.default_rng(11).standard_normal((3, 56, 56, 3)).astype(np.float32)

    def jax_tower():
        return np.asarray(jsiglip.forward(jp, TOWER, jnp.asarray(pix), int8=True, use_flash=True,
                                          _interpret=True))

    exact = jax_tower()
    monkeypatch.setattr(pallas_flash, "flash_attention_merge_heads",
                        functools.partial(flash_merge, int8_scores=True))
    want = jax_tower()
    monkeypatch.setattr(tsiglip, "flash_attention_merge_heads",
                        functools.partial(flash.flash_attention_merge_heads, int8_scores=True))
    before = flash.flash_attention_merge_heads.launches
    got = tsiglip.forward(tp, convert.config_from_fields(_tower_vlm_cfg()).vision, _t(pix),
                          int8=True).numpy()
    assert flash.flash_attention_merge_heads.launches == before
    assert got.shape == want.shape == (3, 16, TOWER.hidden_size)
    rel = np.abs(got - want).std() / want.std()
    mode_gap = np.abs(exact - want).std() / want.std()
    assert rel < 5e-4, rel
    assert rel < 0.5 * mode_gap, (rel, mode_gap)


# ------------------------------------------------ attention half-block (#12)


def _block_setup(b=2, s=128, h=256, seed=0):
    """tests/test_attn_block.py's inputs: fp32 hidden, int8 (H, H) weights
    row-major as JAX takes them."""
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((b, s, h)) * 0.3).astype(np.float32)
    ln_w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    weights = []
    for _ in range(4):
        weights += [rng.integers(-127, 128, (h, h)).astype(np.int8),
                    (np.abs(rng.standard_normal(h)) * 0.02 / 127).astype(np.float32),
                    (rng.standard_normal(h) * 0.01).astype(np.float32)]
    return hidden, ln_w, ln_b, weights


def _block_pair(hidden, ln_w, ln_b, weights, nh, valid, block_r):
    want = jattn_block(jnp.asarray(hidden), jnp.asarray(ln_w), jnp.asarray(ln_b),
                       *(jnp.asarray(w) for w in weights), nh=nh, valid=valid,
                       block_r=block_r, interpret=True)
    got = attn_block.fused_attn_block_int8(_t(hidden), _t(ln_w), _t(ln_b),
                                           *convert.attn_block_weights(weights, device="cpu"),
                                           nh=nh, valid=valid)
    return got, want


# fp32 hidden: q/k/v are still rounded to bf16 on both sides. A code step of
# the LN row moves q/k/v by up to sx * 127 * s ~ 3 / 127 * 127 * 4e-4, and
# one of the attention output moves a row by s_row_h * 127 * so < 1e-4:
# flips are held at 1e-3.
BLOCK_FLIP = 1e-3


@pytest.mark.parametrize("block_r,valid", [(64, 100), (128, 128), (32, 97)])
def test_attn_block_matches_pallas_interpret(block_r, valid):
    got, want = _block_pair(*_block_setup(), nh=4, valid=valid, block_r=block_r)
    assert got.shape == (2, 128, 256) and got.dtype == torch.float32
    _assert_close_but_for_flips(got, want, flip=BLOCK_FLIP)


@pytest.mark.parametrize("nh", [2, 8])
def test_attn_block_head_counts_match_pallas_interpret(nh):
    got, want = _block_pair(*_block_setup(), nh=nh, valid=128, block_r=64)
    _assert_close_but_for_flips(got, want, flip=BLOCK_FLIP)


def test_attn_block_padded_rows_stay_finite():
    hidden, ln_w, ln_b, weights = _block_setup()
    hidden[:, 100:] = 0.0  # padded tail rows
    got, want = _block_pair(hidden, ln_w, ln_b, weights, nh=4, valid=100, block_r=64)
    assert torch.isfinite(got).all()
    _assert_close_but_for_flips(got, want, flip=BLOCK_FLIP)


def test_attn_block_bf16_hidden():
    hidden, ln_w, ln_b, weights = _block_setup(s=64)
    hb = jnp.asarray(hidden, jnp.bfloat16)
    want = jattn_block(hb, jnp.asarray(ln_w), jnp.asarray(ln_b),
                       *(jnp.asarray(w) for w in weights), nh=4, valid=50, block_r=32,
                       interpret=True)
    got = attn_block.fused_attn_block_int8(_t(np.asarray(hb, np.float32)).to(torch.bfloat16),
                                           _t(ln_w), _t(ln_b),
                                           *convert.attn_block_weights(weights, device="cpu"),
                                           nh=4, valid=50)
    assert got.dtype == torch.bfloat16
    _assert_close_but_for_flips(got, want, flip=BLOCK_FLIP)


def test_attn_block_weights_convert_to_column_major():
    _, _, _, weights = _block_setup(h=64)
    port = convert.attn_block_weights(weights, device="cpu")
    for i, (theirs, ours) in enumerate(zip(weights, port)):
        np.testing.assert_array_equal(ours.numpy(), theirs)
        if i % 3 == 0:  # the int8 matrices, column-major
            assert ours.dtype == torch.int8 and ours.t().is_contiguous()
    with pytest.raises(ValueError):
        convert.attn_block_weights(weights[:11], device="cpu")


# ------------------------------------------------- int8 GEMM ceiling (#13)


@jax.jit
def _ws_kernel_body(x, w):
    """tools_int8_ceiling.py:74-77's kernel body."""
    return jax.lax.dot_general(x, w, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32).astype(jnp.bfloat16)


def _column_for_sum(target: int, k: int) -> np.ndarray:
    """A w column whose product with the row [127] * (k - 1) + [1] is
    `target`: int8 codes summing to target // 127, the rest on the 1."""
    col = np.zeros(k, np.int64)
    a, rem = divmod(target, 127)
    full, part = divmod(a, 127)
    col[:full] = 127
    col[full] = part
    col[k - 1] = rem
    return col


def test_int8_ceiling_matches_kernel_body():
    """Random codes at K = 1152, and sums past 2^24 on bf16 rounding ties of
    the fp32 value: there XLA rounds twice (int32 -> fp32 -> bf16), as the
    plain version does, and not as one rounding of the exact sum would."""
    rng = np.random.default_rng(32)
    k = 1152
    x = rng.integers(-127, 128, (40, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, 72)).astype(np.int8)
    x[0] = 127
    x[0, k - 1] = 1
    # in [2^24, 2^25), one past a bf16 tie; the fp32 rounding lands on the
    # tie, which rounds down when the multiple of 2^17 below is even
    targets = [(128 + i) * 131072 + 65537 for i in range(8)]
    for j, target in enumerate(targets):
        w[:, j] = _column_for_sum(target, k)
    want = np.asarray(_ws_kernel_body(jnp.asarray(x), jnp.asarray(w)), np.float32)
    got = int8_ceiling.int8_gemm_bf16(_t(x), quant.column_major(_t(w)))
    assert got.shape == (40, 72) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    exact = (x.astype(np.int64) @ w.astype(np.int64))[0, :8]
    np.testing.assert_array_equal(exact, targets)
    q, r = np.divmod(exact, 131072)  # one rounding to the bf16 spacing of [2^24, 2^25)
    single = np.where(r > 65536, q + 1, q) * 131072
    assert (single != want[0, :8]).sum() == 4, "the even ties round twice"


# ---------------------------------------------------------- decode GEMV (#14)


@jax.jit
def _gemv_kernel_body(x, w):
    """tools_gemv_bench.py:24-29's kernel body."""
    return jnp.dot(x.astype(jnp.float32), w.astype(jnp.float32),
                   preferred_element_type=jnp.float32).astype(x.dtype)


@pytest.mark.parametrize("k,n", [(896, 4864), (4864, 896), (1000, 777)])
def test_gemv_matches_kernel_body(k, n):
    """The tool's two shapes (896 is not a multiple of the TPU version's
    768-wide block) and odd ones. fp32 sums in another order may land a
    bf16 output one step away."""
    rng = np.random.default_rng(33)
    x = jnp.asarray(rng.standard_normal((1, k)) * 0.1, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.02, jnp.bfloat16)
    want = np.asarray(_gemv_kernel_body(x, w), np.float32)
    got = tgemv.gemv(_t(np.asarray(x, np.float32)).to(torch.bfloat16),
                     _t(np.asarray(w, np.float32)).to(torch.bfloat16))
    assert got.shape == (1, n) and got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -8 * np.abs(want) + 1e-7).all(), diff.max()


def test_gemv_chain_and_split_plan():
    x, w1, w2 = (torch.randn(*shape).to(torch.bfloat16)
                 for shape in ((1, 64), (2, 64, 96), (2, 96, 64)))
    y = tgemv.chain(tgemv.gemv, x, w1, w2)
    want = x
    for l in range(2):
        want = tgemv.gemv_reference(tgemv.gemv_reference(want, w1[l]), w2[l])
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert tgemv.chain_bytes(x, w1, w2) == 2 * (2 * 64 * 96 + 2 * (64 + 96)) * 2
    for k, n, vec in ((896, 4864, 8), (4864, 896, 8), (1000, 777, 1), (5, 3, 1)):
        splits, rows = tgemv.split_plan(k, n, vec, sms=132)
        assert rows % 8 == 0 and splits * rows >= k > (splits - 1) * rows
        assert 1 <= splits <= 65535


# ----------------------------------------------------------------- wrappers


def test_new_wrappers_take_plain_versions_on_cpu():
    counters = (flash.flash_attention_merge_heads_int8_scores, attn_block.fused_attn_block_int8,
                int8_ceiling.int8_gemm_bf16, tgemv.gemv)
    before = [fn.launches for fn in counters]
    q = torch.randn(1, 2, 9, 72).to(torch.bfloat16)
    vl = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        flash.flash_attention_merge_heads_int8_scores(q, q, q, vl, block_q=8),
        flash.flash_attention_merge_heads_int8_scores_reference(q, q, q, vl, block_q=8),
        rtol=0, atol=0)
    hidden, ln_w, ln_b, weights = _block_setup(b=1, s=9, h=64)
    args = (_t(hidden), _t(ln_w), _t(ln_b), *convert.attn_block_weights(weights, device="cpu"))
    torch.testing.assert_close(attn_block.fused_attn_block_int8(*args, nh=2, valid=7),
                               attn_block.fused_attn_block_int8_reference(*args, nh=2, valid=7),
                               rtol=0, atol=0)
    xq = torch.randint(-127, 128, (5, 32), dtype=torch.int8)
    wq = quant.column_major(torch.randint(-127, 128, (32, 6), dtype=torch.int8))
    torch.testing.assert_close(int8_ceiling.int8_gemm_bf16(xq, wq),
                               int8_ceiling.int8_gemm_bf16_reference(xq, wq), rtol=0, atol=0)
    x, w = torch.randn(1, 20).to(torch.bfloat16), torch.randn(20, 7).to(torch.bfloat16)
    torch.testing.assert_close(tgemv.gemv(x, w), tgemv.gemv_reference(x, w), rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before  # no kernel on the CPU


def test_new_wrappers_reject_bad_arguments():
    q = torch.randn(1, 2, 9, 72).to(torch.bfloat16)
    vl = torch.tensor([9], dtype=torch.int32)
    with pytest.raises(ValueError):
        flash.flash_attention_merge_heads(q, q, q, vl, int8_scores=True, block_q=0)
    with pytest.raises(ValueError):
        flash.flash_attention_merge_heads_int8_scores(q, q[:, :, :5], q, vl)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        flash.flash_attention_merge_heads_int8_scores(*(x.to("meta") for x in (q, q, q)),
                                                      vl.to("meta"))

    hidden, ln_w, ln_b, weights = _block_setup(b=1, s=9, h=64)
    args = [_t(hidden), _t(ln_w), _t(ln_b), *convert.attn_block_weights(weights, device="cpu")]
    with pytest.raises(ValueError):
        attn_block.fused_attn_block_int8(*args, nh=3, valid=9)  # 64 does not split into 3
    with pytest.raises(ValueError):
        attn_block.fused_attn_block_int8(*args, nh=2, valid=-1)
    with pytest.raises(ValueError):
        attn_block.fused_attn_block_int8(args[0][0], *args[1:], nh=2, valid=9)
    bad = list(args)
    bad[12] = bad[12][:, :32]  # wo not (H, H)
    with pytest.raises(ValueError):
        attn_block.fused_attn_block_int8(*bad, nh=2, valid=9)
    with pytest.raises(ValueError):
        attn_block.fused_attn_block_int8(*(a.to("meta") for a in args), nh=2, valid=9)

    xq = torch.randint(-127, 128, (5, 32), dtype=torch.int8)
    wq = quant.column_major(torch.randint(-127, 128, (32, 6), dtype=torch.int8))
    with pytest.raises(TypeError):
        int8_ceiling.int8_gemm_bf16(xq.float(), wq)
    with pytest.raises(ValueError):
        int8_ceiling.int8_gemm_bf16(xq, wq[:16])
    with pytest.raises(ValueError):
        int8_ceiling.int8_gemm_bf16(xq.to("meta"), wq.to("meta"))

    x, w = torch.randn(1, 20).to(torch.bfloat16), torch.randn(20, 7).to(torch.bfloat16)
    with pytest.raises(ValueError):
        tgemv.gemv(x.expand(2, 20), w)  # not one row
    with pytest.raises(ValueError):
        tgemv.gemv(x, w[:10])
    with pytest.raises(ValueError):
        tgemv.gemv(x.to("meta"), w.to("meta"))


# ------------------------------------------- the card's check, on the CPU


def _merge_case():
    rng = np.random.default_rng(7)
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, 2, 4, 200, 72))
    valid = torch.tensor([200, 150], dtype=torch.int32)
    return (q, k, v, valid), flash.flash_attention_merge_heads_int8_scores_reference(q, k, v, valid)


def _block_case():
    import chip_smoke

    gen = torch.Generator()
    gen.manual_seed(7)
    args = chip_smoke._block_args(gen, 2, 100, 256, torch.bfloat16, "cpu")
    return args, attn_block.fused_attn_block_int8_reference(*args, nh=4, valid=100)


def _merge_control(name):
    import chip_smoke

    (q, k, v, valid), ref = _merge_case()
    got = {"exact merge": lambda: flash.flash_attention_merge_heads(q, k, v, valid),
           # S 200 takes 8-row q tiles; block_q 4 takes 4
           "q tiles of 4 rows": lambda: flash.flash_attention_merge_heads_int8_scores_reference(
               q, k, v, valid, block_q=4),
           "K/V scales per 64 keys": lambda: chip_smoke._int8_scores_kv_per_block(q, k, v, valid),
           }[name]()
    return chip_smoke._bit_close(name, got, ref)


def _block_control(name):
    import chip_smoke

    args, ref = _block_case()
    merge_path, oproj_path = chip_smoke._composed_halves(args, 4, 100)
    got = {"qkv -> merge -> int8_linear": merge_path, "qkv -> out_proj_int8": oproj_path}[name]()
    return chip_smoke._bit_close(name, got.to(ref.dtype), ref, args[0])


@pytest.mark.parametrize("control", ["exact merge", "q tiles of 4 rows", "K/V scales per 64 keys",
                                     "qkv -> merge -> int8_linear", "qkv -> out_proj_int8"])
def test_chip_smoke_kernel_check_fails_neighbouring_functions(control):
    """chip_smoke holds the int8_scores merge and #12 to their plain versions
    by the share of bit-equal elements and the RMS over the spread
    (`_bit_close`); each neighbouring function it runs as a control on the
    card fails that check here too, at a small size on the plain versions."""
    row = (_block_control(control) if control.startswith("qkv") else _merge_control(control))
    assert not row["held"], row


def test_chip_smoke_kernel_check_holds_the_function_itself():
    """The same check passes the plain versions against themselves, and the
    control `_int8_scores_kv_per_block` with one block over the whole key
    axis, which is the int8_scores function again (its products run as
    dequantized float64 values, so a few elements round apart)."""
    import chip_smoke

    (q, k, v, valid), ref = _merge_case()
    assert chip_smoke._bit_close("self", ref.clone(), ref)["held"]
    row = chip_smoke._bit_close("one block", chip_smoke._int8_scores_kv_per_block(
        q, k, v, valid, block=200), ref)
    assert row["held"], row
    args, ref = _block_case()
    assert chip_smoke._bit_close("self", ref.clone(), ref, args[0])["held"]
