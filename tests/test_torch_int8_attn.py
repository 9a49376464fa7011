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
import re

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st
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


@pytest.mark.parametrize("s", [1, 65, 129])
def test_attn_block_matches_pallas_interpret_at_kernel_edges(s):
    """The card's edge cases of #12 (chip_smoke.phase_int8_attn_kernels):
    rows ragged against the 128-row tiles at the tower's width, 16 heads."""
    got, want = _block_pair(*_block_setup(b=1, s=s, h=1152), nh=16, valid=s, block_r=256)
    assert got.shape == (1, s, 1152)
    _assert_close_but_for_flips(got, want, flip=BLOCK_FLIP)


def _head_products(codes, head_stride, wo_padded, nh, kp):
    """Each head's int32 product as the card's out-projection reads it: kp
    codes of the head from column h * head_stride against rows h * kp ..
    of the padded Wo (zeros past either's end, as TMA fills them)."""
    m, n = codes.shape[0], wo_padded.shape[1]
    wide = torch.cat([codes, torch.zeros((m, kp), dtype=codes.dtype)], dim=1)
    tall = torch.cat([wo_padded, torch.zeros((kp, n), dtype=wo_padded.dtype)])
    return [wide[:, h * head_stride:h * head_stride + kp].long()
            @ tall[h * kp:(h + 1) * kp].long() for h in range(nh)]


def test_padded_head_rows_give_the_per_head_products_exactly():
    """`attn_block.pad_head_rows` (the Wo the kernel reads, head rows
    zero-padded from 72 to 96): with the codes padded per head (zeros past
    hd) or not (the next head's codes past hd, zeros past the last head),
    every head's padded product equals its unpadded one exactly. Non-zero
    pad rows, or a pad that is not the wgmma depth, do not."""
    rng = np.random.default_rng(12)
    m, nh, hd, n = 5, 4, 72, 64
    kp = attn_block.padded_head_dim(hd)
    assert kp == 96 and [attn_block.padded_head_dim(d) for d in (32, 64, 128)] == [32, 64, 128]
    oq = torch.from_numpy(rng.integers(-127, 128, (m, nh * hd), dtype=np.int8))
    wo = quant.column_major(torch.from_numpy(rng.integers(-127, 128, (nh * hd, n),
                                                          dtype=np.int8)))
    wp = attn_block.pad_head_rows(wo, nh)
    assert tuple(wp.shape) == (nh * kp, n) and wp.dtype == torch.int8
    assert wp.t().is_contiguous()  # column-major, as the kernel reads it
    want = [oq[:, h * hd:(h + 1) * hd].long() @ wo[h * hd:(h + 1) * hd].long()
            for h in range(nh)]
    padded = torch.zeros((m, nh, kp), dtype=torch.int8)
    padded[:, :, :hd] = oq.view(m, nh, hd)
    for codes, stride in ((padded.reshape(m, nh * kp), kp), (oq, hd)):
        for got, ref in zip(_head_products(codes, stride, wp, nh, kp), want):
            assert torch.equal(got, ref)
    bad = wp.clone()
    bad[hd] = 1  # a pad row of head 0, which reads head 1's first codes
    assert not torch.equal(_head_products(oq, hd, bad, nh, kp)[0], want[0])
    short = torch.zeros((n, nh, 80), dtype=torch.int8)  # padded to 80, not 96
    short[:, :, :hd] = wo.t().reshape(n, nh, hd)
    short = short.reshape(n, nh * 80).t()
    assert not all(torch.equal(g, r) for g, r in zip(_head_products(oq, hd, short, nh, kp), want))
    with pytest.raises(ValueError):
        attn_block.pad_head_rows(wo, 5)


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


@pytest.mark.parametrize("n", [72, 33, 1])
def test_int8_ceiling_matches_kernel_body(n):
    """Random codes at K = 1152, and sums past 2^24 on bf16 rounding ties of
    the fp32 value: there XLA rounds twice (int32 -> fp32 -> bf16), as the
    plain version does, and not as one rounding of the exact sum would. N
    even, odd (33) and a single column: the s8 wgmma core masks the ragged
    edge."""
    rng = np.random.default_rng(32)
    k = 1152
    x = rng.integers(-127, 128, (40, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    x[0] = 127
    x[0, k - 1] = 1
    # in [2^24, 2^25), one past a bf16 tie; the fp32 rounding lands on the
    # tie, which rounds down when the multiple of 2^17 below is even
    targets = [(128 + i) * 131072 + 65537 for i in range(min(8, n))]
    for j, target in enumerate(targets):
        w[:, j] = _column_for_sum(target, k)
    want = np.asarray(_ws_kernel_body(jnp.asarray(x), jnp.asarray(w)), np.float32)
    got = int8_ceiling.int8_gemm_bf16(_t(x), quant.column_major(_t(w)))
    assert got.shape == (40, n) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    exact = (x.astype(np.int64) @ w.astype(np.int64))[0, :len(targets)]
    np.testing.assert_array_equal(exact, targets)
    q, r = np.divmod(exact, 131072)  # one rounding to the bf16 spacing of [2^24, 2^25)
    single = np.where(r > 65536, q + 1, q) * 131072
    even_ties = (len(targets) + 1) // 2
    assert (single != want[0, :len(targets)]).sum() == even_ties, "the even ties round twice"


def test_no_mma_sync_gemm_is_left():
    """Every int8 product runs on the s8 wgmma core: no int8 or bf16
    mma.sync instruction, no int8k::gemm_kernel and none of its helpers (the
    s8 m16n8k32 mma, the cp.async copies, 32-bit fragment loads) is left in
    the kernel sources. The one mma.sync left is the fp32 flash kernels'
    TF32 product (tf32.cuh, shared by flash_fwd.cu's forward and
    flash_train.cu's backward: wgmma reads B from shared memory as it lies,
    K-major in tf32, so a 3xTF32 form would stage each operand twice, as hi
    and lo, and V transposed)."""
    from memory_augmented_vlm_torch.ops import cuda_lib

    for path in sorted(cuda_lib.CSRC_DIR.iterdir()):
        text = path.read_text()
        for gone in ("gemm_kernel(", "launch_gemm(", "mma_s8_16832",
                     "cp_async16", "cp.async.commit_group", "cp_async_wait", "lds32"):
            assert gone not in text, (path.name, gone)
        for mma in re.findall(r"mma\.sync\.aligned[\w.]*", text):
            assert (path.name, mma) == ("tf32.cuh",
                                        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32")


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
    # one bf16 spacing of `want`: 2^(e - 7) in the binade [2^e, 2^(e+1))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (diff <= step).all(), (diff - step).max()


def _gemv_up_case():
    """The tool's up product (896 -> 4864) at its operands' scales."""
    rng = np.random.default_rng(34)
    x = _t(rng.standard_normal((1, tgemv.H)) * 0.1).float().to(torch.bfloat16)
    w = _t(rng.standard_normal((tgemv.H, tgemv.I)) * 0.02).float().to(torch.bfloat16)
    return x, w, tgemv.gemv_reference(x, w)


GEMV_CONTROLS = ["the last K split dropped", "fp32 partial sums rounded to bf16 before the sum",
                 "the product summed in bf16"]


@pytest.mark.parametrize("control", GEMV_CONTROLS)
def test_chip_smoke_gemv_check_fails_neighbouring_functions(control):
    """chip_smoke holds #14's single products to their plain version by
    `_bit_close`; each neighbouring function it runs as a control on the
    card (`_gemv_controls`, split as on a 132-SM H100) fails that check here
    too, on the plain versions."""
    import chip_smoke

    x, w, ref = _gemv_up_case()
    got = dict(chip_smoke._gemv_controls(x, w, sms=132))[control]()
    row = chip_smoke._bit_close(control, got, ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert not row["held"], row


def test_chip_smoke_gemv_check_holds_the_function_itself():
    """The same check passes the plain version against itself, and the
    kernel's own arithmetic: fp32 sums over each cluster rank's slice of K
    (`gemv.plan` on a 132-SM H100), added in rank order, rounded once to
    bf16."""
    import chip_smoke

    x, w, ref = _gemv_up_case()
    assert chip_smoke._bit_close("self", tgemv.gemv_reference(x, w), ref)["held"]
    acc = None
    for a, b in tgemv.plan(tgemv.H, tgemv.I, sms=132).slices(tgemv.H):
        part = x[:, a:b].float() @ w[a:b].float()
        acc = part if acc is None else acc + part
    row = chip_smoke._bit_close("rank sums", acc.to(torch.bfloat16), ref)
    assert row["held"], row


@pytest.mark.parametrize("k,n,cols", [(896, 4864, 128), (4864, 896, 64), (896, 200, 32),
                                      (896, 4100, 128), (1000, 777, 64), (5, 3, 32),
                                      (30000, 24, 32)])
def test_gemv_in_kernel_order_sums_by_rank(k, n, cols):
    """The kernel's summation emulated on the CPU (`gemv_in_kernel_order`:
    per thread over every RG-th row, the warp's row groups pairwise, the
    warps in order, the ranks in order; chip_smoke holds the kernel to it
    bit for bit) passes chip_smoke's check against the plain version and
    against the fp32 rank sums added in rank order, rounded once, at each
    strip width the plan picks (`cols`). At K = 30000 a rank's slice is
    larger than a tile and is read in passes."""
    import chip_smoke

    rng = np.random.default_rng(35)
    x = _t(rng.standard_normal((1, k)) * 0.1).float().to(torch.bfloat16)
    w = _t(rng.standard_normal((k, n)) * 0.02).float().to(torch.bfloat16)
    pl = tgemv.plan(k, n, sms=132)
    assert pl.cols == cols
    got = tgemv.gemv_in_kernel_order(x, w, pl)
    assert got.shape == (1, n) and got.dtype == torch.bfloat16
    row = chip_smoke._bit_close("kernel order", got, tgemv.gemv_reference(x, w))
    assert row["held"], row
    ranks = [x[:, a:b].float() @ w[a:b].float() for a, b in pl.slices(k)]
    total = ranks[0]
    for part in ranks[1:]:
        total = total + part
    row = chip_smoke._bit_close("rank order", got, total.to(torch.bfloat16))
    assert row["held"], row
    assert (pl.rows > pl.tile_rows) == (k == 30000)


def test_gemv_chain_and_split_plan():
    """The chain, and the kernel's partition (`gemv.plan`): every row of K
    in exactly one rank's slice, no rank without rows, at most 16 ranks (a
    cluster), passes and TMA boxes that tile each slice, a tile within
    TILE_BYTES, every strip width taken by some shape, and at least one
    block per SM at both tool shapes."""
    x, w1, w2 = (torch.randn(*shape).to(torch.bfloat16)
                 for shape in ((1, 64), (2, 64, 96), (2, 96, 64)))
    y = tgemv.chain(tgemv.gemv, x, w1, w2)
    want = x
    for l in range(2):
        want = tgemv.gemv_reference(tgemv.gemv_reference(want, w1[l]), w2[l])
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert tgemv.chain_bytes(x, w1, w2) == 2 * (2 * 64 * 96 + 2 * (64 + 96)) * 2
    shapes = ((896, 4864), (4864, 896), (1000, 777), (5, 3), (4864, 900), (33, 4104),
              (896, 200), (896, 4100), (38, 128), (100000, 64), (1, 1))
    for k, n in shapes:
        pl = tgemv.plan(k, n, sms=132)
        covered = [r for a, b in pl.slices(k) for r in range(a, b)]
        assert covered == list(range(k)), (k, n, pl)
        assert all(b > a for a, b in pl.slices(k)) and 1 <= pl.cluster <= 16
        assert pl.rows % pl.tile_rows == 0 and pl.tile_rows % pl.box_rows == 0
        assert pl.box_rows % 8 == 0 and pl.box_rows <= tgemv.MAX_BOX_ROWS
        assert pl.tile_rows * pl.cols * 2 <= tgemv.TILE_BYTES
    assert {tgemv.plan(k, n, sms=132).cols for k, n in shapes} == set(tgemv.STRIP_COLS)
    for k, n in ((tgemv.H, tgemv.I), (tgemv.I, tgemv.H)):
        pl = tgemv.plan(k, n, sms=132)
        assert pl.strips(n) * pl.cluster >= 132
    # the widest strip that fills the SMs: 256-byte rows up, 128-byte down
    assert tgemv.plan(tgemv.H, tgemv.I, sms=132) == (128, 4, 224, 224, 224)
    assert tgemv.plan(tgemv.I, tgemv.H, sms=132) == (64, 10, 496, 496, 248)


def test_micro_ab_calls_only_entry_points_every_tree_has():
    """microbench/micro_ab.py also runs against older trees of the port:
    of the kernels' modules it calls only entry points that trees have had
    since #13 and #14 were ported, and its ptxas report (`mlp_ab`'s, with
    micro_ab's pattern) keeps #13's GEMM and #14's kernels, the mma.sync
    and split-K ones of older trees alike."""
    import ast
    import inspect

    from memory_augmented_vlm_torch.microbench import micro_ab, mlp_ab

    modules = {"gemv", "int8_ceiling", "cuda_lib"}
    used = {(n.value.id, n.attr) for n in ast.walk(ast.parse(inspect.getsource(micro_ab)))
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id in modules}
    assert used == {("gemv", "gemv"), ("gemv", "chain"), ("gemv", "operands"),
                    ("gemv", "gemv_reference"), ("int8_ceiling", "int8_gemm_bf16"),
                    ("int8_ceiling", "operands"), ("cuda_lib", "load"),
                    ("cuda_lib", "BUILD_LOG")}
    log = """ptxas info    : Compiling entry function '_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN14Int32ToBf16OutEEEv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN5int8k11gemm_kernelI14Int32ToBf16EpiEEvPKa' for 'sm_90a'
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_Z19gemv_partial_kernelILi8EEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Used 40 registers
ptxas info    : Compiling entry function '_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN6QkvOutEEEv' for 'sm_90a'
ptxas info    : Used 90 registers, used 2 barriers"""
    report = mlp_ab.ptxas_report(log, micro_ab.KERNELS)
    assert list(report) == ["_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN14Int32ToBf16OutEEEv",
                            "_ZN5int8k11gemm_kernelI14Int32ToBf16EpiEEvPKa",
                            "_Z19gemv_partial_kernelILi8EEvPK13__nv_bfloat16"]
    assert "0 bytes spill stores" in report[
        "_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN14Int32ToBf16OutEEEv"]


def test_gemv_chain_overlaps_each_product_after_the_first(monkeypatch):
    """`chain` launches the kernel as a programmatic dependent (`overlap`)
    only where the grid before is its own previous product, which writes no
    weight: never its first product, whose grid before is the caller's.
    Other functions are chained as they are."""
    calls = []
    real = tgemv.gemv

    def spy(x, w, *, overlap=False):
        calls.append(overlap)
        return real(x, w, overlap=overlap)

    monkeypatch.setattr(tgemv, "gemv", spy)
    x, w1, w2 = (torch.randn(*shape).to(torch.bfloat16)
                 for shape in ((1, 16), (3, 16, 24), (3, 24, 16)))
    y = tgemv.chain(tgemv.gemv, x, w1, w2)
    assert calls == [False] + [True] * 5
    torch.testing.assert_close(y, tgemv.chain(tgemv.gemv_reference, x, w1, w2), rtol=0, atol=0)
    assert calls == [False] + [True] * 5  # the plain version is chained as it is


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


def _int8_scores_from_prep(q, valid, kq, vt, scales, block_q):
    """The int8_scores function contracted as csrc/flash_merge_int8.cu
    contracts it, from the prep pass's codes: QK^T over the K codes' padded
    depth, and PV with the P codes put in the V^T codes' key order
    (`int8_scores_key_order`), keys past S coded 0. Integer products run in
    float64, where they are exact."""
    b, nh, s, d = q.shape
    dk, sp = kq.shape[-1], vt.shape[-1]
    tile = flash.merge_q_tile(s, block_q)
    nt = -(-s // tile)
    qf = torch.nn.functional.pad(q.float() * (d ** -0.5 * flash.LOG2E),
                                 (0, dk - d, 0, nt * tile - s)).view(b, nh, nt, tile, dk)
    sq = flash._scalar_scale(qf)
    qq = flash._codes(qf, sq).view(b, nh, nt * tile, dk)[:, :, :s]
    sq = sq.view(b, nh, nt, 1).repeat_interleave(tile, dim=2)[:, :, :s]
    sk, sv = scales[..., 0, None, None], scales[..., 1, None, None]
    raw = torch.matmul(qq.double(), kq.double().transpose(-1, -2)).float()
    keep = torch.arange(s)[None, :] < valid[:, None]
    sc = torch.where(keep[:, None, None, :], raw * (sq * sk), flash.MASK_VALUE)
    p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    codes = torch.nn.functional.pad(torch.round(p * 127.0), (0, sp - s))
    placed = codes[..., flash.int8_scores_key_order(sp)]
    acc = torch.matmul(placed.double(), vt.double().transpose(-1, -2)).float()
    out = (acc * ((sv / 127.0) / l)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, nh * d)


@settings(max_examples=30, deadline=None)
@given(s=st.integers(1, 200), d=st.sampled_from([64, 72, 128]),
       block_q=st.sampled_from([128, 16, 8]), valid0=st.integers(0, 210),
       seed=st.integers(0, 2 ** 16))
def test_int8_scores_prep_codes_contract_to_the_reference(s, d, block_q, valid0, seed):
    """The plain version of the kernel's prep pass (scales; K codes with a
    zero depth pad to 96 at D 72; V^T codes in PV's key order, zero past S)
    contracted in the kernel's order gives the int8_scores reference's
    output exactly: any S (a ragged last q tile, keys past a 32-key step),
    valid lengths 0, ragged and past S."""
    rng = np.random.default_rng(seed)
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, 2, 2, s, d))
    valid = torch.tensor([valid0, min(valid0, s) // 2], dtype=torch.int32)
    kq, vt, scales = flash.merge_int8_prep_reference(k, v)
    dk, sp = -(-d // 32) * 32, -(-s // 16) * 16
    assert kq.shape == (2, 2, s, dk) and kq.dtype == torch.int8
    assert vt.shape == (2, 2, d, sp) and vt.dtype == torch.int8
    assert not kq[..., d:].any()
    order = flash.int8_scores_key_order(sp)
    assert not vt[..., order >= s].any()
    got = _int8_scores_from_prep(q, valid, kq, vt, scales, block_q)
    want = flash.flash_attention_merge_heads_int8_scores_reference(q, k, v, valid, block_q=block_q)
    assert torch.equal(got, want)


def test_int8_scores_key_order_is_the_fragment_order():
    """Place 4t + e of each 16 holds the thread's e-th P code: keys 2t,
    2t + 1 of its first 8-key chunk, then 8 + 2t, 9 + 2t (the 8-bit A
    fragment of the k32 wgmma and mma.sync); the order is a permutation
    inside each 32-key step."""
    order = flash.int8_scores_key_order(64)
    for base in (0, 16, 32, 48):
        for t in range(4):
            assert order[base + 4 * t: base + 4 * t + 4].tolist() == [
                base + 2 * t, base + 2 * t + 1, base + 8 + 2 * t, base + 9 + 2 * t]
    assert sorted(order.tolist()) == list(range(64))


def test_merge_int8_prep_takes_its_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    _, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, 1, 2, 40, 72))
    before = flash.merge_int8_prep.launches
    for got, want in zip(flash.merge_int8_prep(k, v), flash.merge_int8_prep_reference(k, v)):
        assert torch.equal(got, want)
    assert flash.merge_int8_prep.launches == before
    with pytest.raises(ValueError):
        flash.merge_int8_prep(k, v[:, :1])
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        flash.merge_int8_prep(k.to("meta"), v.to("meta"))


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


def _exact_merge_case():
    rng = np.random.default_rng(9)
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, 2, 4, 200, 72))
    valid = torch.tensor([200, 150], dtype=torch.int32)
    return (q, k, v, valid), flash.flash_attention_merge_heads_reference(q, k, v, valid)


MERGE_CONTROLS = ["scaled_dot_product_attention", "P left in fp32 for PV",
                  "q not rounded to bf16", "#1's online softmax"]


@pytest.mark.parametrize("control", MERGE_CONTROLS)
def test_chip_smoke_merge_check_fails_neighbouring_functions(control):
    """chip_smoke holds the exact merge (#2) to its plain version by
    `_bit_close`, at the bounds the int8 kernels share; each neighbouring function it runs as a
    control on the card fails that check here too, on the plain versions."""
    import chip_smoke

    args, ref = _exact_merge_case()
    got = dict(chip_smoke._merge_controls(*args))[control]()
    row = chip_smoke._bit_close(control, got.to(ref.dtype), ref)
    assert not row["held"], row


def test_chip_smoke_merge_check_holds_the_function_itself():
    """The same check passes the plain merge against itself, and against the
    controls' own code with nothing changed: `_merge_variant` rounding q and
    P, and the online softmax over one block of all keys (whose running max
    is the final max)."""
    import chip_smoke

    (q, k, v, valid), ref = _exact_merge_case()
    assert chip_smoke._bit_close("self", ref.clone(), ref)["held"]
    for name, got in (("variant", chip_smoke._merge_variant(q, k, v, valid)),
                      ("one block", chip_smoke._online_merge(q, k, v, valid, block=200))):
        row = chip_smoke._bit_close(name, got, ref)
        assert row["held"], row


def test_merge_ab_reads_the_ptxas_report():
    """The A/B timing tool keeps, of nvcc's -Xptxas -v output, the
    registers and spills of the merge-heads kernels only."""
    from memory_augmented_vlm_torch.microbench import merge_ab

    log = """ptxas info    : Compiling entry function '_ZN5mavlm9two_sweep6kernelILi72EE' for 'sm_90a'
ptxas info    : Function properties for _ZN5mavlm9two_sweep6kernelILi72EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 142 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z13gemv_kernelPKv' for 'sm_90a'
ptxas info    : Used 40 registers"""
    report = merge_ab.ptxas_report(log)
    assert list(report) == ["_ZN5mavlm9two_sweep6kernelILi72EE"]
    assert "Used 142 registers" in report["_ZN5mavlm9two_sweep6kernelILi72EE"]
    assert "0 bytes spill stores" in report["_ZN5mavlm9two_sweep6kernelILi72EE"]


def test_qkv_ab_calls_only_entry_points_every_tree_has():
    """microbench/qkv_ab.py also runs against the parent tree of the port:
    of the port's modules it calls only entry points that trees have had
    since #12 was ported, and the ptxas report it takes from mlp_ab keeps
    #12's out-projection beside the int8 GEMM kernels."""
    import ast
    import inspect

    from memory_augmented_vlm_torch.microbench import mlp_ab, qkv_ab

    modules = {"qkv_int8", "attn_block", "siglip", "quant", "cuda_lib"}
    used = {(n.value.id, n.attr) for n in ast.walk(ast.parse(inspect.getsource(qkv_ab)))
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id in modules}
    assert used == {("qkv_int8", "fused_qkv_int8"), ("attn_block", "fused_attn_block_int8"),
                    ("siglip", "init_params"), ("siglip", "prequantize_int8"),
                    ("siglip", "forward"), ("quant", "prequantize_kernel"),
                    ("quant", "column_major"), ("cuda_lib", "load"), ("cuda_lib", "BUILD_LOG")}
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123oproj_heads_sm90_kernelILi72ELi64ELi2EfEEv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN6QkvOutEEEv' for 'sm_90a'
ptxas info    : Used 90 registers, used 2 barriers
ptxas info    : Compiling entry function '_Z13gemv_kernelPKv' for 'sm_90a'
ptxas info    : Used 40 registers"""
    oproj = "_ZN12_GLOBAL__N_123oproj_heads_sm90_kernelILi72ELi64ELi2EfEEv"
    report = mlp_ab.ptxas_report(log)
    assert list(report) == [oproj, "_ZN5int8h16gemm_sm90_kernelILi1ELi128ELi2EN6QkvOutEEEv"]
    assert "Used 80 registers" in report[oproj] and "0 bytes spill stores" in report[oproj]
