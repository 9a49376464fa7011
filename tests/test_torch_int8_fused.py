"""The port's fused int8 serving configuration and standalone w8a8 layer
against the JAX package on the CPU.

Each kernel's plain version is held against its Pallas kernel in interpret
mode (as tests/test_pallas_int8.py and tests/test_pallas_flash.py run them):
`int8_matmul`, `fused_mlp_int8`, `fused_swiglu_block_int8` and
`flash_attention_out_proj_int8`. Then the tower with `fused_oproj=True`
against JAX's, the LM's `_mlp_half` gate and a fused prefill, and the
wrappers' argument checks.

Tolerances: products of int8 codes are exact on both sides, so fp32 results
differ only by the order of fp32 sums and by the last bit of a scale or a
transcendental (1e-5); a bf16 output may land one bf16 step away. Where a
value sits on an int8 rounding tie, such a last-bit difference flips one
code, and every output of that row moves by up to one code step (row scale
x channel scale x |weight code|). Ties are not rare: bf16 inputs sit on them
whenever the row max is a power of two, and XLA's jitted CPU code rounds a
row scale differently from its own eager code (2 codes of 3024 differ
between `jax.jit(quantize_rows)` and `quantize_rows` on bf16 inputs). So a
kernel comparison holds at least 97% of the elements to the tight tolerance
and every element to it plus a stated code step (`_assert_close_but_for_flips`).
"""

import dataclasses
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.ops import pallas_int8 as jpallas_int8
from memory_augmented_vlm_tpu.ops import pallas_mlp_int8 as jmlp
from memory_augmented_vlm_tpu.ops.pallas_flash import flash_attention_out_proj_int8
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import position_encoding as tpe
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.ops import (flash, int8_common, mlp_int8, pallas_int8,
                                            qkv_int8, quant, rope, swiglu_int8)
from test_torch_int8 import (BF16_STEP, F32, LM, TOWER, H, I, NH, _int8_tower, _int8_weight,
                             _t, _tower_vlm_cfg)


@pytest.fixture(autouse=True)
def swiglu_flag_is_off_around_each_test():
    assert tqwen2.fused_swiglu_enabled is False
    yield
    assert tqwen2.fused_swiglu_enabled is False


def _jdtype(name):
    return getattr(jnp, name)


def _tdtype(name):
    return getattr(torch, name)


def _assert_close_but_for_flips(got: torch.Tensor, want, flip: float, share: float = 0.97):
    """fp32: within rtol = atol = 1e-5; bf16: within one bf16 step; for at
    least `share` of the elements, and for all of them when `flip` (one int8
    code step of this test's weights) is added."""
    assert tuple(got.shape) == tuple(want.shape)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    tight = (1e-5 + 1e-5 * np.abs(want) if got.dtype == torch.float32
             else BF16_STEP * np.abs(want) + 1e-6)
    assert (diff <= tight).mean() >= share, (diff <= tight).mean()
    assert (diff <= tight + flip).all(), (diff - tight).max()


def _pallas_weight(rng, k, n, scale=0.1):
    """(JAX (w_int8, scale), port (w_int8 column-major, scale)) of one
    random (K, N) kernel through both packages' `quantize_weight`."""
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    return jpallas_int8.quantize_weight(w), pallas_int8.quantize_weight(w)


# --------------------------------------------------------------- #8 w8a8

def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(20)
    w = (rng.standard_normal((144, 72)) * 0.02).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero channel: the floor is on the scale itself, 1e-12
    jw, js = jpallas_int8.quantize_weight(w)
    for arg in (w, torch.from_numpy(w)):  # numpy, as JAX's takes it, or a tensor
        tw, ts = pallas_int8.quantize_weight(arg)
        assert tw.dtype == torch.int8 and tw.shape == (144, 72)
        assert tw.t().is_contiguous()  # column-major, the kernels' layout
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert float(ts[5]) == np.float32(1e-12)


LM_ROW_K, LM_ROW_N = 896, 4864  # the 0.5B LM's MLP up-projection


@pytest.mark.parametrize("m,n,bias,dtype", [
    (100, 200, False, "float32"),   # M and N off the Pallas blocks (32, 128)
    (100, 200, True, "float32"),
    (1, 200, True, "float32"),      # one row: JAX pads M to 8
    (37, 72, True, "bfloat16"),
    (64, 128, False, "bfloat16"),
    (37, 34, True, "bfloat16"),     # N even, not a multiple of 4: rows off 4-alignment
    (100, 33, True, "float32"),     # N odd, which the kernel takes on the card too
    (37, 33, False, "bfloat16"),
    (1, LM_ROW_N, False, "bfloat16"),  # the LM's decode row, 896 -> 4864, full width
])
def test_int8_matmul_matches_pallas_interpret(m, n, bias, dtype):
    rng = np.random.default_rng(21)
    k = LM_ROW_K if n == LM_ROW_N else H
    x = rng.standard_normal((m, k)).astype(np.float32)
    (jw, js), (tw, ts) = _pallas_weight(rng, k, n)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    want = jpallas_int8.int8_matmul(
        jnp.asarray(x, _jdtype(dtype)), jw, js, None if b is None else jnp.asarray(b),
        block_m=32, block_n=128, interpret=True)
    got = pallas_int8.int8_matmul(_t(x).to(_tdtype(dtype)), tw, ts,
                                  None if b is None else _t(b))
    assert got.shape == (m, n) and got.dtype == _tdtype(dtype)
    # the bias is added in fp32 before the one cast, on both sides; a code
    # step is row max / 127 * max|w| ~ 4 / 127 * 0.4
    _assert_close_but_for_flips(got, want, flip=2e-2)


def test_pallas_int8_linear_matches_jax():
    """JAX's CPU branch is its oracle (`x / s`); the port's plain version
    follows the kernel (`x * (1/s)`). The two agree except on a rounding
    tie, which these inputs do not hit."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((3, 7, H)).astype(np.float32)
    (jw, js), _ = _pallas_weight(rng, H, 96)
    bias = (rng.standard_normal(96) * 0.1).astype(np.float32)
    jqp = {"w_int8": jw, "scale": js, "bias": jnp.asarray(bias)}
    tqp = convert.int8_linear_params(jax.tree.map(np.asarray, jqp), device="cpu")
    assert not np.asarray(jw).T.flags["C_CONTIGUOUS"]  # row-major in JAX
    assert tqp["w_int8"].t().is_contiguous() and tqp["w_int8"].dtype == torch.int8
    want = jpallas_int8.int8_linear(jnp.asarray(x), jqp)
    got = pallas_int8.int8_linear(_t(x), tqp)
    assert got.shape == (3, 7, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # bf16 activations: cast before the fp32 bias, which promotes, as in JAX.
    # bf16 values do sit on rounding ties, where the oracle's `x / s` and the
    # kernels' `x * (1/s)` part ways: here JAX's TPU branch is taken, its
    # kernel interpreted, and the product is compared before the bias
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jpallas_int8.int8_matmul(jx.reshape(-1, H), jw, js, interpret=True).reshape(3, 7, 96)
    got = pallas_int8.int8_linear(_t(x).to(torch.bfloat16), tqp)
    assert got.dtype == torch.float32 and (want + jqp["bias"]).dtype == jnp.float32
    _assert_close_but_for_flips((got - _t(bias)).to(torch.bfloat16), want, flip=2e-2)


def test_int8_linear_params_default_to_the_card():
    assert inspect.signature(convert.int8_linear_params).parameters["device"].default == "cuda"


# ------------------------------------------------------- #6 fused_mlp_int8

@pytest.mark.parametrize("m,dtype", [(100, "float32"), (45, "float32"), (64, "bfloat16")])
def test_fused_mlp_int8_matches_pallas_interpret(m, dtype):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((m, H)).astype(np.float32)
    (j1, t1), (j2, t2) = _int8_weight(rng, H, I), _int8_weight(rng, I, H)
    want = jmlp.fused_mlp_int8(jnp.asarray(x, _jdtype(dtype)), *j1, *j2, block_m=32,
                               interpret=True)
    got = mlp_int8.fused_mlp_int8(_t(x).to(_tdtype(dtype)), *t1, *t2)
    assert got.shape == (m, H) and got.dtype == _tdtype(dtype)
    # a code step of fc2: GELU row max / 127 * max|w2| ~ 1.5 / 127 * 0.2
    _assert_close_but_for_flips(got, want, flip=4e-3)


def test_fused_mlp_int8_is_the_block_without_norm_and_residual():
    """With an identity LayerNorm the half-block is x + mlp(LN(x)); the bare
    kernel on the same normalised rows gives the mlp term."""
    rng = np.random.default_rng(24)
    x = _t(rng.standard_normal((33, H)).astype(np.float32))
    (_, t1), (_, t2) = _int8_weight(rng, H, I), _int8_weight(rng, I, H)
    ones, zeros = torch.ones(H), torch.zeros(H)
    normed = mlp_int8.layer_norm_f32(x, ones, zeros, 1e-6)
    block = mlp_int8.fused_mlp_block_int8(x, ones, zeros, *t1, *t2)
    torch.testing.assert_close(block, x + mlp_int8.fused_mlp_int8(normed, *t1, *t2),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------ #7 fused_swiglu_block_int8

def _swiglu_args(rng, k, i, scale=0.1):
    (jg, tg), (ju, tu), (jd, td) = (_pallas_weight(rng, k, i, scale),
                                    _pallas_weight(rng, k, i, scale),
                                    _pallas_weight(rng, i, k, scale))
    w = (1.0 + rng.standard_normal(k) * 0.05).astype(np.float32)
    return (jnp.asarray(w), *jg, *ju, *jd), (_t(w), *tg, *tu, *td)


@pytest.mark.parametrize("m,dtype", [(72, "float32"), (45, "float32"), (72, "bfloat16")])
def test_fused_swiglu_matches_pallas_interpret(m, dtype):
    rng = np.random.default_rng(25)
    hidden = rng.standard_normal((m, 64)).astype(np.float32)
    hidden[3] = 0.0  # the prompt's zero padding: x = 0, the floor scale, no NaN
    jargs, targs = _swiglu_args(rng, 64, 128)
    want = jmlp.fused_swiglu_block_int8(jnp.asarray(hidden, _jdtype(dtype)), *jargs,
                                        block_m=32, interpret=True)
    th = _t(hidden).to(_tdtype(dtype))
    got = swiglu_int8.fused_swiglu_block_int8(th, *targs)
    assert got.shape == (m, 64) and got.dtype == _tdtype(dtype)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[3], th[3], rtol=0, atol=0)  # hidden + 0
    # a code step of down: row max of silu(g) * u / 127 * max|wd| ~ 5 / 127 * 0.4
    _assert_close_but_for_flips(got, want, flip=2e-2)


@pytest.mark.parametrize("m", [1, 47, 65, 129])
@pytest.mark.parametrize("kernel", ["fused_mlp_block_int8", "fused_mlp_int8",
                                    "fused_swiglu_block_int8"])
def test_int8_mlp_plain_versions_match_pallas_at_the_gemm_core_edges(kernel, m):
    """On the card the Hopper GEMM core of #4, #6 and #7 is held to these
    plain versions at rows around its 64-row warpgroup and 128-row block
    edges, and at K = 144, I = 272 (multiples of 16, not of its 128-byte
    k-step); here the plain versions meet JAX's kernels (interpret mode) at
    the same shapes."""
    k, i = 144, 272
    rng = np.random.default_rng(26 + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if kernel == "fused_swiglu_block_int8":
        x[m // 2] = 0.0
        jargs, targs = _swiglu_args(rng, k, i)
        want = jmlp.fused_swiglu_block_int8(jnp.asarray(x), *jargs, block_m=32, interpret=True)
        got = swiglu_int8.fused_swiglu_block_int8(_t(x), *targs)
        torch.testing.assert_close(got[m // 2], _t(x)[m // 2], rtol=0, atol=0)
        flip = 2e-2
    else:
        (j1, t1), (j2, t2) = _int8_weight(rng, k, i), _int8_weight(rng, i, k)
        if kernel == "fused_mlp_int8":
            want = jmlp.fused_mlp_int8(jnp.asarray(x), *j1, *j2, block_m=32, interpret=True)
            got = mlp_int8.fused_mlp_int8(_t(x), *t1, *t2)
        else:
            lw = (1.0 + rng.standard_normal(k) * 0.05).astype(np.float32)
            lb = (rng.standard_normal(k) * 0.02).astype(np.float32)
            want = jmlp.fused_mlp_block_int8(jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lb),
                                             *j1, *j2, block_m=32, interpret=True)
            got = mlp_int8.fused_mlp_block_int8(_t(x), _t(lw), _t(lb), *t1, *t2)
        flip = 4e-3
    assert got.shape == (m, k) and bool(torch.isfinite(got).all())
    _assert_close_but_for_flips(got, want, flip=flip)


def test_silu_f32_is_silu():
    g = torch.linspace(-100, 100, 4001)  # exp(-g) overflows to inf below -88: 0, not NaN
    got = swiglu_int8.silu_f32(g)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, torch.nn.functional.silu(g), rtol=1e-6, atol=1e-30)


# ---------------------------------------- #5 flash_attention_out_proj_int8

def _oproj_inputs(seed, b=2, s=72):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, NH, s, 72)).astype(np.float32) for _ in range(3))
    hidden = rng.standard_normal((b, s, H)).astype(np.float32)
    (jw, js, jb), (tw, ts, tb) = _int8_weight(rng, H, H)
    return (q, k, v), hidden, (jw, js, jb), (tw, ts, tb)


@pytest.mark.parametrize("valid", [(72, 72), (72, 33), (0, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_proj_int8_matches_pallas_interpret(valid, dtype):
    """q/k/v bf16 as the tower feeds them; hidden fp32 or bf16. An exp2 one
    ulp apart can round a P, then a merged bf16 value, to its neighbour, and
    a merged value on an int8 tie then flips one code of the 144-wide row:
    a code step of the out-projection is row max / 127 * max|w| ~ 1 / 127 *
    0.2."""
    (q, k, v), hidden, jw, tw = _oproj_inputs(26)
    vl = np.asarray(valid, np.int32)
    want = flash_attention_out_proj_int8(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(vl),
        jnp.asarray(hidden, _jdtype(dtype)), *jw, block_q=8, interpret=True)
    got = flash.flash_attention_out_proj_int8(
        *(_t(x).to(torch.bfloat16) for x in (q, k, v)), _t(vl),
        _t(hidden).to(_tdtype(dtype)), *tw)
    assert got.dtype == _tdtype(dtype)
    _assert_close_but_for_flips(got, want, flip=2e-3)


def test_out_proj_int8_valid_length_zero_is_mean_of_v():
    (q, k, v), hidden, _, tw = _oproj_inputs(27)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    vl = torch.tensor([0, 72], dtype=torch.int32)
    got = flash.flash_attention_out_proj_int8(tq, tk, tv, vl, _t(hidden), *tw)
    # batch 0 sees no valid key: every row attends to the mean of V over all
    # keys, which then goes through the projection like any row
    mean_v = tv[0].float().mean(dim=1).reshape(1, 1, H).expand(1, 72, H).to(torch.bfloat16)
    want = _t(hidden)[:1] + quant.int8_linear(
        {"kernel_int8": tw[0], "scale": tw[1]}, mean_v).float() + tw[2]
    torch.testing.assert_close(got[:1], want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_proj_int8_reference_matches_composed(dtype):
    """The plain version against the port's own unfused layer, merge_heads +
    `quant.int8_linear` + residual (tests/test_pallas_flash.py holds the JAX
    pair to 2e-2 of the output's spread). They differ by roundings: the
    unfused product is cast to bf16 before the bias and the residual."""
    (q, k, v), hidden, _, (w, s, b) = _oproj_inputs(28)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    vl = torch.tensor([72, 50], dtype=torch.int32)
    hid = _t(hidden).to(_tdtype(dtype))
    got = flash.flash_attention_out_proj_int8_reference(tq, tk, tv, vl, hid, w, s, b)
    merged = flash.flash_attention_merge_heads(tq, tk, tv, vl)
    want = hid + quant.int8_linear({"kernel_int8": w, "scale": s, "bias": b}, merged).to(
        hid.dtype)
    rel = float((got.float() - want.float()).std() / want.float().std())
    assert rel < 5e-3, rel


# ---------------------------------------------------------------- the tower

def test_fused_oproj_tower_matches_jax():
    """The port's three-kernel layer (#3 -> #5 -> #4, plain versions here)
    against JAX's fused tower with its kernels interpreted; JAX pads the
    stream to 128 rows for this mode, the port runs the 16 unpadded.
    tests/test_siglip_parity.py holds the JAX fused path to 2e-2 of the
    spread against the composed one; this holds port and JAX to 2e-4 of it,
    97% of the elements to 1e-4 and, since a tie flip moves its whole row by
    a code step in every later layer, all of them to 2e-3."""
    jp, tp = _int8_tower()
    pix = np.random.default_rng(29).standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jsiglip.forward(jp, TOWER, jnp.asarray(pix), int8=True, fused_qkv=True,
                                      fused_oproj=True, use_flash=True, _interpret=True))
    vcfg = convert.config_from_fields(_tower_vlm_cfg()).vision
    before = flash.flash_attention_merge_heads.launches
    got = tsiglip.forward(tp, vcfg, _t(pix), int8=True, fused_oproj=True).numpy()
    assert got.shape == want.shape == (3, 16, H)
    assert flash.flash_attention_merge_heads.launches == before
    rel = np.abs(got - want).std() / want.std()
    assert rel < 2e-4, rel
    diff = np.abs(got - want)
    assert (diff <= 1e-4 + 1e-4 * np.abs(want)).mean() >= 0.97
    assert diff.max() < 2e-3, diff.max()
    # and the flag changes the arithmetic only by roundings
    unfused = tsiglip.forward(tp, vcfg, _t(pix), int8=True).numpy()
    assert np.abs(got - unfused).std() / unfused.std() < 2e-2


def test_fused_oproj_tower_calls_the_fused_wrapper(monkeypatch):
    _, tp = _int8_tower()
    vcfg = convert.config_from_fields(_tower_vlm_cfg()).vision
    calls = {"oproj": 0, "merge": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tsiglip, "flash_attention_out_proj_int8",
                        counted("oproj", flash.flash_attention_out_proj_int8))
    monkeypatch.setattr(tsiglip, "flash_attention_merge_heads",
                        counted("merge", flash.flash_attention_merge_heads))
    pix = torch.zeros(1, 56, 56, 3)
    tsiglip.forward(tp, vcfg, pix, fused_oproj=True)
    assert calls == {"oproj": TOWER.num_used_layers, "merge": 0}
    tsiglip.forward(tp, vcfg, pix)  # off by default
    assert calls == {"oproj": TOWER.num_used_layers, "merge": TOWER.num_used_layers}


# ------------------------------------------------------------------- the LM

def _int8_lm():
    jp = jqwen2.prequantize_int8(jqwen2.init_params(LM, jax.random.key(30)),
                                 include_unembed=True)
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(LM.num_hidden_layers)]
    tp = convert._tree({**jax.tree.map(np.asarray, jp), "layers": layers}, "cpu", None)
    pcfg = tconfig.LMConfig(**{f.name: getattr(LM, f.name)
                               for f in dataclasses.fields(tconfig.LMConfig)})
    return jp, tp, pcfg


def test_mlp_half_fused_matches_pallas_interpret(monkeypatch):
    """JAX's gate asks for a TPU backend, so its model path cannot take the
    kernel here: the port's `_mlp_half` with the flag on is held against the
    Pallas kernel itself on the same layer's weights."""
    jp, tp, pcfg = _int8_lm()
    hidden = np.random.default_rng(31).standard_normal((1, 1024, 64)).astype(np.float32)
    hidden[0, -28:] = 0.0  # the pipeline pads the prompt with zero rows
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    want = jmlp.fused_swiglu_block_int8(
        jnp.asarray(hidden[0]), jl["post_attention_layernorm"],
        jl["gate_proj"]["kernel_int8"], jl["gate_proj"]["scale"],
        jl["up_proj"]["kernel_int8"], jl["up_proj"]["scale"],
        jl["down_proj"]["kernel_int8"], jl["down_proj"]["scale"],
        eps=LM.rms_norm_eps, interpret=True)
    monkeypatch.setattr(tqwen2, "fused_swiglu_enabled", True)
    got = tqwen2._mlp_half(tp["layers"][1], _t(hidden), pcfg)
    assert got.shape == (1, 1024, 64) and bool(torch.isfinite(got).all())
    # a code step of down at this LM's widths: ~ 0.05 / 127 * 0.1
    _assert_close_but_for_flips(got[0], want, flip=1e-4)
    torch.testing.assert_close(got[0, -28:], torch.zeros(28, 64), rtol=0, atol=0)


def test_mlp_half_gate(monkeypatch):
    _, tp, pcfg = _int8_lm()
    lp = tp["layers"][0]
    calls = []

    def counted(hidden, *args, **kwargs):
        calls.append(hidden.shape[0])
        return swiglu_int8.fused_swiglu_block_int8(hidden, *args, **kwargs)

    monkeypatch.setattr(tqwen2, "fused_swiglu_block_int8", counted)
    prefill, row = torch.randn(2, 512, 64), torch.randn(2, 1, 64)
    tqwen2._mlp_half(lp, prefill, pcfg)
    assert calls == []  # the flag is off by default
    monkeypatch.setattr(tqwen2, "fused_swiglu_enabled", True)
    composed = tqwen2.rms_norm(prefill, lp["post_attention_layernorm"], pcfg.rms_norm_eps)
    composed = prefill + tqwen2._mlp(lp, composed, pcfg)
    torch.testing.assert_close(tqwen2._mlp_half(lp, prefill, pcfg), composed,
                               rtol=1e-4, atol=1e-4)
    assert calls == [1024]  # b * s >= 1024 rows: the fused kernel
    tqwen2._mlp_half(lp, prefill[:, :511], pcfg)  # 1022 rows
    tqwen2._mlp_half(lp, row, pcfg)               # a decode step
    biased = {**lp, "gate_proj": {**lp["gate_proj"], "bias": torch.zeros(128)}}
    tqwen2._mlp_half(biased, prefill, pcfg)
    dense = {**lp, **{n: {"kernel": lp[n]["kernel_int8"].float() * lp[n]["scale"]}
                      for n in ("gate_proj", "up_proj", "down_proj")}}
    tqwen2._mlp_half(dense, prefill, pcfg)
    assert calls == [1024]  # each of those took the composed path


def test_fused_prefill_and_decode_match_composed(monkeypatch):
    """A prefill of 1024 rows with the flag on against the same prefill with
    it off. The two halves repeat the same fp32 arithmetic but for silu's
    last bit, so they agree far inside the int8 model's tie-flip noise
    floor (3% RMS of the logits' spread at full size): held to 1e-3 RMS.
    Decode (one row) does not take the kernel, whatever the flag."""
    _, tp, pcfg = _int8_lm()
    rng = np.random.default_rng(32)
    x = _t(rng.standard_normal((1, 1024, 64)).astype(np.float32))
    pos = torch.arange(1024)[None]
    valid = torch.tensor([1000], dtype=torch.int32)
    want_h, want_c = tqwen2.forward(tp, pcfg, x, pos, valid_len=valid, cache_max_len=1026)
    calls = []
    monkeypatch.setattr(tqwen2, "fused_swiglu_block_int8", lambda hidden, *a, **kw: (
        calls.append(hidden.shape[0]), swiglu_int8.fused_swiglu_block_int8(hidden, *a, **kw))[1])
    monkeypatch.setattr(tqwen2, "fused_swiglu_enabled", True)
    got_h, got_c = tqwen2.forward(tp, pcfg, x, pos, valid_len=valid, cache_max_len=1026)
    assert calls == [1024] * pcfg.num_hidden_layers
    logits = [tqwen2.unembed(tp, h[:, 999:1000]) for h in (got_h, want_h)]
    rms = float((logits[0] - logits[1]).pow(2).mean().sqrt() / logits[1].std())
    assert rms < 1e-3, rms
    emb = tqwen2.embed_tokens(tp, torch.tensor([[7]]))
    got_d, _ = tqwen2.decode_step(tp, pcfg, emb, tqwen2.quantize_cache(got_c))
    assert calls == [1024] * pcfg.num_hidden_layers  # decode added none
    want_d, _ = tqwen2.decode_step(tp, pcfg, emb, tqwen2.quantize_cache(want_c))
    rms = float((got_d - want_d).pow(2).mean().sqrt() / want_d.std())
    assert rms < 1e-2, rms


# ----------------------------------------------------------------- wrappers

WRAPPERS = (pallas_int8.int8_matmul, mlp_int8.fused_mlp_int8,
            swiglu_int8.fused_swiglu_block_int8, flash.flash_attention_out_proj_int8)


def _wrapper_args():
    rng = np.random.default_rng(33)
    x = _t(rng.standard_normal((9, H)).astype(np.float32))
    (_, t1), (_, t2), (_, t3) = (_int8_weight(rng, H, I), _int8_weight(rng, I, H),
                                 _int8_weight(rng, H, I))
    (q, k, v), hidden, _, two = _oproj_inputs(34, b=1, s=9)
    qkv = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    return {
        "matmul": (x, *t1),
        "mlp": (x, *t1, *t2),
        "swiglu": (x, torch.ones(H), t1[0], t1[1], t3[0], t3[1], t2[0], t2[1]),
        "oproj": (*qkv, torch.tensor([5], dtype=torch.int32), _t(hidden), *two),
    }


def test_w8a8_and_out_projection_products_run_on_the_s8_wgmma_core():
    """#8 (`int8_matmul`) and #5's out-projection launch their products on
    the TMA-fed s8 wgmma core (`int8h::`, int8_gemm_sm90.cuh) with its
    bias/residual epilogue, #8 with the ragged-N one, and so does #13
    (`int8_gemm_bf16`) with its int32 -> bf16 epilogue; the mma.sync GEMM
    and its epilogues are gone."""
    from memory_augmented_vlm_torch.ops import cuda_lib

    csrc = cuda_lib.CSRC_DIR
    merge = (csrc / "flash_merge.cu").read_text()
    matmul = (csrc / "int8_matmul.cu").read_text()
    out_proj = merge[merge.index("int out_proj("):merge.index("}  // namespace")]
    run = matmul[matmul.index("int run("):matmul.index("struct Int32ToBf16Out")]
    ceiling = matmul[matmul.index('extern "C" int int8_gemm_bf16('):]
    assert "int8h::RowScaleOut<T>" in out_proj and "int8h::launch_gemm_sm90" in out_proj
    assert "int8h::RowScaleOut<T, true>" in run and "int8h::launch_gemm_sm90" in run
    assert "Int32ToBf16Out" in ceiling and "int8h::launch_gemm_sm90" in ceiling
    for body in (merge, matmul):
        assert "launch_gemm(" not in body
    assert not [p.name for p in csrc.iterdir()
                if "RowScaleEpi" in p.read_text() or "Int32ToBf16Epi" in p.read_text()]


def test_gemm_ab_calls_only_entry_points_every_tree_has():
    """microbench/gemm_ab.py also runs against the parent tree of the port:
    of the port's modules it calls only entry points that trees have had
    since #5 and #8 were ported."""
    import ast

    from memory_augmented_vlm_torch.microbench import gemm_ab

    modules = {"pallas_int8", "flash", "siglip", "quant", "cuda_lib"}
    used = {(n.value.id, n.attr) for n in ast.walk(ast.parse(inspect.getsource(gemm_ab)))
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id in modules}
    assert used == {("pallas_int8", "int8_matmul"), ("flash", "flash_attention_out_proj_int8"),
                    ("siglip", "init_params"), ("siglip", "prequantize_int8"),
                    ("siglip", "forward"), ("quant", "prequantize_kernel"), ("cuda_lib", "load"),
                    ("cuda_lib", "BUILD_LOG")}


def test_fused_wrappers_take_plain_versions_on_cpu():
    args = _wrapper_args()
    before = [fn.launches for fn in WRAPPERS]
    pairs = (
        (pallas_int8.int8_matmul, pallas_int8.int8_matmul_reference, args["matmul"]),
        (mlp_int8.fused_mlp_int8, mlp_int8.fused_mlp_int8_reference, args["mlp"]),
        (swiglu_int8.fused_swiglu_block_int8, swiglu_int8.fused_swiglu_block_int8_reference,
         args["swiglu"]),
        (flash.flash_attention_out_proj_int8, flash.flash_attention_out_proj_int8_reference,
         args["oproj"]),
    )
    for fn, ref, a in pairs:
        torch.testing.assert_close(fn(*a), ref(*a), rtol=0, atol=0)
    assert [fn.launches for fn in WRAPPERS] == before  # no kernel on the CPU


def test_fused_wrappers_reject_bad_arguments():
    args = _wrapper_args()
    x, w1, s1, b1 = args["matmul"]
    with pytest.raises(ValueError):
        pallas_int8.int8_matmul(x[None], w1, s1)  # not (M, K)
    with pytest.raises(ValueError):
        pallas_int8.int8_matmul(x, w1[:100], s1)  # depth mismatch
    with pytest.raises(ValueError):
        pallas_int8.int8_matmul(x, w1, s1[:-1])
    with pytest.raises(ValueError):
        pallas_int8.int8_matmul(x, w1, s1, b1[:-1])
    mlp = list(args["mlp"])
    with pytest.raises(ValueError):
        mlp_int8.fused_mlp_int8(mlp[0][0], *mlp[1:])
    with pytest.raises(ValueError):
        mlp_int8.fused_mlp_int8(*mlp[:4], mlp[4][:100], *mlp[5:])  # w2 not (I, K)
    sw = list(args["swiglu"])
    with pytest.raises(ValueError):
        swiglu_int8.fused_swiglu_block_int8(*sw[:4], sw[4][:, :100], *sw[5:])  # wu not (K, I)
    with pytest.raises(ValueError):
        swiglu_int8.fused_swiglu_block_int8(*sw[:6], sw[6][:, :100], sw[7])  # wd not (I, K)
    op = list(args["oproj"])
    with pytest.raises(ValueError, match="geometry"):  # hidden must match q's rows
        flash.flash_attention_out_proj_int8(*op[:4], op[4][:, :5], *op[5:])
    with pytest.raises(ValueError, match="geometry"):
        flash.flash_attention_out_proj_int8(*op[:4], op[4][..., :72], *op[5:])
    with pytest.raises(ValueError):
        flash.flash_attention_out_proj_int8(*op[:5], op[5][:100], *op[6:])  # wo not (H, H)
    # neither cpu nor cuda: the kernel path's checks raise, nothing falls back
    for fn, key in zip(WRAPPERS, ("matmul", "mlp", "swiglu", "oproj")):
        with pytest.raises(ValueError):
            fn(*(a.to("meta") for a in args[key]))
    # the kernels read column-major int8 weights and refuse a row-major one
    row_major = w1.contiguous()
    assert row_major.stride() == (I, 1)
    with pytest.raises(ValueError, match="column-major"):
        int8_common.check_weight(row_major, H, I, row_major.device)
    int8_common.check_weight(w1, H, I, w1.device)
    with pytest.raises(TypeError):
        int8_common.check_weight(w1.float(), H, I, w1.device)


# ------------------------------------------------- devices are named, not defaulted

def test_device_is_explicit_in_the_table_and_rope_helpers():
    for fn in (tpe.init_params, rope.compute_rope_freqs):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    assert tpe.init_params(4, 8, "meta")["frame_embed"].device.type == "meta"
    assert rope.compute_rope_freqs(8, 1e4, "meta").device.type == "meta"
    # the LM's only caller makes the tables where the positions are
    _, _, pcfg = _int8_lm()
    cos, sin = tqwen2._rope_tables(pcfg, torch.zeros((1, 3), dtype=torch.long, device="meta"))
    assert cos.device.type == sin.device.type == "meta"


# ------------------------------------------- the card's check, on the CPU


def _fault1_case(kernel):
    """(plain output, residual or None, {control: output}) of #3, #4, #5,
    #6, #7 or #8 on chip_smoke's own inputs at a reduced row count, on the
    CPU."""
    import chip_smoke

    gen = torch.Generator()
    gen.manual_seed(21)
    if kernel in ("fused_mlp_block_int8", "fused_mlp_int8"):
        args = chip_smoke._mlp_args(gen, 128, 1152, 4304, torch.bfloat16, "cpu")
        fn = mlp_int8.fused_mlp_block_int8_reference
        base = args[0]
        if kernel == "fused_mlp_int8":
            args, fn, base = (args[0], *args[3:]), mlp_int8.fused_mlp_int8_reference, None
        with chip_smoke._erf_gelu():
            controls = {"erf GELU": fn(*args)}
        with chip_smoke._h_in_bf16():
            controls["h rounded to bf16 before the requant"] = fn(*args)
        return fn(*args), base, controls
    if kernel == "int8_matmul":
        x = torch.randn((256, 1152), generator=gen).to(torch.bfloat16)
        w, sw, bias = chip_smoke._int8_weight(gen, 1152, 4304, "cpu")
        controls = {"quant.int8_linear": quant.int8_linear(
            {"kernel_int8": w, "scale": sw, "bias": bias}, x)}
        return pallas_int8.int8_matmul_reference(x, w, sw, bias), None, controls
    if kernel == "fused_qkv_int8":  # q, k and v held as one stacked output
        args = chip_smoke._qkv_args(gen, 2, 64, 1152, torch.bfloat16, "cpu")
        controls = {name: torch.stack(fn()) for name, fn in chip_smoke._qkv_controls(args, 16)}
        return torch.stack(qkv_int8.fused_qkv_int8_reference(*args, nh=16)), None, controls
    if kernel == "fused_swiglu_block_int8":
        args = chip_smoke._swiglu_args(gen, 128, 896, 4864, torch.bfloat16, "cpu")
        controls = {name: fn() for name, fn in chip_smoke._swiglu_controls(args)}
        return swiglu_int8.fused_swiglu_block_int8_reference(*args), args[0], controls
    args = chip_smoke._oproj_args(gen, 1, 256, 16, 72, [256], torch.bfloat16, "cpu")
    controls = {name: fn() for name, fn in chip_smoke._oproj_controls(args)}
    return flash.flash_attention_out_proj_int8_reference(*args), args[4], controls


FAULT1_CONTROLS = [("fused_mlp_block_int8", "erf GELU"), ("fused_mlp_int8", "erf GELU"),
                   ("fused_mlp_block_int8", "h rounded to bf16 before the requant"),
                   ("fused_mlp_int8", "h rounded to bf16 before the requant"),
                   ("int8_matmul", "quant.int8_linear"),
                   ("flash_attention_out_proj_int8", "merge -> quant.int8_linear + residual"),
                   ("flash_attention_out_proj_int8", "attention quantized per (row, head)"),
                   ("flash_attention_out_proj_int8", "fp32 base-e softmax, q and P not rounded"),
                   ("fused_qkv_int8", "LayerNorm -> quant.int8_linear (bias after the bf16 cast)"),
                   ("fused_qkv_int8", "RMS normalisation in place of the LayerNorm"),
                   ("fused_swiglu_block_int8", "the unfused _mlp_half"),
                   ("fused_swiglu_block_int8", "GELU in place of SiLU"),
                   ("fused_swiglu_block_int8", "h rounded to bf16 before the requant")]


@pytest.mark.parametrize("kernel,control", FAULT1_CONTROLS)
def test_chip_smoke_int8_checks_fail_neighbouring_functions(kernel, control):
    """chip_smoke holds #3, #4, #5, #6, #7 and #8 to their plain versions by
    the share of bit-equal elements and the RMS over the spread
    (`_bit_close`, for #4, #5 and #7 of out - hidden, #5 at its tighter
    OPROJ_BOUNDS); each
    neighbouring function it runs as a control on the card fails that check
    here too, on the plain versions at a reduced row count."""
    import chip_smoke

    ref, base, controls = _fault1_case(kernel)
    bounds = chip_smoke.OPROJ_BOUNDS if kernel == "flash_attention_out_proj_int8" else {}
    row = chip_smoke._bit_close(control, controls[control].to(ref.dtype), ref, base, **bounds)
    assert not row["held"], row


@pytest.mark.parametrize("kernel", ["fused_mlp_block_int8", "fused_mlp_int8", "int8_matmul",
                                    "flash_attention_out_proj_int8", "fused_qkv_int8",
                                    "fused_swiglu_block_int8"])
def test_chip_smoke_int8_checks_hold_the_function_itself(kernel):
    import chip_smoke

    ref, base, _ = _fault1_case(kernel)
    bounds = chip_smoke.OPROJ_BOUNDS if kernel == "flash_attention_out_proj_int8" else {}
    assert chip_smoke._bit_close("self", ref.clone(), ref, base, **bounds)["held"]

