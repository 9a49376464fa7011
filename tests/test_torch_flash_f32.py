"""#1 in fp32, at head dim 448 above all (the 7B memory: 3584 over 8
heads): JAX's Pallas kernel at 448 in fp32 (interpret mode on the CPU, as
tests/test_pallas_flash.py runs it) against the port's plain version; a
tiny memory at head dim 448, port against JAX through the memory's fuse
and evolve (JAX's TPU branch, interpreted: the head dim padded to 512); the
3xTF32 arithmetic of the fp32 kernel (csrc/flash_fwd.cu), emulated on the
CPU by masking fp32 bits (`chip_smoke._tf32_attention`), against the fp32
plain version, with its single-TF32 control outside the same rule; the
kernel's source; the wrappers' routing on the CPU; and chip_smoke's launch
figures for the 7B fp32 parity cut.

Tolerances: the plain version against JAX's kernel and the 3xTF32
emulation against the plain version at rtol = atol = 1e-5 (chip_smoke's
F32_ATOL / F32_RTOL): the same fp32 function summed in another order, the
emulation's products to ~2^-21. The memory's outputs, after its
projections and post-LN LayerNorms, at 1e-4, as tests/test_torch_models.py
holds them.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import memory_augmented_vlm_tpu.models.memory as jmem
from memory_augmented_vlm_tpu.config import MemoryConfig
from memory_augmented_vlm_tpu.ops import pallas_flash
from memory_augmented_vlm_tpu.ops.attention import repeat_kv
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import memory as tmem
from memory_augmented_vlm_torch.ops import cuda_lib, flash

import chip_smoke

F32 = dict(rtol=chip_smoke.F32_RTOL, atol=chip_smoke.F32_ATOL)
D = flash.WIDE_HEAD_DIM


def _inputs(seed, b, sq, skv, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _outside(got, want) -> int:
    """Elements outside atol + rtol * |want| (chip_smoke's fp32 rule)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return int((np.abs(got - want) > F32["atol"] + F32["rtol"] * np.abs(want)).sum())


# (B, Sq, Skv, H, H_kv, causal, valid lengths)
D448_CASES = [
    (2, 96, 96, 2, 2, True, (96, 40)),      # causal, ragged
    (2, 70, 150, 2, 2, False, (150, 0)),    # cross attention, a batch of valid length 0
    (1, 130, 130, 4, 2, True, (130,)),      # causal GQA, Sq off the 64-row block
    (2, 64, 64, 2, 1, False, (0, 33)),      # GQA over one KV head, valid 0 and off the tile
]


@pytest.mark.parametrize("case", D448_CASES)
def test_reference_matches_pallas_interpret_at_448(case):
    """JAX's pallas_flash_attention in fp32 at head dim 448 (64-row, 64-key
    blocks; K/V repeated for GQA, as JAX's callers do) against the port's
    plain version with kv_groups; a batch with no valid key is zero."""
    b, sq, skv, h, hkv, causal, valid = case
    q, k, v = _inputs(sq + skv, b, sq, skv, h, hkv, D)
    g = h // hkv
    want = pallas_flash.pallas_flash_attention(
        jnp.asarray(q), repeat_kv(jnp.asarray(k), g), repeat_kv(jnp.asarray(v), g),
        causal=causal, kv_valid_len=jnp.asarray(valid, jnp.int32), block_q=64, block_k=64,
        interpret=True)
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.tensor(valid, dtype=torch.int32), causal=causal,
                                kv_groups=g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for i, n in enumerate(valid):
        if n == 0:
            assert not got[i].any()


# a memory at head dim 448: 8 x 16 = 128 queries, 16 x 16 = 256 segment
# keys, so that JAX's attention takes its flash branch (lq >= 128, kv >= 256)
MEM448 = MemoryConfig(hidden_size=D, num_attention_heads=1, patch_size=16,
                      num_memory_tokens=8, depth=2, cache_cap=3, segment_frames=16)


@functools.lru_cache(maxsize=1)
def _memory448():
    jp = jax.jit(lambda key: jmem.init_params(MEM448, key))(jax.random.key(21))
    jp = jax.tree.map(np.asarray, jp)
    layers = [jax.tree.map(lambda a: torch.tensor(a[i]), jp["layers"])
              for i in range(MEM448.depth)]
    tp = jax.tree.map(torch.tensor, {k: v for k, v in jp.items() if k != "layers"})
    tcfg = tconfig.MemoryConfig(**{f.name: getattr(MEM448, f.name)
                                   for f in dataclasses.fields(tconfig.MemoryConfig)})
    return jp, {**tp, "layers": layers}, tcfg


def _jax_flash_branch(monkeypatch):
    """JAX's memory attention takes its TPU branch (the flash kernel with the
    head dim zero-padded to 512), interpreted."""
    monkeypatch.setattr(jmem.jax, "default_backend", lambda: "tpu")
    orig = pallas_flash.pallas_flash_attention
    monkeypatch.setattr(pallas_flash, "pallas_flash_attention",
                        functools.partial(orig, interpret=True))


@pytest.mark.parametrize("n_valid", [16, 7])
def test_fuse_segment_at_448_matches_jax(monkeypatch, n_valid):
    jp, tp, tcfg = _memory448()
    rng = np.random.default_rng(22 + n_valid)
    mem = rng.standard_normal((8, 16, D)).astype(np.float32)
    seg = rng.standard_normal((16, 16, D)).astype(np.float32)
    valid = np.arange(16) < n_valid
    _jax_flash_branch(monkeypatch)
    want = jmem.fuse_segment(jp, MEM448, jnp.asarray(mem), jnp.asarray(seg), jnp.asarray(valid))
    got = tmem.fuse_segment(tp, tcfg, torch.from_numpy(mem), torch.from_numpy(seg),
                            torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_evolve_with_cache_at_448_matches_jax(monkeypatch):
    jp, tp, tcfg = _memory448()
    cache = np.random.default_rng(25).standard_normal((3, 8, 16, D)).astype(np.float32)
    _jax_flash_branch(monkeypatch)
    want = jmem.evolve_with_cache(jp, MEM448, jmem.MemoryState(jnp.asarray(cache),
                                                              jnp.asarray(2, jnp.int32)))
    got = tmem.evolve_with_cache(tp, tcfg, tmem.MemoryState(torch.from_numpy(cache), 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------- the kernel's arithmetic

def test_tf32_rounding_by_bits():
    """`chip_smoke._tf32`: 10 mantissa bits, to nearest with ties away from
    zero (cvt.rna), or by dropping the 13 low bits; a split x = hi + lo is
    exact in fp32 and lo keeps what hi lost."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11), 3.0 ** 0.5])
    hi = chip_smoke._tf32(x)
    assert hi[:4].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    assert chip_smoke._tf32(x, nearest=False)[1].item() == 1.0
    bits = hi.view(torch.int32)
    assert not (bits & 8191).any()
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert (lo.abs() <= 2 ** -11 * x.abs()).all()


def _emulation_case(d, edge):
    name, b, sq, skv, h, hkv, valid, causal = edge
    q, k, v = (torch.from_numpy(x) for x in _inputs(d + sq, b, sq, skv, h, hkv, d))
    vl = torch.tensor(valid, dtype=torch.int32)
    ref = flash.flash_attention_reference(q, k, v, vl, causal=causal, kv_groups=h // hkv)
    return q, k, v, vl, causal, h // hkv, ref


@pytest.mark.parametrize("d", chip_smoke.F32_HEAD_DIMS)
@pytest.mark.parametrize("edge", chip_smoke.F32_EDGES, ids=lambda e: e[0])
def test_3xtf32_holds_and_single_tf32_fails_the_card_rule(d, edge):
    """The fp32 kernel's 3xTF32 products, emulated on the CPU, stay inside
    chip_smoke's fp32 rule against the fp32 plain version on the edge cases
    the card runs at every head dim; its control, a single TF32 product,
    falls outside it there, so the card's check tells the two apart."""
    q, k, v, vl, causal, g, ref = _emulation_case(d, edge)
    three = chip_smoke._tf32_attention(q, k, v, vl, causal, g, terms=3)[0]
    one = chip_smoke._tf32_attention(q, k, v, vl, causal, g, terms=1)[0]
    assert three.shape == ref.shape and three.dtype == torch.float32
    assert _outside(three, ref) == 0, float((three - ref).abs().max())
    assert _outside(one, ref) > 0
    assert chip_smoke._hold_f32("3xTF32", three, ref)["outside"] == 0
    chip_smoke._must_fail_f32("single TF32", one, ref)


def test_3xtf32_at_a_memory_like_448_case():
    """A cut of the 7B memory's fuse (8 heads of 448, 392 queries over 1568
    keys, 784 valid): 3xTF32 within the rule, with room; single TF32 far
    outside it."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(26, 1, 392, 1568, 8, 8, D))
    vl = torch.tensor([784], dtype=torch.int32)
    ref = flash.flash_attention_reference(q, k, v, vl)
    three = chip_smoke._tf32_attention(q, k, v, vl, False, 1)[0]
    one = chip_smoke._tf32_attention(q, k, v, vl, False, 1, terms=1)[0]
    assert float((three - ref).abs().max()) < 0.25 * F32["atol"]
    assert _outside(one, ref) > ref.numel() // 4


# --------------------------------------------------- source and routing

def test_fp32_forward_source_is_3xtf32_mma_and_the_simt_kernel_is_gone():
    """csrc/flash_fwd.cu's fp32 forward is one 3xTF32 kernel on mma.sync
    (hi to nearest by the bits, lo the rest: the helpers of tf32.cuh, which
    it includes) for every head dim, with no JAX in its code (its notes name
    the TPU kernel it replaces) and nothing left of the SIMT kernel;
    chip_smoke's ptxas gate holds each of its instances."""
    src = (cuda_lib.CSRC_DIR / "flash_fwd.cu").read_text()
    helpers = (cuda_lib.CSRC_DIR / "tf32.cuh").read_text()
    assert "flash_fwd_f32_kernel" not in src and "kRowsF32" not in src
    assert '#include "tf32.cuh"' in src and "mma_3xtf32(" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in helpers
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in helpers
    assert helpers.count("mma_tf32(d, ") == 3  # lo*hi, hi*lo, hi*hi
    for d in chip_smoke.F32_HEAD_DIMS:
        assert f"case {d}: return launch_f32<{d}>(a, stream);" in src
        assert f"flash_fwd_3xtf32_kernelILi{d}ELb0E" in chip_smoke.PTXAS_CLEAN
    assert set(chip_smoke.F32_HEAD_DIMS) == set(flash.KERNEL_HEAD_DIMS) | {flash.D256, D}
    # the JAX package only in the notes of what the kernel replaces: no
    # include, name or path of it in the code
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    assert not re.search(r"jax|memory_augmented_vlm_tpu|pallas", code, flags=re.I)
    assert "memory_augmented_vlm_tpu/ops/pallas_flash.py::pallas_flash_attention" in src


def test_fp32_at_448_takes_the_plain_version_on_the_cpu():
    """fp32 at 448 no longer raises: on CPU tensors every wrapper takes the
    plain version and counts no launch; the kernel's argument check passes
    fp32 at 448."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(27, 1, 40, 70, 2, 2, D))
    vl = torch.tensor([50], dtype=torch.int32)
    counters = (flash.flash_attention, flash.flash_forward_d448_f32, flash.flash_forward_wide)
    before = [fn.launches for fn in counters]
    got = flash.flash_attention(q, k, v, vl)
    torch.testing.assert_close(got, flash.flash_attention_reference(q, k, v, vl),
                               rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before
    flash._check_kernel_args(q, k, v, vl, D)
    with pytest.raises(ValueError):
        flash.flash_forward_d448_f32(q.bfloat16(), k.bfloat16(), v.bfloat16(), vl,
                                     causal=False, scale=D ** -0.5, kv_groups=1)


# ------------------------------------------------- the 7B fp32 parity cut

def test_7b_parity_cut_launches_fp32_448_in_its_memory():
    """The 7B config cut to 2 + 2 layers, fp32, over PARITY_7B_FRAMES frames:
    the fewest that make two segments, so the memory's fuse (twice a
    segment) and its evolve run at head dim 448 through
    flash_fwd_d448_f32; the LM (28 heads of 128 over 4) through #9-#11;
    the tower at 72 through flash_fwd."""
    cfg = chip_smoke._parity_cut(VLMConfig.onevision_7b())
    seg = cfg.memory.segment_frames
    assert chip_smoke.PARITY_7B_FRAMES == seg + 1
    assert cfg.memory.hidden_size // cfg.memory.num_attention_heads == D
    assert (cfg.lm.hidden_size, cfg.lm.num_attention_heads, cfg.lm.num_key_value_heads,
            cfg.lm.head_dim, cfg.lm.intermediate_size) == (3584, 28, 4, 128, 18944)
    assert not cfg.lm.tie_word_embeddings
    want = chip_smoke._expected_train_launches(cfg, chip_smoke.PARITY_7B_FRAMES, torch.float32)
    assert {k: v for k, v in want.items() if v} == {
        "flash_fwd": 2, "flash_fwd_d448_f32": 2 * cfg.memory.depth + 1,
        "flash_fwd_lse": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert chip_smoke._attn_kernel(D, torch.float32) == "flash_fwd_d448_f32"
    assert chip_smoke._attn_kernel(D) == "flash_fwd_d448"
    assert chip_smoke.WRAPPERS["flash_fwd_d448_f32"] is flash.flash_forward_d448_f32
    assert "train_parity_7b" in chip_smoke.CPU_REFERENCE_JOBS


def test_fp32_train_shapes_are_the_parity_cuts_lm_tokens():
    """The fp32 training kernels are timed at the LM lengths the parity cuts'
    batches splice: 128 text tokens, 10 + 9 prompt tokens and two newlines,
    8 x 196 memory tokens a segment and 196 a fine frame."""
    shapes = {case: (cfg.lm.head_dim, s) for case, cfg, s in chip_smoke._f32_train_shapes()}
    assert shapes == {"lm_train_f32": (64, 128 + 21 + 2 * 1568 + 8 * 196),
                      "gemma_train_f32": (256, 128 + 21 + 2 * 1568 + 2 * 196),
                      "lm_train_7b_f32": (128, 128 + 21 + 2 * 1568 + 2 * 196)}
