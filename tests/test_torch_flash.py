"""The flash kernel's plain PyTorch version against the JAX Pallas kernel
(interpret mode on the CPU, as tests/test_pallas_flash.py runs it) and
against `_xla_attention`; the wrapper's CPU dispatch and argument checks;
the bf16 kernel's host-side plan (rows per block, work list); the card
check's controls; the kernel build helper.

fp32 cases agree to fp32 rounding (rtol/atol 1e-5). The one-tile bf16 case
rounds P against the final max where the TPU kernel rounds it against the
running max of each key tile, and rounds its output to bf16: it is held at
the bf16 class (rtol/atol 2e-2). The tiled plain version (`block_k=64`)
computes the TPU kernel's own function at 64-key tiles and is held bit for
bit but for XLA's CPU rounding (TILED_MIN_SHARE). The CUDA kernel itself
runs only on the card: `chip_smoke.py` holds it to the tiled plain version
there.
"""

import os
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.ops.attention import repeat_kv
from memory_augmented_vlm_tpu.ops.pallas_flash import _xla_attention, pallas_flash_attention
from memory_augmented_vlm_torch.ops import cuda_lib, flash, flash_bwd

F32 = dict(rtol=1e-5, atol=1e-5)
# The tiled plain version against JAX's Pallas kernel in interpret mode at
# the same 64-row, 64-key blocks, bf16: the two compute one function, but
# XLA's CPU code and torch sum the fp32 products and exp2 in another order,
# so now and then a P or an output lands one bf16 step away (the first
# reading: 0.9992-0.9999 of the elements bit-equal, the rest one step off;
# the one-tile version read 0.855-0.894).
TILED_MIN_SHARE = 0.995
TILED_CASES = [
    # (B, Sq, Skv, H, H_kv, causal, valid)
    (2, 200, 200, 4, 2, True, (200, 131)),   # causal, GQA, ragged, Sq off the tiles
    (2, 150, 150, 2, 2, True, (0, 150)),     # causal, a batch with valid length 0
    (2, 130, 300, 2, 2, False, (300, 0)),    # cross attention, Sq != Skv, valid 0
    (1, 257, 257, 6, 2, False, (100,)),      # GQA, a prefix valid length
]


def _inputs(seed, b, sq, skv, h, d, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _pallas(q, k, v, valid, causal, dtype=jnp.float32):
    out = pallas_flash_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        causal=causal, kv_valid_len=jnp.asarray(valid, jnp.int32),
        block_q=128, block_k=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("sq,skv,valid,causal", [
    (200, 200, (200, 131), True),    # causal, ragged valid lengths
    (200, 200, (0, 200), True),      # a batch with valid length 0
    (130, 300, (300, 0), False),     # cross attention, Sq != Skv
    (257, 257, (100, 257), False),   # Sq not a tile multiple
])
def test_reference_matches_pallas_interpret(d, sq, skv, valid, causal):
    q, k, v = _inputs(d + sq, 2, sq, skv, 2, d)
    want = _pallas(q, k, v, valid, causal)
    got = flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(valid, dtype=torch.int32), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    for b, n in enumerate(valid):
        if n == 0:
            assert not got[b].any()


def _bf16_case(case, d, seed):
    b, sq, skv, h, hkv, causal, valid = case
    q, k, v = _inputs(seed, b, sq, skv, h, d, hkv=hkv)
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)], (q, k, v)


def _share_equal(got, want) -> float:
    return float((got == want).mean())


@pytest.mark.parametrize("d", [64, 72, 112, 128])
@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_reference_matches_pallas_interpret_bitwise(d, case):
    """`flash_attention_reference(block_k=64)` is the function of
    `pallas_flash_attention` at block_q = block_k = 64 (JAX repeats K/V for
    GQA): bit for bit but for XLA's CPU rounding, never more than one bf16
    step apart, zero where no key is valid, and closer to it than the
    one-tile version."""
    b, sq, skv, h, hkv, causal, valid = case
    (tq, tk, tv), (q, k, v) = _bf16_case(case, d, seed=d + sq)
    g = h // hkv
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = pallas_flash_attention(jq, repeat_kv(jk, g), repeat_kv(jv, g), causal=causal,
                                  kv_valid_len=jnp.asarray(valid, jnp.int32), block_q=64,
                                  block_k=64, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    vl = torch.tensor(valid, dtype=torch.int32)
    got = flash.flash_attention_reference(tq, tk, tv, vl, causal=causal, kv_groups=g,
                                          block_k=64).float().numpy()
    one_tile = flash.flash_attention_reference(tq, tk, tv, vl, causal=causal,
                                               kv_groups=g).float().numpy()
    assert _share_equal(got, want) >= TILED_MIN_SHARE
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert _share_equal(one_tile, want) < _share_equal(got, want)
    for bi, n in enumerate(valid):
        if n == 0:
            assert not got[bi].any()


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_xla_attention(causal):
    q, k, v = _inputs(11, 2, 96, 96, 3, 64)
    valid = (96, 40)
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(valid, jnp.int32), causal, 64 ** -0.5))
    got = flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(valid, dtype=torch.int32), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_reference_bf16_matches_pallas_interpret():
    q, k, v = _inputs(12, 1, 160, 160, 2, 72)
    want = _pallas(q, k, v, (150,), True, jnp.bfloat16)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = flash.flash_attention_reference(*bf, torch.tensor([150], dtype=torch.int32),
                                          causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_kv_groups_is_repeat_kv():
    q, k, v = _inputs(13, 2, 64, 64, 6, 64, hkv=2)
    valid = torch.tensor([64, 30], dtype=torch.int32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    grouped = flash.flash_attention_reference(qt, kt, vt, valid, causal=True, kv_groups=3)
    repeated = flash.flash_attention_reference(
        qt, kt.repeat_interleave(3, dim=2), vt.repeat_interleave(3, dim=2), valid, causal=True)
    torch.testing.assert_close(grouped, repeated, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _inputs(14, 1, 40, 40, 2, 64))
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, None, causal=True)
    assert flash.flash_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, flash.flash_attention_reference(q, k, v, causal=True))


def test_wrapper_rejects_bad_arguments():
    q, k, v = map(torch.from_numpy, _inputs(15, 1, 8, 8, 4, 64, hkv=2))
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)  # 4 query heads vs 2 kv heads, kv_groups=1
    with pytest.raises(ValueError):
        flash.flash_attention(q, k[:, :4], v[:, :4], causal=True, kv_groups=2)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        flash.flash_attention(*meta, kv_groups=2)


def test_build_command_targets_sm90a_and_sources_exist():
    srcs = cuda_lib.sources()
    assert [p.name for p in srcs] == ["attn_block.cu", "flash_bwd_sm90.cu", "flash_fwd.cu",
                                      "flash_fwd_sm90.cu", "flash_fwd_wide_sm90.cu",
                                      "flash_merge.cu",
                                      "flash_merge_int8.cu", "flash_train.cu", "gemv.cu",
                                      "int8_matmul.cu", "mlp_int8.cu", "qkv_int8.cu",
                                      "swiglu_int8.cu"]
    # each C entry that cuda_lib.load binds is defined (not only declared)
    # in exactly one of them
    text = "".join(p.read_text() for p in srcs)
    for entry in ("flash_fwd", "flash_merge", "flash_merge_oproj", "qkv_int8", "mlp_int8",
                  "mlp_int8_core", "swiglu_int8", "int8_matmul", "flash_fwd_lse",
                  "flash_bwd_dq", "flash_bwd_dkv", "kernel_error_string", "flash_merge_int8",
                  "attn_block_int8", "int8_gemm_bf16", "gemv_bf16", "flash_bwd_dq_sm90",
                  "flash_bwd_dkv_sm90", "flash_bwd_tiles", "flash_merge_int8_prep",
                  "flash_fwd_tiles"):
        definition = re.compile(r'extern "C" [\w ]+\*? ?' + entry + r"\([^;{]*\)\s*\{")
        assert len(definition.findall(text)) == 1, entry
    assert all(p.is_file() for p in srcs)
    compiles, link = cuda_lib.nvcc_commands("nvcc", Path("out.so"))
    assert len(compiles) == len(srcs)  # one nvcc per source, run side by side
    for src, cmd in zip(srcs, compiles):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd and str(src) in cmd
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[link.index("-o") + 1] == "out.so"
    assert all(cmd[cmd.index("-o") + 1] in link for cmd in compiles)  # every object linked


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_lib, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()
    assert not (tmp_path / "kernels").exists() or not os.listdir(tmp_path / "kernels")


def test_merge_kernels_are_tma_fed_wgmma_on_the_shared_header():
    """The merge-heads kernels (#2 on two_sweep.cuh, #2s in
    flash_merge_int8.cu) and the training backward take their Hopper
    helpers from one header; the merge kernels load their tiles by TMA and
    issue wgmma for both products, with nothing left of their mma.sync
    bodies, no transposed V staged by scalar stores and no quantization in
    #2s's key loops."""
    csrc = cuda_lib.CSRC_DIR
    for name in ("two_sweep.cuh", "flash_merge_int8.cu", "flash_bwd_sm90.cu"):
        assert '#include "sm90.cuh"' in (csrc / name).read_text(), name
    header = (csrc / "sm90.cuh").read_text()
    for helper in ("smem_u32", "mbar_wait", "tma_load", "wg_fence", "desc_kmajor",
                   "desc_mnmajor", "acc_to_a", "encode_tiled"):
        assert f" {helper}(" in header, helper
    two_sweep = (csrc / "two_sweep.cuh").read_text()
    int8 = (csrc / "flash_merge_int8.cu").read_text()
    assert "tma_load" in two_sweep and "tma_load_3d" in int8
    assert "wgmma_ss_n64(" in two_sweep and "wgmma_rs_n64<1>(" in two_sweep  # QK^T, PV
    assert int8.count("sm90::wgmma_s8(") == 2  # QK^T and PV
    for src in (two_sweep, int8):
        assert "mma_bf16_16816" not in src and "mma_s8_16832" not in src
    assert "sVt" not in two_sweep and "scales_kernel" not in int8 and "load_tile" not in int8
    main = int8[int8.index("merge_int8_kernel("):]
    assert main.count("quant_code(") == 4  # q's codes, once per block; K and V's in the prep


def test_flash_forward_kernels_are_tma_fed_wgmma_on_the_shared_header():
    """#1's and #9's bf16 path is one kernel, flash_fwd_sm90.cu, on the
    shared Hopper header: TMA loads tracked by mbarriers, wgmma for QK^T
    (both operands in shared memory) and PV (P from registers), nothing of
    the mma.sync kernels left in either entry point's source."""
    csrc = cuda_lib.CSRC_DIR
    kernel = (csrc / "flash_fwd_sm90.cu").read_text()
    assert '#include "sm90.cuh"' in kernel
    for helper in ("tma_load(", "mbar_wait(", "mbar_arrive_tx(", "wgmma_ss_n64(",
                   "wgmma_rs_n64<1>(", "wgmma_rs_n16<1>(", "acc_to_a("):
        assert helper in kernel, helper
    for name in ("flash_fwd.cu", "flash_train.cu"):
        src = (csrc / name).read_text()
        assert "fwd_sm90::run(" in src, name  # the bf16 branch of its entry point
        for gone in ("mma_bf16_16816", "sVt", "fwd_lse_bf16_kernel", "flash_fwd_bf16_kernel",
                     "lds32"):
            assert gone not in src, (name, gone)
    assert "mma_bf16_16816" not in kernel and "sVt" not in kernel


@pytest.mark.parametrize("b,sq,h,max_rows,rows", [
    (64, 729, 16, 192, 192),   # the tower: 4096 blocks of 192 rows
    (1, 9472, 14, 192, 192),   # the LM prefill: 700
    (1, 1568, 8, 128, 64),     # the memory's attentions: 104 of 128 rows would idle SMs
    (1, 9557, 14, 128, 128),   # the train shape at head dim 128: 1050
    (2, 150, 4, 192, 64),      # an edge case
])
def test_forward_block_rows_by_shape(b, sq, h, max_rows, rows):
    """The bf16 forward takes its largest blocks where the grid gives each
    of 132 SMs two of them, else blocks of one warpgroup (64 rows)."""
    assert flash.forward_block_rows(b, sq, h, max_rows, sms=132) == rows


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rows", [64, 128, 192])
def test_forward_work_list_covers_each_block_once(causal, rows):
    """Every (batch, head, query tile) is one item. Causal: the dQ kernel's
    list at the forward's tiles, longest key loop first; otherwise the tiles
    of one head side by side."""
    b, s, h = 2, 700, 3
    items = flash.forward_work_list(b, s, s, h, causal, rows, 64)
    tiles = -(-s // rows)
    assert sorted(items) == [(bi, hi, i) for bi in range(b) for hi in range(h)
                             for i in range(tiles)]
    if causal:
        assert items == flash_bwd.work_list("dq", b, s, s, h, True, rows, 64)
        loops = [len(flash_bwd.dq_key_tiles(i, s, s, True, rows, 64)) for _, _, i in items]
        assert loops == sorted(loops, reverse=True)
    else:
        assert list(items) == sorted(items)


def test_forward_work_list_at_the_lm_prefill_shape():
    """The causal 9472-token prefill in blocks of 192 rows: 50 tiles of 14
    heads, the longest looping over 148 key tiles, the shortest over 3,
    53,522 block-iterations in all (the TPU's 64-row grid runs 148 x 149 / 2
    x 14 = 154,364 tile steps, each a third of the rows)."""
    s, rows = 9472, 192
    items = flash.forward_work_list(1, s, s, 14, True, rows, 64)
    loops = [len(flash_bwd.dq_key_tiles(i, s, s, True, rows, 64)) for _, _, i in items]
    assert (len(items), loops[0], loops[-1], sum(loops)) == (700, 148, 3, 53522)


def _control_case(causal):
    b, sq, skv, h, hkv, d, valid = ((1, 512, 512, 4, 2, 64, (500,)) if causal
                                    else (1, 256, 1024, 2, 2, 112, (700,)))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(21, b, sq, skv, h, d, hkv=hkv))
    return q, k, v, torch.tensor(valid, dtype=torch.int32), h // hkv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("control", range(5))
def test_chip_smoke_flash_controls_fail_its_check(causal, control):
    """Each neighbouring function that chip_smoke runs as a control for
    flash_fwd and flash_fwd_lse (SDPA, the one-tile plain version, q
    unrounded, P in fp32, the diagonal moved by one key or the valid length
    one less) fails the kernel's bf16 check against the tiled plain
    version here too, at a small size."""
    import chip_smoke

    q, k, v, vl, g = _control_case(causal)
    ref = flash.flash_attention_reference(q, k, v, vl, causal=causal, kv_groups=g, block_k=64)
    label, fn = list(chip_smoke._flash_controls(q, k, v, vl, causal, g, 64))[control]
    row = chip_smoke._bit_close(label, fn()[0].to(ref.dtype), ref)
    assert not row["held"], row


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_flash_check_holds_the_tpu_kernel(causal):
    """The same check passes JAX's own Pallas kernel at 64-key blocks (in
    interpret mode) against the tiled plain version: it tells the function
    apart from its neighbours, not the two implementations."""
    import chip_smoke

    q, k, v, vl, g = _control_case(causal)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    want = pallas_flash_attention(jq, repeat_kv(jk, g), repeat_kv(jv, g), causal=causal,
                                  kv_valid_len=jnp.asarray(vl.numpy()), block_q=64, block_k=64,
                                  interpret=True)
    ref = flash.flash_attention_reference(q, k, v, vl, causal=causal, kv_groups=g, block_k=64)
    tpu = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
    assert chip_smoke._bit_close("pallas", tpu, ref)["held"]


def test_flash_ab_calls_only_entry_points_every_tree_has():
    """microbench/flash_ab.py also runs against older trees of the port: of
    the port's modules it calls only entry points that every tree has had
    since the train step was ported, except under its check that the tree
    has the wide kernel (head dim 448, which came with `forward_tiles`), and
    of nvcc's ptxas report it keeps the bf16 flash forward kernels, the
    mma.sync ones and the wgmma ones alike."""
    import ast
    import inspect

    from memory_augmented_vlm_torch.microbench import flash_ab

    modules = {"flash", "flash_bwd", "siglip", "qwen2", "cuda_lib"}
    tree = ast.parse(inspect.getsource(flash_ab))

    def used_in(node):
        return {(n.value.id, n.attr) for n in ast.walk(node)
                if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id in modules}

    (guard,) = [n for n in ast.walk(tree) if isinstance(n, ast.If)
                and ast.unparse(n.test) == "hasattr(flash, 'WIDE_HEAD_DIM')"]
    wide = {("flash", "WIDE_HEAD_DIM"), ("flash", "flash_attention_reference"),
            ("flash", "forward_tiles"), ("flash", "flash_attention")}
    assert used_in(guard) == wide
    everywhere = {("flash", "flash_attention"), ("flash_bwd", "forward_with_lse"),
                  ("siglip", "init_params"), ("siglip", "forward"), ("qwen2", "init_params"),
                  ("qwen2", "forward"), ("cuda_lib", "load"), ("cuda_lib", "BUILD_LOG")}
    assert used_in(tree) == everywhere | wide
    guard.body = []
    assert used_in(tree) == everywhere
    assert callable(flash_ab.main) and callable(flash_ab.measure)
    log = """ptxas info    : Compiling entry function '_ZN5mavlm8fwd_sm9010fwd_kernelILi72ELi3EEEv' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 114 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119fwd_lse_bf16_kernelILi64EEEv' for 'sm_90a'
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z13gemv_kernelPKv' for 'sm_90a'
ptxas info    : Used 40 registers
ptxas info    : Compiling entry function '_ZN5mavlm8fwd_wide21flash_fwd_wide_kernelEv' for 'sm_90a'
ptxas info    : Used 168 registers"""
    report = flash_ab.ptxas_report(log)
    assert list(report) == ["_ZN5mavlm8fwd_sm9010fwd_kernelILi72ELi3EEEv",
                            "_ZN12_GLOBAL__N_119fwd_lse_bf16_kernelILi64EEEv",
                            "_ZN5mavlm8fwd_wide21flash_fwd_wide_kernelEv"]
    assert "Used 114 registers" in report["_ZN5mavlm8fwd_sm9010fwd_kernelILi72ELi3EEEv"]
