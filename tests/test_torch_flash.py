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
                  "flash_fwd_tiles", "flash_bwd_f32_tiles"):
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


@pytest.mark.parametrize("keep_report", [True, False])
def test_cached_build_keeps_the_ptxas_report(monkeypatch, tmp_path, keep_report):
    """A library built for the same sources is loaded as it is, and
    `BUILD_LOG["ptxas"]` then holds the report of the build that made it
    (read back from beside the library), so chip_smoke's ptxas gate sees
    the same report on a second run; a library whose report is missing is
    rebuilt. nvcc is a stand-in script that writes its outputs and prints a
    ptxas line per source."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo x >> "{calls}"\n'
        'out=""; src=""; prev=""\n'
        'for a in "$@"; do\n'
        '  [ "$prev" = "-o" ] && out="$a"\n'
        '  [ "$prev" = "-c" ] && src="$a"\n'
        '  prev="$a"\n'
        "done\n"
        ': > "$out"\n'
        'if [ -n "$src" ]; then\n'
        "  echo \"ptxas info    : Compiling entry function '$(basename \"$src\")' for 'sm_90a'\" >&2\n"
        "fi\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib, "BUILD_LOG", {"seconds": None, "path": None, "ptxas": ""})
    n_nvcc = len(cuda_lib.sources()) + 1  # a compile per source and the link

    lib = cuda_lib.build()
    compiled = cuda_lib.BUILD_LOG["ptxas"]
    assert len(calls.read_text().split()) == n_nvcc
    assert compiled.count("Compiling entry function") == len(cuda_lib.sources())
    assert "flash_fwd_wide_sm90.cu" in compiled
    assert cuda_lib.ptxas_log_path(lib).read_text() == compiled
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()
                  if not p.name.endswith(".o")) == sorted(
        [lib.name, cuda_lib.ptxas_log_path(lib).name])

    if not keep_report:
        cuda_lib.ptxas_log_path(lib).unlink()
    cuda_lib.BUILD_LOG.update(seconds=None, path=None, ptxas="")
    assert cuda_lib.build() == lib
    assert cuda_lib.BUILD_LOG["ptxas"] == compiled
    assert cuda_lib.BUILD_LOG["path"] == str(lib)
    assert len(calls.read_text().split()) == (n_nvcc if keep_report else 2 * n_nvcc)
    assert cuda_lib.ptxas_log_path(lib).read_text() == compiled


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


def test_producer_less_kernels_share_one_kv_ring():
    """The kernels with no producer warp (#1 at head dims 256 and 448, dQ at
    256) stage K and V in the one pair of rings of sm90.cuh (`KvRings`:
    slots, parities, the one-thread TMA load and the last-out refill) and
    keep no copy of that protocol of their own."""
    csrc = cuda_lib.CSRC_DIR
    header = (csrc / "sm90.cuh").read_text()
    ring = header[header.index("struct KvRings"):]
    ring = ring[:ring.index("\n};\n")]
    for member in ("int depth(", "int slot(", "int parity(", "void init(", "void load(",
                   "void load_first(", "void wait(", "void done_with(", "last_out<READERS>("):
        assert member in ring, member
    wide = (csrc / "flash_fwd_wide_sm90.cu").read_text()
    bwd = (csrc / "flash_bwd_sm90.cu").read_text()
    d256, d448 = wide[wide.index("struct D256"):], wide[wide.index("struct D448"):]
    assert d256[:d256.index("\n};\n")].count("using Ring = KvRings<2, 2, BN, CB>;") == 1
    assert d448[:d448.index("\n};\n")].count("using Ring = KvRings<3, 2, BN, CB>;") == 1
    dq = bwd[bwd.index("struct DqD256Shape"):]
    assert dq[:dq.index("\n};\n")].count("using Ring = KvRings<2, 1, BN, CB>;") == 1
    for src in (wide, bwd):
        assert "int parity(int v, int j)" not in src and "int depth(int v)" not in src
    assert "last_out<" not in wide and "mbar_init(full0" not in wide


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


@pytest.mark.parametrize("b,sq,h,d,max_rows,rows", [
    (64, 729, 16, 72, 192, 192),   # the tower: 4096 blocks of 192 rows
    (1, 9472, 14, 64, 192, 192),   # the LM prefill: 700
    (1, 1568, 8, 112, 128, 64),    # the memory's attentions: 104 of 128 rows would idle SMs
    (1, 9557, 14, 128, 128, 128),  # the train shape at head dim 128: 1050
    (2, 150, 4, 64, 192, 64),      # an edge case
    # the wide kernel's one block size: Gemma-2B's memory fuse (104 blocks
    # of 128 rows, one wave) and prefill, and the 7B memory at 448
    (1, 1568, 8, 256, 128, 128),
    (1, 9472, 8, 256, 128, 128),
    (1, 1568, 8, 448, 64, 64),
])
def test_forward_block_rows_by_shape(b, sq, h, d, max_rows, rows):
    """The bf16 forward takes its largest blocks where the grid gives each
    of 132 SMs two of them, else blocks of one warpgroup (64 rows); the wide
    kernel (head dims 256 and 448) has one block size, `WIDE_BLOCK_ROWS`."""
    assert flash.forward_block_rows(b, sq, h, d, max_rows, sms=132) == rows


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


@pytest.mark.parametrize("sq,skv,causal,items,longest,total", [
    (1568, 6272, False, 104, 98, 10192),   # the memory's fuse: 13 tiles of 8 heads
    (1568, 15680, False, 104, 245, 25480),  # its evolve
    (9472, 9472, True, 592, 148, 44400),    # the causal LM prefill
])
def test_forward_work_list_at_gemma_shapes(sq, skv, causal, items, longest, total):
    """#1 at head dim 256 in blocks of `WIDE_BLOCK_ROWS[256]` = 128 rows at
    Gemma-2B's three path shapes (8 query heads): every (head, tile) once,
    the longest key loop first. The prefill's 592 blocks loop over 2 to 148
    key tiles of 64, 44,400 block-iterations (64-row blocks ran 1,184 and
    88,208, each iteration half the rows)."""
    rows = flash.WIDE_BLOCK_ROWS[flash.D256]
    work = flash.forward_work_list(1, sq, skv, 8, causal, rows, 64)
    tiles = -(-sq // rows)
    assert sorted(work) == [(0, hi, i) for hi in range(8) for i in range(tiles)]
    loops = [len(flash_bwd.dq_key_tiles(i, sq, skv, causal, rows, 64)) for _, _, i in work]
    assert loops == sorted(loops, reverse=True)
    assert (len(work), loops[0], sum(loops)) == (items, longest, total)


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
    has the wide kernel (head dim 448, which came with `forward_tiles`) and
    in `_d256_kernels`, which it calls only under its check that the tree has
    the head dim 256 training entries, and of nvcc's ptxas report it keeps
    the bf16 flash forward kernels, the mma.sync ones and the wgmma ones
    alike."""
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
    (guard256,) = [n for n in ast.walk(tree) if isinstance(n, ast.If)
                   and ast.unparse(n.test) == "hasattr(flash_bwd, 'backward_dkv_d256')"]
    assert "_d256_kernels" in ast.unparse(guard256)
    (fn256,) = [n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "_d256_kernels"]
    d256 = {("flash", "D256"), ("flash", "flash_attention"),
            ("flash_bwd", "forward_with_lse_d256"), ("flash_bwd", "attention_delta"),
            ("flash_bwd", "scaled_q"), ("flash_bwd", "backward_dq_d256"),
            ("flash_bwd", "backward_dkv_d256")}
    assert used_in(fn256) == d256
    assert used_in(tree) == everywhere | wide | d256
    guard.body, fn256.body = [], []
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
ptxas info    : Used 168 registers
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bwd_dkv_split_sm90_kernelILi256EEEv' for 'sm_90a'
ptxas info    : Used 218 registers"""
    report = flash_ab.ptxas_report(log)
    assert list(report) == ["_ZN5mavlm8fwd_sm9010fwd_kernelILi72ELi3EEEv",
                            "_ZN12_GLOBAL__N_119fwd_lse_bf16_kernelILi64EEEv",
                            "_ZN5mavlm8fwd_wide21flash_fwd_wide_kernelEv",
                            "_ZN12_GLOBAL__N_125bwd_dkv_split_sm90_kernelILi256EEEv", "warnings"]
    assert report["warnings"] == [
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized"]
    assert "Used 114 registers" in report["_ZN5mavlm8fwd_sm9010fwd_kernelILi72ELi3EEEv"]


_PTXAS_CLEAN_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118bwd_dq_d256_kernelILb0ELb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118bwd_dq_d256_kernelILb0ELb1EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 231 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN5mavlm8fwd_wide21flash_fwd_d448_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5mavlm8fwd_wide21flash_fwd_d448_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN5mavlm8fwd_wide25flash_fwd_lse_d256_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5mavlm8fwd_wide25flash_fwd_lse_d256_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 220 registers, used 5 barriers
ptxas info    : Compiling entry function '_ZN5mavlm8fwd_wide21flash_fwd_d256_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5mavlm8fwd_wide21flash_fwd_d256_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 218 registers, used 5 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bwd_dkv_split_sm90_kernelILi256EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bwd_dkv_split_sm90_kernelILi256EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 206 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN5mavlm8fwd_wide21flash_fwd_wide_kernelILi448EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5mavlm8fwd_wide21flash_fwd_wide_kernelILi448EEEv
    248 bytes stack frame, 300 bytes spill stores, 288 bytes spill loads
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN5mavlm8fwd_wide21flash_fwd_wide_kernelILi448EEEv'
ptxas info    : (C7519) warpgroup.arrive is injected in around line 16570 by compiler to allow use of registers in GMMA in function '_ZN12_GLOBAL__N_125bwd_dkv_split_sm90_kernelILi256EEEv'""" + "".join(
    f"""
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__93c26f7f_12_flash_fwd_cu_b294bfd023flash_fwd_3xtf32_kernelILi{d}ELb{lse}EEEv14CUtensorMap_stS1_NS_11FlashParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__93c26f7f_12_flash_fwd_cu_b294bfd023flash_fwd_3xtf32_kernelILi{d}ELb{lse}EEEv14CUtensorMap_stS1_NS_11FlashParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {r} registers, used 1 barriers"""
    for d, lse, r in ((448, 0, 191), (256, 0, 212), (128, 0, 208), (112, 0, 188), (72, 0, 140),
                      (64, 0, 130), (256, 1, 213), (128, 1, 209), (64, 1, 131))) + "".join(
    f"""
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1ef7308d_14_flash_train_cu_1239d044{n}EEv14CUtensorMap_stS1_NS_11TrainParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__1ef7308d_14_flash_train_cu_1239d044{n}EEv14CUtensorMap_stS1_NS_11TrainParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {r} registers, used 16 barriers"""
    for n, r in (("21bwd_dkv_3xtf32_kernelILi256E", 247), ("21bwd_dkv_3xtf32_kernelILi128E", 229),
                 ("21bwd_dkv_3xtf32_kernelILi64E", 255), ("20bwd_dq_3xtf32_kernelILi256E", 255),
                 ("20bwd_dq_3xtf32_kernelILi128E", 255), ("20bwd_dq_3xtf32_kernelILi64E", 245)))


@pytest.mark.parametrize("fault,kernel", [
    (None, None),
    (("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 178",
      "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
      "ptxas info    : Used 178"), "flash_fwd_d448_kernel"),
    (("ptxas info    : Used 231 registers, used 16 barriers",
      "ptxas info    : Used 231 registers, used 16 barriers\nptxas info    : (C7515) Potential "
      "Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma "
      "instructions defining accumulator registers of a wgmma between start and end of the "
      "pipeline stage in the function '_ZN12_GLOBAL__N_118bwd_dq_d256_kernelILb0ELb1EEEv'"),
     "bwd_dq_d256_kernel"),
    (("flash_fwd_lse_d256_kernelEv' for", "flash_fwd_lse_d128_kernelEv' for"),
     "flash_fwd_lse_d256_kernel"),
    (("ptxas info    : Used 178 registers, used 1 barriers",
      "ptxas info    : Used 178 registers, used 1 barriers\nptxas info    : (C7514) Potential "
      "Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma "
      "instructions reading accumulator registers of a wgmma between start and end of the "
      "pipeline stage in the function '_ZN5mavlm8fwd_wide21flash_fwd_d448_kernelEv'"),
     "flash_fwd_d448_kernel"),
    (("ptxas info    : Used 218 registers, used 5 barriers",
      "ptxas info    : Used 218 registers, used 5 barriers\nptxas info    : (C7508) Potential "
      "Performance Loss: setmaxnreg ignored; unable to determine register count at entry"),
     "flash_fwd_d256_kernel"),
    # the fp32 forward (3xTF32 on mma.sync) spilling at 448, or not built at
    # 72; its lse instance (#9 in fp32) spilling at 256, or not built at 128
    (("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 191",
      "    176 bytes stack frame, 172 bytes spill stores, 172 bytes spill loads\n"
      "ptxas info    : Used 255"), "flash_fwd_3xtf32_kernelILi448ELb0E"),
    (("flash_fwd_3xtf32_kernelILi72ELb0EEEv14CUtensorMap_stS1_NS_11FlashParamsE' for",
      "flash_fwd_3xtf32_kernelILi80ELb0EEEv14CUtensorMap_stS1_NS_11FlashParamsE' for"),
     "flash_fwd_3xtf32_kernelILi72ELb0E"),
    (("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 213",
      "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads\n"
      "ptxas info    : Used 255"), "flash_fwd_3xtf32_kernelILi256ELb1E"),
    (("flash_fwd_3xtf32_kernelILi128ELb1EEEv14CUtensorMap_stS1_NS_11FlashParamsE' for",
      "flash_fwd_3xtf32_kernelILi128ELb0EEEv14CUtensorMap_stS1_NS_11FlashParamsE' for"),
     "flash_fwd_3xtf32_kernelILi128ELb1E"),
    # the fp32 backward (3xTF32 on mma.sync): dK/dV spilling at 256, dQ not
    # built at 64
    (("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "ptxas info    : Used 247",
      "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
      "ptxas info    : Used 255"), "bwd_dkv_3xtf32_kernelILi256E"),
    (("bwd_dq_3xtf32_kernelILi64EEEv14CUtensorMap_stS1_NS_11TrainParamsE' for",
      "bwd_dq_3xtf32_kernelILi96EEEv14CUtensorMap_stS1_NS_11TrainParamsE' for"),
     "bwd_dq_3xtf32_kernelILi64E"),
])
def test_chip_smoke_ptxas_gate_names_spills_and_serialised_wgmma(fault, kernel):
    """chip_smoke's build phase raises when ptxas spills, ignores setmaxnreg
    (C7508) or serialises wgmma (any code: C7512, C7514, C7515, C7520) in
    one of the five Hopper flash kernels at head dims 256 and 448 or in an
    instance of the fp32 forward (with or without its lse) or backward, or
    builds no entry of that name; the old
    448 kernel's C7512 and the dK/dV kernel's C7519 (injected arrives) are
    no fault of theirs."""
    import chip_smoke

    log = _PTXAS_CLEAN_LOG if fault is None else _PTXAS_CLEAN_LOG.replace(*fault, 1)
    faults = chip_smoke.ptxas_faults(log)
    assert list(faults) == ([] if kernel is None else [kernel]), faults
