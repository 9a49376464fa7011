"""#9, #10 and #11 in fp32: the 3xTF32 forward with lse (csrc/flash_fwd.cu's
kernel with its lse epilogue) and the 3xTF32 backward of
csrc/flash_train.cu.

The kernels' arithmetic, emulated on the CPU by masking fp32 bits
(`chip_smoke._tf32_attention`, the forward's two products, and
`chip_smoke._tf32_backward`, the backward's five, each as lo*hi + hi*lo +
hi*hi of TF32 operands), against JAX's `_forward_with_lse` and `_backward`
run in interpret mode on the same numpy inputs (the backward on JAX's own
saved out and lse), and against the port's plain versions at every edge
case and head dim 64, 128 and 256; its control, the same functions with
single TF32 products, falls outside the rule there, so the card's check
tells the two apart. Then the kernels' source and the card's edge cases.

Tolerance: chip_smoke's elementwise fp32 rule, atol = rtol = 1e-5
(F32_ATOL / F32_RTOL), the rule the card holds the kernels to against their
plain versions: the same fp32 function summed in another order, the
emulation's products to ~2^-21.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memory_augmented_vlm_tpu.ops.attention import repeat_kv
from memory_augmented_vlm_tpu.ops.pallas_flash_bwd import _backward, _forward_with_lse
from memory_augmented_vlm_torch.ops import cuda_lib, flash_bwd

import chip_smoke

BLOCK = 128  # JAX's interpret-mode blocks, as tests/test_torch_flash_bwd.py runs them

# (B, Sq, Skv, H, H_kv, causal, valid lengths)
CASES = [
    (2, 150, 150, 4, 2, True, (0, 77)),    # causal GQA, a batch of valid length 0
    (1, 133, 133, 7, 1, True, (133,)),     # causal GQA 7, a length off every tile
    (2, 70, 150, 2, 1, False, (150, 33)),  # cross attention, ragged
    # the card's causal GQA 7 edge at 28 heads over 4 (chip_smoke.TRAIN_EDGES'
    # d128_causal_gqa7_b2), cut to 70 tokens
    (2, 70, 70, 28, 4, True, (70, 0)),
]


def _jax_forward(d, case, seed):
    """Seeded numpy inputs (q, dO; K, V) through JAX's `_forward_with_lse`
    in interpret mode, K/V repeated over each group: (the torch tensors of
    the inputs, JAX's (q, k, v) and its (out, lse) as saved)."""
    b, sq, skv, h, hkv, causal, valid = case
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    vl = np.asarray(valid, np.int32)
    g = h // hkv
    jq, jk, jv = (jnp.asarray(q), repeat_kv(jnp.asarray(k), g), repeat_kv(jnp.asarray(v), g))
    jout, jlse = _forward_with_lse(jq, jk, jv, jnp.asarray(vl), causal, d ** -0.5, BLOCK, BLOCK,
                                   True)
    t = {name: torch.from_numpy(np.array(x)) for name, x in
         (("q", q), ("k", k), ("v", v), ("g", dout), ("vl", vl))}
    return t, (jq, jk, jv), (jout, jlse)


def _pallas_case(d, case, seed):
    """numpy inputs through JAX's forward and backward (interpret mode; K/V
    repeated over each group, so JAX's dK/dV come per query head and are
    summed over the group here), and the torch tensors of the same inputs
    with JAX's lse and delta = rowsum(dO * out)."""
    b, sq, skv, h, hkv, causal, valid = case
    t, (jq, jk, jv), (jout, jlse) = _jax_forward(d, case, seed)
    g = h // hkv
    jdq, jdk, jdv = _backward(jq, jk, jv, jout, jlse, jnp.asarray(t["g"].numpy()),
                              jnp.asarray(t["vl"].numpy()), causal, d ** -0.5, BLOCK, BLOCK,
                              True)
    want = (np.asarray(jdq),
            *(np.asarray(x).reshape(b, skv, hkv, g, d).sum(axis=3) for x in (jdk, jdv)))
    lse = torch.from_numpy(np.array(jlse)[:, :, 0, :sq]).contiguous()
    delta = flash_bwd.attention_delta(torch.from_numpy(np.array(jout)), t["g"])
    return t, lse, delta, want


def _check_forward(t, out, lse, case):
    """out and lse (log2 units) of the 3xTF32 forward inside the fp32 rule
    of `out` and `lse`, lse on its finite rows and -inf exactly where `lse`
    is, through chip_smoke's own check; with single TF32 products, out and
    lse each outside it (`_must_fail_f32` raises when not)."""
    _, _, _, h, hkv, causal, _ = case
    args = (t["q"], t["k"], t["v"], t["vl"], causal, h // hkv)
    three = chip_smoke._tf32_attention(*args)
    one = chip_smoke._tf32_attention(*args, terms=1)
    fin = torch.isfinite(lse)
    assert bool(fin.all()) == (0 not in case[-1])  # a batch of valid length 0 has lse -inf
    for got_out, got_lse in (three, one):
        assert got_out.shape == out.shape and got_lse.shape == lse.shape
        assert got_out.dtype == got_lse.dtype == torch.float32
        assert torch.equal(torch.isfinite(got_lse), fin)
        assert torch.equal(got_lse[~fin], lse[~fin])
    assert chip_smoke._train_outside(three[0], out) == 0, float((three[0] - out).abs().max())
    assert chip_smoke._train_outside(three[1][fin], lse[fin]) == 0, \
        float((three[1][fin] - lse[fin]).abs().max())
    chip_smoke._must_fail_f32("out control: single TF32 products", one[0], out)
    chip_smoke._must_fail_f32("lse control: single TF32 products", one[1][fin], lse[fin])


def _check_emulation(t, lse, delta, want, case):
    """dQ, dK and dV of the 3xTF32 arithmetic inside the fp32 rule of
    `want`, through chip_smoke's own check; with single TF32 products, each
    of them outside it (`_must_fail_f32` raises when not). A batch of valid
    length 0 gets zero gradients either way."""
    _, _, _, h, hkv, causal, valid = case
    args = (t["q"], t["k"], t["v"], t["g"], lse, delta, t["vl"], causal, h // hkv)
    three = chip_smoke._tf32_backward(*args)
    one = chip_smoke._tf32_backward(*args, terms=1)
    for name, got, ctrl, ref in zip(("dq", "dk", "dv"), three, one, want):
        ref = torch.as_tensor(np.array(ref))
        assert got.shape == ref.shape and got.dtype == torch.float32, name
        assert chip_smoke._train_outside(got, ref) == 0, (name, float((got - ref).abs().max()))
        chip_smoke._must_fail_f32(f"{name} control: single TF32 products", ctrl, ref)
        for i, n in enumerate(valid):
            if n == 0:
                assert not got[i].any() and not ctrl[i].any(), name


def _case_id(c):
    return f"b{c[0]}_s{c[1]}x{c[2]}_h{c[3]}_{c[4]}"


@pytest.mark.parametrize("d", flash_bwd.TRAIN_HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_3xtf32_forward_with_lse_holds_and_single_tf32_fails_against_pallas(d, case):
    """The forward with lse against JAX's `_forward_with_lse` in interpret
    mode (masked scores at the finite MASK_VALUE, where the kernel and its
    emulation take -inf), at every edge case and head dim."""
    t, _, (jout, jlse) = _jax_forward(d, case, seed=d + case[1])
    out = torch.from_numpy(np.array(jout))
    lse = torch.from_numpy(np.array(jlse)[:, :, 0, :case[1]]).contiguous()
    _check_forward(t, out, lse, case)


@pytest.mark.parametrize("d", flash_bwd.TRAIN_HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_3xtf32_forward_with_lse_holds_and_single_tf32_fails_against_the_plain_version(d, case):
    """The forward with lse against the plain version the card compares the
    kernel with (`forward_with_lse_reference`, one tile over the keys), at
    every edge case and head dim."""
    b, sq, skv, h, hkv, causal, valid = case
    gen = torch.Generator().manual_seed(3 * d + sq)
    t = {"q": torch.randn((b, sq, h, d), generator=gen),
         "k": torch.randn((b, skv, hkv, d), generator=gen),
         "v": torch.randn((b, skv, hkv, d), generator=gen),
         "vl": torch.tensor(valid, dtype=torch.int32)}
    out, lse = flash_bwd.forward_with_lse_reference(t["q"], t["k"], t["v"], t["vl"],
                                                    causal=causal, scale=d ** -0.5,
                                                    kv_groups=h // hkv)
    _check_forward(t, out, lse, case)


@pytest.mark.parametrize("d,case", [(64, CASES[0]), (128, CASES[1]), (256, CASES[2]),
                                    (128, CASES[3])], ids=lambda x: str(x) if isinstance(x, int)
                         else _case_id(x))
def test_3xtf32_backward_holds_and_single_tf32_fails_against_pallas(d, case):
    """Against JAX's `_backward` in interpret mode on its own saved (out,
    lse): each edge case once, each head dim at least once."""
    t, lse, delta, want = _pallas_case(d, case, seed=d + case[1])
    _check_emulation(t, lse, delta, want, case)


@pytest.mark.parametrize("d", flash_bwd.TRAIN_HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_3xtf32_backward_holds_and_single_tf32_fails_against_the_plain_version(d, case):
    """Against the plain versions the card compares the kernels with
    (`backward_dq_reference`, `backward_dkv_reference`, on the plain
    forward's lse), at every edge case and head dim."""
    b, sq, skv, h, hkv, causal, valid = case
    gen = torch.Generator().manual_seed(d + sq)
    t = {"q": torch.randn((b, sq, h, d), generator=gen),
         "g": torch.randn((b, sq, h, d), generator=gen),
         "k": torch.randn((b, skv, hkv, d), generator=gen),
         "v": torch.randn((b, skv, hkv, d), generator=gen),
         "vl": torch.tensor(valid, dtype=torch.int32)}
    kw = dict(causal=causal, scale=d ** -0.5, kv_groups=h // hkv)
    out, lse = flash_bwd.forward_with_lse_reference(t["q"], t["k"], t["v"], t["vl"], **kw)
    delta = flash_bwd.attention_delta(out, t["g"])
    args = (t["q"], t["k"], t["v"], t["g"], lse, delta, t["vl"])
    want = (flash_bwd.backward_dq_reference(*args, **kw),
            *flash_bwd.backward_dkv_reference(*args, **kw))
    _check_emulation(t, lse, delta, want, case)


# ----------------------------------------------- source and the card edges

def test_fp32_backward_source_is_3xtf32_and_the_simt_kernels_are_gone():
    """csrc/flash_train.cu's fp32 backward runs its products through the
    shared TF32 helpers of tf32.cuh (one copy of them, in that header), at
    every training head dim, each instance held by chip_smoke's ptxas gate;
    the SIMT kernels are gone, the forward (#9 in fp32) too: flash_fwd_lse's
    fp32 branch runs flash_fwd.cu's 3xTF32 kernel with its lse epilogue at
    every training head dim, each lse instance held by the ptxas gate; no
    JAX in the code, whose notes name the TPU kernels it replaces."""
    csrc = cuda_lib.CSRC_DIR
    src = (csrc / "flash_train.cu").read_text()
    fwd = (csrc / "flash_fwd.cu").read_text()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    for gone in ("bwd_dq_f32_kernel", "bwd_dkv_f32_kernel", "fwd_lse_f32_kernel", "F32Smem",
                 "kRowsF32", "launch_fwd", "kMaskValue"):
        assert gone not in src, gone
    entry = code[code.index('extern "C" int flash_fwd_lse('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (dtype == 1) return mavlm::fwd_f32::run(a, head_dim, stream);" in entry
    lse_branch = fwd[fwd.index("  if (a.lse != nullptr) {"):]
    lse_branch = lse_branch[:lse_branch.index("default: return -1;")]
    assert '#include "tf32.cuh"' in code
    for helper in ("mma_3xtf32(", "split_tf32("):
        assert helper in code, helper
    assert "mma.sync" not in code and "fmaf(dj" not in code
    for path in sorted(csrc.iterdir()):
        defined = re.findall(r"void (split_tf32|mma_tf32|mma_3xtf32)\(", path.read_text())
        assert len(defined) == (3 if path.name == "tf32.cuh" else 0), path.name
    for d in flash_bwd.TRAIN_HEAD_DIMS:
        for kind in ("dq", "dkv"):
            assert f"case {d}: return launch_{kind}<{d}>(" in code or \
                f"case {d}: rc = launch_{kind}<{d}>(" in code, (kind, d)
            assert f"bwd_{kind}_3xtf32_kernelILi{d}E" in chip_smoke.PTXAS_CLEAN
        assert f"case {d}: return launch_f32<{d}, true>(a, stream);" in lse_branch
        assert f"flash_fwd_3xtf32_kernelILi{d}ELb1E" in chip_smoke.PTXAS_CLEAN
    assert lse_branch.count("case ") == len(flash_bwd.TRAIN_HEAD_DIMS)
    assert not re.search(r"jax|memory_augmented_vlm_tpu|pallas", code, flags=re.I)
    assert "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py" in src
    assert "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py::_forward_with_lse" in fwd


def test_dkv_group_sum_is_one_kernel_for_bf16_and_fp32():
    """dK/dV's second pass is one kernel, templated on its output type, in
    dkv_group_sum.cuh: the bf16 and the fp32 backward both launch it and
    keep no copy; its name keeps `dkv_group_sum`, under which chip_smoke's
    profile of a train step files it."""
    csrc = cuda_lib.CSRC_DIR
    header = (csrc / "dkv_group_sum.cuh").read_text()
    assert "template <typename Out>\n__global__ void dkv_group_sum_kernel(" in header
    for name, out in (("flash_bwd_sm90.cu", "__nv_bfloat16"), ("flash_train.cu", "float")):
        src = (csrc / name).read_text()
        assert '#include "dkv_group_sum.cuh"' in src, name
        assert f"launch_group_sum<{out}>(" in src, name
        assert "__global__ void dkv_group_sum" not in src, name
    kernels = [p.name for p in sorted(csrc.iterdir())
               if re.search(r"__global__ void dkv_group_sum\w*\(", p.read_text())]
    assert kernels == ["dkv_group_sum.cuh"]
    assert chip_smoke._kernel_category(
        "void mavlm::dkv_group_sum_kernel<float>(float const*, float const*, float*, float*, "
        "int, int, int, int, int, long long, long long, long long)") == "flash_bwd_dkv"


def test_chip_smoke_holds_fp32_edges_at_128_causal_gqa7():
    """The card's fp32 edge cases include the 7B LM's head dim, causal, GQA
    7, at a length off every tile, alone and with a batch of valid length
    0."""
    edges = {name: rest for name, *rest in chip_smoke.TRAIN_EDGES}
    assert edges["d128_causal_gqa7"] == [1, 333, 333, 28, 4, 128, True, (333,),
                                         (torch.float32,)]
    assert edges["d128_causal_gqa7_b2"] == [2, 333, 333, 28, 4, 128, True, (333, 0),
                                            (torch.float32,)]
    assert all(333 % tile for tile in flash_bwd.backward_tiles(128, torch.float32))
