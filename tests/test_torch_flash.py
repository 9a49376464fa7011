"""The flash kernel's plain PyTorch version against the JAX Pallas kernel
(interpret mode on the CPU, as tests/test_pallas_flash.py runs it) and
against `_xla_attention`; the wrapper's CPU dispatch and argument checks;
the kernel build helper.

fp32 cases agree to fp32 rounding (rtol/atol 1e-5). The bf16 case rounds q
and P to bf16 on both sides at different points of the online softmax, and
rounds its output to bf16: it is held at the bf16 class (rtol/atol 2e-2).
The CUDA kernel itself runs only on the card: `chip_smoke.py` compares it
with `flash_attention_reference` there.
"""

import os
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.ops.pallas_flash import _xla_attention, pallas_flash_attention
from memory_augmented_vlm_torch.ops import cuda_lib, flash

F32 = dict(rtol=1e-5, atol=1e-5)


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
    assert [p.name for p in srcs] == ["attn_block.cu", "flash_fwd.cu", "flash_merge.cu",
                                      "flash_merge_int8.cu", "flash_train.cu", "gemv.cu",
                                      "int8_matmul.cu", "mlp_int8.cu", "qkv_int8.cu",
                                      "swiglu_int8.cu"]
    # each C entry that cuda_lib.load binds is defined (not only declared)
    # in exactly one of them
    text = "".join(p.read_text() for p in srcs)
    for entry in ("flash_fwd", "flash_merge", "flash_merge_oproj", "qkv_int8", "mlp_int8",
                  "mlp_int8_core", "swiglu_int8", "int8_matmul", "flash_fwd_lse",
                  "flash_bwd_dq", "flash_bwd_dkv", "kernel_error_string", "flash_merge_int8",
                  "attn_block_int8", "int8_gemm_bf16", "gemv_bf16"):
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
