"""PyTorch port modules against their JAX counterparts on the CPU.

Weights come from the JAX inits, converted with `convert.from_jax_params`;
inputs from numpy. Where the JAX module reaches the Pallas flash kernel
(SigLIP with `use_flash=True`, the memory cross-attention), the JAX side
runs it in interpret mode, forced the way tests/test_pallas_flash.py forces
it; the port side runs the kernel's plain version. Whole modules are held
at fp32 rtol/atol 1e-4 (conftest pins JAX matmuls to full precision).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import memory_augmented_vlm_tpu.models.memory as jmem
from memory_augmented_vlm_tpu.config import LMConfig, MemoryConfig, VisionConfig
from memory_augmented_vlm_tpu.models import position_encoding as jpe
from memory_augmented_vlm_tpu.models import projector as jproj
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.ops import pallas_flash
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.models import memory as tmem
from memory_augmented_vlm_torch.models import position_encoding as tpe
from memory_augmented_vlm_torch.models import projector as tproj
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.models import vlm as tvlm
from test_vlm import TINY

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def _layers(stacked, n):
    return [jax.tree.map(lambda a: np.asarray(a)[i], stacked) for i in range(n)]


def _force_pallas(monkeypatch):
    """JAX memory attention takes its TPU flash branch, interpreted."""
    monkeypatch.setattr(jmem.jax, "default_backend", lambda: "tpu")
    orig = pallas_flash.pallas_flash_attention

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pallas_flash, "pallas_flash_attention", interp)


# ---------------------------------------------------------------- SigLIP

@functools.lru_cache(maxsize=1)
def _siglip_params():
    jp = jvlm.init_params(TINY, jax.random.key(0))
    tp = convert.from_jax_params(_np_tree(jp), convert.config_from_fields(TINY), device="cpu")
    return jp["vision_tower"], tp["vision_tower"]


def test_siglip_embed_patches_matches_jax():
    cfg = TINY.vision
    jp, tp = _siglip_params()
    pix = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = jsiglip.embed_patches(jp, cfg, jnp.asarray(pix))
    got = tsiglip.embed_patches(tp, convert.config_from_fields(TINY).vision,
                                torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_siglip_forward_matches_jax_pallas_interpret():
    cfg = TINY.vision
    jp, tp = _siglip_params()
    pix = np.random.default_rng(1).standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = jsiglip.forward(jp, cfg, jnp.asarray(pix), use_flash=True, _interpret=True)
    got = tsiglip.forward(tp, convert.config_from_fields(TINY).vision, torch.from_numpy(pix))
    assert got.shape == (3, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ projector and PE

def test_projector_matches_jax():
    jp = jproj.init_params("mlp2x_gelu", 24, 32, jax.random.key(2))
    x = np.random.default_rng(2).standard_normal((2, 5, 24)).astype(np.float32)
    want = jproj.forward(jp, "mlp2x_gelu", jnp.asarray(x))
    got = tproj.forward(_to_torch(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_temporal_pe_matches_jax():
    np.testing.assert_array_equal(tpe.sinusoidal_table(50, 32), jpe.sinusoidal_table(50, 32))
    jp = jpe.init_params(50, 32)
    x = np.random.default_rng(3).standard_normal((6, 4, 32)).astype(np.float32)
    idx = np.array([0, 3, 49, 60, 7, 2])  # 60 clamps into the table
    want = jpe.add_temporal_pe(jp, jnp.asarray(x), jnp.asarray(idx))
    got = tpe.add_temporal_pe(tpe.init_params(50, 32, "cpu"), torch.from_numpy(x),
                              torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- memory

# lq = 8*16 = 128 queries and 16*16 = 256 segment keys: large enough for the
# JAX memory attention to take its flash branch
MEM = MemoryConfig(hidden_size=64, num_attention_heads=4, patch_size=16,
                   num_memory_tokens=8, depth=2, cache_cap=3, segment_frames=16)


def _memory_params():
    jp = jmem.init_params(MEM, jax.random.key(3))
    tp = _to_torch({**jp, "layers": _layers(jp["layers"], MEM.depth)})
    return jp, tp


def _port(cls, jax_cfg):
    """The port's sub-config with the JAX sub-config's values."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _port_mem_cfg():
    return _port(tconfig.MemoryConfig, MEM)


def test_memory_attention_matches_jax_pallas(monkeypatch):
    jp, tp = _memory_params()
    rng = np.random.default_rng(4)
    q_in = rng.standard_normal((1, 128, 64)).astype(np.float32)
    kv_in = rng.standard_normal((1, 256, 64)).astype(np.float32)
    _force_pallas(monkeypatch)
    want = jmem.attention(jp["memory_update_attention"], MEM, jnp.asarray(q_in),
                          jnp.asarray(kv_in), kv_valid_len=jnp.asarray([200], jnp.int32))
    got = tmem.attention(tp["memory_update_attention"], _port_mem_cfg(),
                         torch.from_numpy(q_in), torch.from_numpy(kv_in),
                         torch.tensor([200], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_valid", [16, 9])
def test_fuse_segment_matches_jax_pallas(monkeypatch, n_valid):
    jp, tp = _memory_params()
    rng = np.random.default_rng(5)
    mem = rng.standard_normal((8, 16, 64)).astype(np.float32)
    seg = rng.standard_normal((16, 16, 64)).astype(np.float32)
    valid = np.arange(16) < n_valid
    _force_pallas(monkeypatch)
    want = jmem.fuse_segment(jp, MEM, jnp.asarray(mem), jnp.asarray(seg), jnp.asarray(valid))
    got = tmem.fuse_segment(tp, _port_mem_cfg(), torch.from_numpy(mem),
                            torch.from_numpy(seg), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_evolve_with_cache_matches_jax_pallas(monkeypatch):
    jp, tp = _memory_params()
    cache = np.random.default_rng(6).standard_normal((3, 8, 16, 64)).astype(np.float32)
    _force_pallas(monkeypatch)
    want = jmem.evolve_with_cache(jp, MEM, jmem.MemoryState(jnp.asarray(cache),
                                                           jnp.asarray(2, jnp.int32)))
    got = tmem.evolve_with_cache(tp, _port_mem_cfg(),
                                 tmem.MemoryState(torch.from_numpy(cache), 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("num_valid", [11, 80])  # partial segment; 10 segments > cap 3
def test_run_video_and_fuser_match_jax(num_valid):
    cfg = dataclasses.replace(MEM, patch_size=4, num_memory_tokens=2, segment_frames=8)
    jp = jmem.init_params(cfg, jax.random.key(7))
    tp = _to_torch({**jp, "layers": _layers(jp["layers"], cfg.depth)})
    pcfg = _port(tconfig.MemoryConfig, cfg)
    fmax = -(-num_valid // 8) * 8 + 8  # one trailing fully padded segment
    frames = np.random.default_rng(8).standard_normal((fmax, 4, 64)).astype(np.float32)
    valid = np.arange(fmax) < num_valid
    want = jmem.run_video(jp, cfg, jnp.asarray(frames), jnp.asarray(valid))
    got = tmem.run_video(tp, pcfg, torch.from_numpy(frames), torch.from_numpy(valid))
    assert got.cache_len == int(want.cache_len)
    np.testing.assert_allclose(got.cache.numpy(), np.asarray(want.cache), **TOL)
    rng = np.random.default_rng(9)
    fuser = {"fc1": {"kernel": rng.standard_normal((64, 256)).astype(np.float32) * 0.02,
                     "bias": rng.standard_normal(256).astype(np.float32) * 0.02},
             "fc2": {"kernel": rng.standard_normal((256, 64)).astype(np.float32) * 0.02,
                     "bias": np.zeros(64, np.float32)}}
    fw, vw = jmem.fuse_memory_bank(fuser, want)
    fg, vg = tmem.fuse_memory_bank(_to_torch(fuser), got)
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))
    np.testing.assert_allclose(fg.numpy(), np.asarray(fw), **TOL)


# ------------------------------------------------------------------ Qwen2

LM = LMConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              rope_theta=10000.0, dtype="float32")


def test_qwen2_prefill_and_decode_match_jax():
    jp = jqwen2.init_params(LM, jax.random.key(10))
    tp = _to_torch({**jp, "layers": _layers(jp["layers"], LM.num_hidden_layers)})
    pcfg = _port(tconfig.LMConfig, LM)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    valid = np.array([40, 23], np.int32)
    jh, jc = jqwen2.forward(jp, LM, jnp.asarray(x), jnp.asarray(pos),
                            valid_len=jnp.asarray(valid), cache_max_len=44)
    th, tc = tqwen2.forward(tp, pcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            valid_len=torch.from_numpy(valid), cache_max_len=44)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    logits_j = jqwen2.unembed(jp, LM, jh[:, -1:])
    logits_t = tqwen2.unembed(tp, th[:, -1:])
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    for step in range(3):
        ids = rng.integers(0, 512, size=(2, 1))
        je = jqwen2.embed_tokens(jp, jnp.asarray(ids))
        te = tqwen2.embed_tokens(tp, torch.from_numpy(ids))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        jh, jc = jqwen2.decode_step(jp, LM, je, jc)
        th, tc = tqwen2.decode_step(tp, pcfg, te, tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)


@pytest.mark.parametrize("part,field,value", [
    ("lm", "position_embedding", "alibi"), ("lm", "num_local_experts", 4),
    ("lm", "rope_scaling_type", "linear"), ("lm", "attention_bias", False),
    ("memory", "hidden_act", "gelu"), ("memory", "learnable_pe", True),
    ("pipeline", "dynamic_video_sampling", True), ("pipeline", "mm_newline_position", "frame"),
    ("pipeline", "mm_vision_tower", "openai/clip-vit-large-patch14-336"),
])
def test_unported_modes_raise(part, field, value):
    jax_cfg = dataclasses.replace(
        TINY, **{part: dataclasses.replace(getattr(TINY, part), **{field: value})})
    with pytest.raises(NotImplementedError, match=field):
        convert.config_from_fields(jax_cfg)


# ------------------------------------------------------ assembly and init

@pytest.mark.parametrize("drop_fine_frames", [False, True])
def test_encode_frames_and_video_embeds_match_jax(drop_fine_frames):
    jp = jvlm.init_params(TINY, jax.random.key(12))
    pcfg = convert.config_from_fields(TINY)
    tp = convert.from_jax_params(_np_tree(jp), pcfg, device="cpu")
    rng = np.random.default_rng(13)
    pix = rng.standard_normal((12, 56, 56, 3)).astype(np.float32)
    want = jvlm.encode_frames(jp, TINY, jnp.asarray(pix))
    got = tvlm.encode_frames(tp, pcfg, torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    feats = np.concatenate([np.asarray(want), np.zeros((4, 4, 32), np.float32)])
    valid = np.arange(16) < 12
    fine = tvlm.fine_frame_indices(12, TINY.memory.num_fine_frames)
    np.testing.assert_array_equal(fine, jvlm.fine_frame_indices(12, 4))
    jv = jvlm.build_video_embeds(jp, TINY, jnp.asarray(feats), jnp.arange(16),
                                 jnp.asarray(valid), jnp.asarray(fine), nseg=2,
                                 drop_fine_frames=drop_fine_frames)
    tv = tvlm.build_video_embeds(tp, pcfg, torch.from_numpy(feats), torch.arange(16),
                                 torch.from_numpy(valid), torch.from_numpy(fine), nseg=2,
                                 drop_fine_frames=drop_fine_frames)
    fine_stream = 0 if drop_fine_frames else 9 + 4 * 4 + 1
    assert tv.shape == jv.shape == (10 + 2 * 2 * 4 + 1 + fine_stream, 32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_port_init_matches_jax_init_shapes():
    pcfg = convert.config_from_fields(TINY)
    jax_side = convert.from_jax_params(_np_tree(jvlm.init_params(TINY, jax.random.key(0))),
                                       pcfg, device="cpu")
    port_side = tvlm.init_params(pcfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)  # noqa: E731
    assert shapes(port_side) == shapes(jax_side)
    rmt = port_side["memory"]["recurrent_memory_transformer"]
    bound = (6.0 / ((4 + 2) * 32)) ** 0.5
    assert float(rmt["initial_memory"].abs().max()) <= bound
    torch.testing.assert_close(port_side["positional_encoding"]["frame_embed"],
                               jax_side["positional_encoding"]["frame_embed"])
    again = tvlm.init_params(pcfg, seed=0, device="cpu")
    torch.testing.assert_close(again["language_model"]["embed_tokens"],
                               port_side["language_model"]["embed_tokens"])


def test_config_matches_jax():
    pcfg = convert.config_from_fields(TINY)
    assert pcfg.memory.patch_size == TINY.memory.patch_size == 4
    assert pcfg.lm.kv_groups == TINY.lm.kv_groups == 2
    full = tconfig.VLMConfig.onevision_0_5b()
    assert full.memory.patch_size == 196 and full.memory.hidden_size == 896
    assert VisionConfig().num_patches == tconfig.VisionConfig().num_patches == 729
