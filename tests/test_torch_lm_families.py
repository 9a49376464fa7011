"""The Llama, Mistral and Gemma families of the port's LM against the JAX
package's on the CPU: the registry, the decoder's family flags through
every prefill and decode entry (float and prequantized int8 weights), #1's
plain version at Gemma's head dim 256 against JAX's Pallas kernel in
interpret mode, the memory at Gemma-2B's width (2048 over 8 heads of 256),
a tiny llava_gemma VLM's generation, and `load_pretrained_model` on small
llava_llama and llava_gemma checkpoints against JAX's loader and HF's
`LlamaForCausalLM` / `GemmaForCausalLM`.

Weights come from the JAX inits (one `jax.jit` each), converted with
`convert`; inputs from numpy. Every norm weight is drawn away from 1, so
Gemma's `1 + w` is exercised. fp32 throughout: hidden states within
1e-4 (int8 weights 2e-4, as tests/test_torch_int8.py holds the Qwen2 LM),
logits against HF within 5e-4 (tests/test_gemma_parity.py's bound).
"""

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import memory_augmented_vlm_tpu.models.memory as jmem
from memory_augmented_vlm_tpu.config import LMConfig, MemoryConfig
from memory_augmented_vlm_tpu.eval import builder as jbuilder
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import registry as jregistry
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.ops import pallas_flash
from memory_augmented_vlm_tpu.ops.attention import repeat_kv
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.checkpoint.safetensors_io import CheckpointReader
from memory_augmented_vlm_torch.eval import builder as tbuilder
from memory_augmented_vlm_torch.models import memory as tmem
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import registry as tregistry
from memory_augmented_vlm_torch.models import vlm as tvlm
from memory_augmented_vlm_torch.ops import flash
from test_vlm import TINY

TOL = dict(rtol=1e-4, atol=1e-4)
INT8_TOL = dict(rtol=2e-4, atol=2e-4)
HF_TOL = dict(rtol=5e-4, atol=5e-4)

LLAMA = LMConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
                 tie_word_embeddings=False, attention_bias=False, dtype="float32")
# hidden 48: sqrt(48) is not a float of few bits, so the embedding scale's
# rounding shows; 2 heads of 256 over one KV head, GELU (tanh) gate
GEMMA = LMConfig(vocab_size=256, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=1, head_dim=256,
                 rope_theta=10000.0, tie_word_embeddings=True, attention_bias=False,
                 mlp_act="gelu_pytorch_tanh", norm_plus_one=True, scale_embeddings=True,
                 dtype="float32")
FAMILIES = {"llama": LLAMA, "gemma": GEMMA}


def _port_lm(cfg: LMConfig) -> tconfig.LMConfig:
    return convert.config_from_fields(dataclasses.replace(TINY, lm=cfg)).lm


def _noisy_norms(lm, rng):
    """Every norm weight 1 + 0.1 N(0, 1) (JAX's init leaves them at 1)."""
    out = dict(lm, norm=1 + 0.1 * rng.standard_normal(lm["norm"].shape).astype(np.float32))
    layers = dict(lm["layers"])
    for name in ("input_layernorm", "post_attention_layernorm"):
        layers[name] = 1 + 0.1 * rng.standard_normal(layers[name].shape).astype(np.float32)
    out["layers"] = layers
    return out


@functools.lru_cache(maxsize=None)
def _lm(family: str, weights: str):
    """(JAX params, port params, port config) of a family's tiny LM, float
    or prequantized int8 (`prequantize_int8(include_unembed=True)`)."""
    cfg = FAMILIES[family]
    jp = jax.tree.map(np.asarray, jax.jit(jqwen2.init_params, static_argnums=0)(
        cfg, jax.random.key(21)))
    jp = _noisy_norms(jp, np.random.default_rng(22))
    if weights == "int8":
        jp = jax.tree.map(np.asarray, jqwen2.prequantize_int8(
            jax.tree.map(jnp.asarray, jp), cfg, include_unembed=True))
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(cfg.num_hidden_layers)]
    tp = convert._tree({**jp, "layers": layers}, "cpu", None)
    return jp, tp, _port_lm(cfg)


# ------------------------------------------------------------ registry

RAW = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 128,
       "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
       "max_position_embeddings": 4096, "rope_theta": 10000.0, "rms_norm_eps": 1e-5}


@pytest.mark.parametrize("model_type,extra", [
    ("llava_qwen", {}),
    ("llava_llama", {}),
    ("llama", {"tie_word_embeddings": True}),
    ("llava_mistral", {"sliding_window": 4096}),
    ("llava_gemma", {"head_dim": 256, "hidden_act": "gelu"}),
    ("llava_gemma", {"hidden_activation": "gelu_pytorch_tanh", "hidden_act": "gelu"}),
    ("gemma", {}),
])
def test_registry_matches_jax(model_type, extra):
    raw = {**RAW, **extra}
    want = jregistry.lm_config_for(model_type, raw)
    got = tregistry.lm_config_for(model_type, raw)
    assert got == _port_lm(want)  # the JAX config's other fields hold their defaults


@pytest.mark.parametrize("model_type", ["llava_mixtral", "llava_qwen_moe", "qwen2_moe",
                                        "llava_mpt"])
def test_unported_families_raise(model_type):
    with pytest.raises(NotImplementedError, match="item 8"):
        tregistry.lm_config_for(model_type, RAW)
    with pytest.raises(NotImplementedError, match="item 8"):
        tbuilder.config_from_json({**RAW, "model_type": model_type})


# ------------------------------------------------------------ the decoder

def test_embedding_scale_rounds_as_jax():
    """Gemma's sqrt(hidden) is rounded to the table's dtype before the
    product: bf16 rows bit-equal to JAX's at a width whose root a bf16
    cannot hold (sqrt(48) = 6.928 -> 6.9375)."""
    table = np.random.default_rng(23).standard_normal((40, 48)).astype(np.float32)
    ids = np.array([[3, 7, 39]])
    want = jqwen2.embed_tokens({"embed_tokens": jnp.asarray(table, jnp.bfloat16)},
                               jnp.asarray(ids), GEMMA)
    got = tqwen2.embed_tokens({"embed_tokens": torch.from_numpy(table).to(torch.bfloat16)},
                              torch.from_numpy(ids), _port_lm(GEMMA))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert not np.array_equal(got.float().numpy(), (torch.from_numpy(table)[ids].to(
        torch.bfloat16).float() * 48 ** 0.5).to(torch.bfloat16).float().numpy())


_jax_forward = jax.jit(lambda p, cfg, x, pos, valid: jqwen2.forward(
    p, cfg, x, pos, valid_len=valid, cache_max_len=48), static_argnums=1)
_jax_decode_step = jax.jit(jqwen2.decode_step, static_argnums=1)
_jax_forward_chunk = jax.jit(lambda p, cfg, x, cache, start: jqwen2.forward_chunk(
    p, cfg, x, cache, start, rope_seq_len=48), static_argnums=1)
_jax_chunks = jax.jit(jqwen2.decode_chunk_batched, static_argnums=1)


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_lm_entries_match_jax(family, weights):
    """`forward` (ragged rows, its cache), `unembed`, two `decode_step`s on
    `embed_tokens(ids, cfg)`, a `forward_chunk` against a one-row prefill
    and `decode_chunk_batched` (its hidden held to JAX's after the final
    norm, which JAX's leaves out: ROADMAP §3)."""
    cfg = FAMILIES[family]
    jp, tp, pcfg = _lm(family, weights)
    tol = INT8_TOL if weights == "int8" else TOL
    h = cfg.hidden_size
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 40, h)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).copy()
    valid = np.array([40, 23], np.int32)
    jh, jc = _jax_forward(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(valid))
    th, tc = tqwen2.forward(tp, pcfg, torch.from_numpy(x), torch.from_numpy(pos),
                            valid_len=torch.from_numpy(valid), cache_max_len=48)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **tol)
    np.testing.assert_allclose(tqwen2.unembed(tp, th[:, -1:]).numpy(),
                               np.asarray(jqwen2.unembed(jp, cfg, jh[:, -1:])), **tol)
    for step in range(2):
        ids = rng.integers(0, cfg.vocab_size, size=(2, 1))
        je = jqwen2.embed_tokens(jp, jnp.asarray(ids), cfg)
        te = tqwen2.embed_tokens(tp, torch.from_numpy(ids), pcfg)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        jh, jc = _jax_decode_step(jp, cfg, je, jc)
        th, tc = tqwen2.decode_step(tp, pcfg, te, tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol, err_msg=f"step {step}")
    chunk = rng.standard_normal((1, 4, h)).astype(np.float32)
    _, jc1 = _jax_forward(jp, cfg, jnp.asarray(x[:1]), jnp.asarray(pos[:1]),
                          jnp.asarray(valid[1:]))
    _, tc1 = tqwen2.forward(tp, pcfg, torch.from_numpy(x[:1]), torch.from_numpy(pos[:1]),
                            valid_len=torch.from_numpy(valid[1:]), cache_max_len=48)
    jh, _ = _jax_forward_chunk(jp, cfg, jnp.asarray(chunk), jc1, jnp.asarray(23))
    th, _ = tqwen2.forward_chunk(tp, pcfg, torch.from_numpy(chunk), tc1, torch.tensor(23))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    chunks = rng.standard_normal((2, 3, h)).astype(np.float32)
    starts = np.array([40, 44], np.int32)
    jh, _ = _jax_chunks(jp, cfg, jnp.asarray(chunks), jc, jnp.asarray(starts))
    th, _ = tqwen2.decode_chunk_batched(tp, pcfg, torch.from_numpy(chunks), tc,
                                        torch.from_numpy(starts))
    np.testing.assert_allclose(th.numpy(), np.asarray(jqwen2._norm(jh, jp["norm"], cfg)), **tol)


@pytest.mark.parametrize("family,fused", [("llama", 1), ("gemma", 0)])
def test_fused_swiglu_gate_takes_silu_layers_only(family, fused, monkeypatch):
    """With `fused_swiglu_enabled`, an int8 prefill of 1024 rows takes the
    fused SwiGLU kernel for Llama's SiLU MLP and never for Gemma's GELU
    one, which keeps the composed path (JAX's gate)."""
    jp, tp, pcfg = _lm(family, "int8")
    calls = []
    real = tqwen2.fused_swiglu_block_int8

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    lp = tp["layers"][0]
    x = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (2, 512, pcfg.hidden_size)).astype(np.float32))
    monkeypatch.setattr(tqwen2, "fused_swiglu_block_int8", counted)
    composed = tqwen2._mlp_half(lp, x, pcfg)
    monkeypatch.setattr(tqwen2, "fused_swiglu_enabled", True)
    got = tqwen2._mlp_half(lp, x, pcfg)
    assert calls == [1024] * fused
    torch.testing.assert_close(got, composed, **INT8_TOL)


# ------------------------------------------------------ #1 at head dim 256

@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, H_kv, causal, valid)
    (2, 200, 200, 8, 1, True, (200, 131)),   # causal, GQA 8, ragged, Sq off the tiles
    (2, 130, 300, 2, 2, False, (300, 0)),    # cross attention, a batch with valid 0
])
def test_d256_tiled_reference_matches_pallas_interpret_bitwise(case):
    """#1's plain version at head dim 256 and the kernel's 64-key tiles
    against JAX's Pallas kernel at 64-row, 64-key blocks in interpret mode,
    bf16: bit for bit but for XLA's CPU rounding (tests/test_torch_flash.py's
    TILED_MIN_SHARE and one-bf16-step rule); zeros where no key is valid."""
    b, sq, skv, h, hkv, causal, valid = case
    rng = np.random.default_rng(26)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, sq, h, 256), (b, skv, hkv, 256), (b, skv, hkv, 256)))
    g = h // hkv
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = pallas_flash.pallas_flash_attention(
        jq, repeat_kv(jk, g), repeat_kv(jv, g), causal=causal,
        kv_valid_len=jnp.asarray(valid, jnp.int32), block_q=64, block_k=64, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash.flash_attention_reference(tq, tk, tv, torch.tensor(valid, dtype=torch.int32),
                                          causal=causal, kv_groups=g,
                                          block_k=64).float().numpy()
    assert float((got == want).mean()) >= 0.995
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    for bi, n in enumerate(valid):
        if n == 0:
            assert not got[bi].any()


def test_d256_wrapper_takes_the_plain_version_on_cpu():
    """fp32 at head dim 256 against JAX's Pallas kernel (interpret, 128
    blocks) through the wrapper, which on CPU tensors takes the plain
    version and counts no launch."""
    rng = np.random.default_rng(27)
    q = rng.standard_normal((1, 150, 8, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 150, 1, 256)).astype(np.float32) for _ in range(2))
    want = pallas_flash.pallas_flash_attention(
        jnp.asarray(q), repeat_kv(jnp.asarray(k), 8), repeat_kv(jnp.asarray(v), 8),
        causal=True, kv_valid_len=jnp.asarray([141], jnp.int32), block_q=128, block_k=128,
        interpret=True)
    before = flash.flash_forward_d256.launches
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.tensor([141], dtype=torch.int32), causal=True,
                                kv_groups=8)
    assert flash.flash_forward_d256.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------- the memory at Gemma-2B's width

# hidden 2048 over 8 heads of 256; 128 queries and 256 keys, so that JAX's
# memory attention takes its Pallas branch (interpreted here)
MEM_2048 = MemoryConfig(hidden_size=2048, num_attention_heads=8, patch_size=16,
                        num_memory_tokens=8, depth=1, cache_cap=3, segment_frames=16)


def test_memory_at_gemma_width_matches_jax_pallas(monkeypatch):
    """`fuse_segment` (a partial segment) and `evolve_with_cache` at hidden
    2048 with 8 heads: the memory's cross-attentions at head dim 256, JAX's
    through its Pallas kernel, the port's through #1's plain version."""
    jp = jax.tree.map(np.asarray, jax.jit(jmem.init_params, static_argnums=0)(
        MEM_2048, jax.random.key(28)))
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(MEM_2048.depth)]
    tp = convert._tree({**jp, "layers": layers}, "cpu", None)
    pcfg = tconfig.MemoryConfig(**{f.name: getattr(MEM_2048, f.name)
                                   for f in dataclasses.fields(tconfig.MemoryConfig)})
    rng = np.random.default_rng(29)
    mem = rng.standard_normal((8, 16, 2048)).astype(np.float32)
    seg = rng.standard_normal((16, 16, 2048)).astype(np.float32)
    cache = rng.standard_normal((3, 8, 16, 2048)).astype(np.float32)
    valid = np.arange(16) < 11
    monkeypatch.setattr(jmem.jax, "default_backend", lambda: "tpu")
    real = pallas_flash.pallas_flash_attention
    monkeypatch.setattr(pallas_flash, "pallas_flash_attention",
                        lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    want = jmem.fuse_segment(jp, MEM_2048, jnp.asarray(mem), jnp.asarray(seg),
                             jnp.asarray(valid))
    got = tmem.fuse_segment(tp, pcfg, torch.from_numpy(mem), torch.from_numpy(seg),
                            torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jmem.evolve_with_cache(jp, MEM_2048, jmem.MemoryState(jnp.asarray(cache),
                                                                jnp.asarray(2, jnp.int32)))
    got = tmem.evolve_with_cache(tp, pcfg, tmem.MemoryState(torch.from_numpy(cache), 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------- a tiny llava_gemma VLM

# test_vlm's tiny VLM with a Gemma LM of 2 heads of 256 (its memory at 32
# wide); every LM matrix times 5, so that greedy tokens vary
GEMMA_VLM = dataclasses.replace(TINY, lm=dataclasses.replace(
    GEMMA, vocab_size=TINY.lm.vocab_size, hidden_size=TINY.lm.hidden_size,
    intermediate_size=TINY.lm.intermediate_size))


def test_gemma_vlm_generate_matches_jax():
    """`video_qa_embeds` (the memory and frame prompts and the text ids
    scaled, the visual rows not), the prefill logits at its last position
    (`qwen2.forward`, `unembed`) within 1e-4, and greedy `generate` of 10
    tokens: the same tokens as JAX's."""
    jp = jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=0)(
        GEMMA_VLM, jax.random.key(30)))
    lm = _noisy_norms(jp["language_model"], np.random.default_rng(31))
    jp = dict(jp, language_model=jax.tree.map(lambda a: a * 5 if a.ndim >= 2 else a, lm))
    pcfg = convert.config_from_fields(GEMMA_VLM)
    tp = convert.from_jax_params(jp, pcfg, device="cpu")
    frames = np.random.default_rng(32).standard_normal((6, 56, 56, 3)).astype(np.float32)
    ids = np.array([5, 17, 9, -200, 33, 41], np.int64)
    want_emb = jvlm.video_qa_embeds(jp, GEMMA_VLM, jnp.asarray(frames), ids)
    got_emb = tvlm.video_qa_embeds(tp, pcfg, torch.from_numpy(frames), ids)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), **TOL)
    s = got_emb.shape[0]
    jh, _ = jqwen2.forward(jp["language_model"], GEMMA_VLM.lm, want_emb[None],
                           jnp.arange(s)[None], need_cache=False)
    th, _ = tqwen2.forward(tp["language_model"], pcfg.lm, got_emb[None], torch.arange(s)[None],
                           need_cache=False)
    np.testing.assert_allclose(
        tqwen2.unembed(tp["language_model"], th[:, -1]).numpy(),
        np.asarray(jqwen2.unembed(jp["language_model"], GEMMA_VLM.lm, jh[:, -1])), **TOL)
    want = jvlm.generate(jp, GEMMA_VLM, want_emb, max_new_tokens=10, eos_token_ids=())
    got = tvlm.generate(tp, pcfg, got_emb, max_new_tokens=10, eos_token_ids=())
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert len(set(got.tokens.tolist())) > 1


# ---------------------------------------------------------- loading

@pytest.mark.parametrize("family", ["llava_llama", "llava_gemma"])
def test_load_pretrained_family_matches_jax_and_hf(family, tmp_path):
    """A small `family` checkpoint (`chip_smoke.family_checkpoint`, at LM
    width 64): the port's `load_pretrained_model` on the CPU gives the
    source's leaves and config; JAX's loader the same LM leaves; the text
    logits of the loaded LM are HF's (`LlamaForCausalLM`,
    `GemmaForCausalLM` on the checkpoint's LM tensors) within 5e-4."""
    import transformers

    raw, cfg, source = chip_smoke.family_checkpoint(
        tmp_path, family, hidden_size=64, intermediate_size=128,
        **({"num_attention_heads": 4, "head_dim": 16} if family == "llava_llama" else {}))
    _, model, _, _ = tbuilder.load_pretrained_model(str(tmp_path), torch_dtype="float32",
                                                    device_map="cpu")
    assert model.cfg.lm == cfg.lm
    for got, want in zip(jax.tree.leaves(convert.to_jax_layout(model.params)),
                         jax.tree.leaves(convert.to_jax_layout(source))):
        np.testing.assert_array_equal(got, want)
    _, jmodel, _, _ = jbuilder.load_pretrained_model(str(tmp_path), torch_dtype="float32")
    jlm = jax.tree.map(np.asarray, jmodel.params["language_model"])
    tlm = convert.to_jax_layout({"language_model": model.params["language_model"]})
    assert jax.tree.structure(jlm) == jax.tree.structure(tlm["language_model"])
    for got, want in zip(jax.tree.leaves(tlm["language_model"]), jax.tree.leaves(jlm)):
        np.testing.assert_array_equal(got, want)

    hf_cls, hf_cfg_cls = {"llava_llama": ("LlamaForCausalLM", "LlamaConfig"),
                          "llava_gemma": ("GemmaForCausalLM", "GemmaConfig")}[family]
    fields = {k: v for k, v in raw.items() if not k.startswith("mm_") and k != "model_type"}
    hf = getattr(transformers, hf_cls)(getattr(transformers, hf_cfg_cls)(
        **fields, attn_implementation="eager")).eval().float()
    with CheckpointReader(str(tmp_path)) as reader:
        state = {k: reader.get(k) for k in reader.keys()
                 if k == "lm_head.weight" or (k.startswith("model.")
                                              and k[len("model."):] in hf.model.state_dict())}
    missing, unexpected = hf.load_state_dict(state, strict=False)
    assert not unexpected and set(missing) <= {"lm_head.weight"}, (missing, unexpected)
    ids = np.array([[5, 17, 301, 42, 7, 9, 1000]])
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
    lm = model.params["language_model"]
    emb = tqwen2.embed_tokens(lm, torch.from_numpy(ids), model.cfg.lm)
    hidden, _ = tqwen2.forward(lm, model.cfg.lm, emb, torch.arange(7)[None], need_cache=False)
    np.testing.assert_allclose(tqwen2.unembed(lm, hidden).numpy(), want, **HF_TOL)
    assert json.loads((tmp_path / "config.json").read_text())["model_type"] == family
