"""The port's benchmark entry (`memory_augmented_vlm_torch.bench`) and the
pipeline modes it drives, against the root `bench.py` and the JAX package
on the CPU.

- `baseline_visual_tokens_per_s` and `metric_name`: equal to bench.py's.
- `build_pipeline(no_memory=True)` and Gumbel sampling (JAX's per-step
  draws passed in as the port's noise): equal tokens, prefill logits within
  1e-4, on the tiny config of tests/test_vlm.py (fp32).
- An untied LM (`tie_word_embeddings=False`): init tree, unembed (1e-5),
  prequantize (int8 codes equal), prefill and decode logits (1e-4).
- `init_lm_7b_int8` against `bench._init_lm_7b_int8`, and a tiny untied
  int8 VLM built that way giving bench.build_pipeline's tokens.
- The memory at the 7B width (hidden 3584 over 8 heads: head dim 448)
  against JAX's einsum path (1e-4), and the plain flash version at that
  head dim against JAX's Pallas kernel in interpret mode at the kernel's
  32-key tile.
- JAX's decode work: 32 decode steps and 33 unembeds for 32 tokens, and the
  same tokens and logits as the former loop, which stopped one step early.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import memory_augmented_vlm_tpu.models.memory as jmem
from memory_augmented_vlm_tpu.config import LMConfig, MemoryConfig, VLMConfig
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.ops.pallas_flash import pallas_flash_attention
from memory_augmented_vlm_torch import bench as tbench
from memory_augmented_vlm_torch import config as tconfig
from memory_augmented_vlm_torch import convert, pipeline
from memory_augmented_vlm_torch.models import memory as tmem
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import vlm as tvlm
from memory_augmented_vlm_torch.ops import flash
from test_vlm import TINY

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_NEW = 6
# the bench's prompt ids exceed the tiny vocab (50000): other ids, same lengths
TEXT_BEFORE = np.array([11, 872, 198], np.int32)
TEXT_AFTER = np.array([3838, 374, 12482, 304, 419, 2766, 30, 4545, 198, 1644, 7791, 198],
                      np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _lm_to_torch(jp, n_layers):
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"]) for i in range(n_layers)]
    return convert._tree({**jax.tree.map(np.asarray, jp), "layers": layers}, "cpu", None)


def _port_lm_cfg(cfg):
    return tconfig.LMConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tconfig.LMConfig)})


# ------------------------------------------------------- bench.py's numbers

@pytest.mark.parametrize("no_memory", [False, True])
@pytest.mark.parametrize("model", ["0.5b", "7b"])
@pytest.mark.parametrize("frames", [16, 32, 64, 100, 128, 400])
def test_baseline_visual_tokens_per_s_equals_bench(frames, model, no_memory):
    assert (tbench.baseline_visual_tokens_per_s(frames, model, no_memory=no_memory)
            == bench.baseline_visual_tokens_per_s(frames, model, no_memory=no_memory))


# bench.py builds its names inside main(): these are its templates
_BENCH_TEMPLATES = ('f"visual_tokens_per_s_{nframes}frame_clip_to_answer_7b_int8"',
                    'f"visual_tokens_per_s_{nframes}frame_clip_to_answer_0.5b"',
                    'metric_name += "_lm_int8"', 'metric_name += "_no_memory"')


@pytest.mark.parametrize("frames", [16, 64, 128])
@pytest.mark.parametrize("model,bf16_lm,no_memory,want", [
    ("0.5b", False, False, "0.5b_lm_int8"),
    ("0.5b", True, False, "0.5b"),
    ("0.5b", False, True, "0.5b_lm_int8_no_memory"),
    ("0.5b", True, True, "0.5b_no_memory"),
    ("7b", False, False, "7b_int8"),
    ("7b", True, False, "7b_int8"),   # bench.py reads --bf16_lm at 0.5B only
    ("7b", False, True, "7b_int8_no_memory"),
])
def test_metric_name_equals_bench(frames, model, bf16_lm, no_memory, want):
    source = Path(bench.__file__).read_text()
    assert all(t in source for t in _BENCH_TEMPLATES)
    assert (tbench.metric_name(frames, model, bf16_lm, no_memory)
            == f"visual_tokens_per_s_{frames}frame_clip_to_answer_{want}")


def test_bench_main_needs_a_card(monkeypatch):
    """`main` raises without a CUDA card before it builds anything: the
    benchmark never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])


def test_result_keeps_bench_keys_less_the_relay_fields():
    out = tbench.result("m", [1.5, 1.25, 2.0], 9429, 64, 2, 16500.0, "card, 700 W")
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["value"] == round(9429 / 1.25, 1) and out["unit"] == "visual tokens/s"
    detail = out["detail"]
    for key in ("latency_s", "visual_tokens", "frames", "segments", "decode_tokens", "backend"):
        assert key in detail
    assert not any(k.startswith(("dispatch_floor", "projected")) for k in detail)
    assert detail["latency_s"] == 1.25 and detail["latency_s_reps"] == [1.5, 1.25, 2.0]
    assert detail["backend"] == "cuda" and detail["card"] == "card, 700 W"


# ------------------------------------------------- pipeline modes vs bench.py

@pytest.fixture(scope="module")
def weights():
    params = jvlm.init_params(TINY, jax.random.key(0))
    port = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   convert.config_from_fields(TINY), device="cpu")
    return params, port


def _pixels(num_frames, seed):
    return np.random.default_rng(seed).standard_normal((num_frames, 56, 56, 3)).astype(
        np.float32)


def _both(cfg, jparams, tparams, num_frames, seed, noise=None, **kw):
    pix = _pixels(num_frames, seed)
    jfn, jnseg = bench.build_pipeline(cfg, num_frames, return_prefill_logits=True,
                                      max_new_tokens=MAX_NEW, **kw)
    jtok, js, jlogits = jax.jit(jfn)(jparams, jnp.asarray(pix), jnp.asarray(TEXT_BEFORE),
                                     jnp.asarray(TEXT_AFTER))
    tfn, tnseg = pipeline.build_pipeline(convert.config_from_fields(cfg), num_frames,
                                         return_logits=True, max_new_tokens=MAX_NEW, **kw)
    ttok, ts, tlogits = tfn(tparams, _t(pix), _t(TEXT_BEFORE), _t(TEXT_AFTER), noise=noise)
    assert tnseg == jnseg and ts == int(js)
    return (np.asarray(jtok), np.asarray(jlogits)), (ttok.numpy(), tlogits.numpy())


@pytest.mark.parametrize("num_frames", [12, 40])
def test_no_memory_pipeline_matches_bench(weights, num_frames):
    (jtok, jlogits), (ttok, tlogits) = _both(TINY, *weights, num_frames, num_frames,
                                             no_memory=True)
    assert tlogits.shape == (MAX_NEW, 1, TINY.lm.vocab_size)
    np.testing.assert_allclose(tlogits[0], jlogits, **TOL)
    np.testing.assert_array_equal(ttok, jtok)


def test_no_memory_visual_stream_is_frames_then_newline():
    feats = torch.randn(3, 4, 8)
    newline = torch.randn(8)
    got = pipeline.vlm.add_token_per_frame(feats, newline)
    want = jvlm.add_token_per_frame(jnp.asarray(feats.numpy()), jnp.asarray(newline.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (3 * 5, 8)


def _jax_gumbel(n, vocab):
    """bench.py's per-step draws: gumbel of jax.random.split(key(0), n)[i]."""
    keys = jax.random.split(jax.random.key(0), n)
    return np.stack([np.asarray(jax.random.gumbel(k, (1, vocab), jnp.float32)) for k in keys])


@pytest.mark.parametrize("temperature", [0.7, 2.0])
def test_sampled_pipeline_matches_bench_with_its_draws(weights, temperature):
    noise = _jax_gumbel(MAX_NEW, TINY.lm.vocab_size)
    (jtok, jlogits), (ttok, tlogits) = _both(TINY, *weights, 12, 3, noise=_t(noise),
                                             sample_temperature=temperature)
    np.testing.assert_allclose(tlogits[0], jlogits, **TOL)
    np.testing.assert_array_equal(ttok, jtok)
    greedy = tlogits.argmax(-1)
    assert (greedy != ttok).any()  # the noise did move the picks


def test_gumbel_noise_is_seeded_and_standard():
    """The sampled pipeline's noise when none is passed: `vlm.generate`'s
    default generator, seeded the same on every call."""
    a = tvlm.gumbel((4, 1, 20000), tvlm._generator(None, "cpu"))
    b = tvlm.gumbel((4, 1, 20000), tvlm._generator(None, "cpu"))
    assert a.shape == (4, 1, 20000) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(a.mean()) - 0.5772) < 0.02 and abs(float(a.var()) - 1.6449) < 0.05


# --------------------------------------------------------------- untied LM

UNTIED = LMConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  rope_theta=10000.0, tie_word_embeddings=False, dtype="float32")


@functools.lru_cache(maxsize=1)
def _untied():
    jp = jqwen2.init_params(UNTIED, jax.random.key(21))
    return jp, _lm_to_torch(jp, UNTIED.num_hidden_layers)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def test_untied_init_params_tree_matches_jax():
    jp, _ = _untied()
    pcfg = _port_lm_cfg(UNTIED)
    got = tqwen2.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert got["lm_head"].shape == (64, 512)
    assert _shapes(convert.to_jax_layout({"language_model": got})["language_model"]) == _shapes(
        jax.tree.map(np.asarray, jp))
    tied = tqwen2.init_params(dataclasses.replace(pcfg, tie_word_embeddings=True),
                              torch.Generator().manual_seed(0), "cpu")
    assert "lm_head" not in tied


def test_untied_unembed_and_forward_match_jax():
    jp, tp = _untied()
    pcfg = _port_lm_cfg(UNTIED)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    np.testing.assert_allclose(tqwen2.unembed(tp, _t(x)).numpy(),
                               np.asarray(jqwen2.unembed(jp, UNTIED, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    valid = np.array([24, 17], np.int32)
    jh, jc = jqwen2.forward(jp, UNTIED, jnp.asarray(x), jnp.asarray(pos),
                            valid_len=jnp.asarray(valid), cache_max_len=28)
    th, tc = tqwen2.forward(tp, pcfg, _t(x), _t(pos), valid_len=_t(valid), cache_max_len=28)
    np.testing.assert_allclose(tqwen2.unembed(tp, th).numpy(),
                               np.asarray(jqwen2.unembed(jp, UNTIED, jh)), **TOL)
    for step in range(3):
        ids = rng.integers(0, 512, size=(2, 1))
        jh, jc = jqwen2.decode_step(jp, UNTIED, jqwen2.embed_tokens(jp, jnp.asarray(ids)), jc)
        th, tc = tqwen2.decode_step(tp, pcfg, tqwen2.embed_tokens(tp, _t(ids)), tc)
        np.testing.assert_allclose(tqwen2.unembed(tp, th).numpy(),
                                   np.asarray(jqwen2.unembed(jp, UNTIED, jh)), **TOL,
                                   err_msg=f"step {step}")


def test_untied_prequantize_matches_jax():
    """The int8 copy of `lm_head.T` and its scales: the same `x / s` on both
    sides, so the codes are equal (ROADMAP's quantisation ties do not arise:
    no fp32 sum precedes this division); `lm_head` is dropped."""
    jp, tp = _untied()
    want = jqwen2.prequantize_int8(jp, include_unembed=True)
    got = tqwen2.prequantize_int8(tp, include_unembed=True)
    assert "lm_head" not in got and "lm_head" not in want
    np.testing.assert_array_equal(got["unembed_int8"].numpy(), np.asarray(want["unembed_int8"]))
    assert got["unembed_int8"].is_contiguous() and got["unembed_int8"].shape == (512, 64)
    np.testing.assert_allclose(got["unembed_scale"].numpy(), np.asarray(want["unembed_scale"]),
                               rtol=1e-7, atol=0)
    x = np.random.default_rng(23).standard_normal((2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(tqwen2.unembed(got, _t(x)).numpy(),
                               np.asarray(jqwen2.unembed(want, UNTIED, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- the 7B int8 LM

def _leaf_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_specs(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_init_lm_7b_int8_matches_bench_tree():
    cfg = dataclasses.replace(UNTIED, num_hidden_layers=3)
    want = _leaf_specs(jax.tree.map(np.asarray, bench._init_lm_7b_int8(cfg, jax.random.key(1))))
    gen = torch.Generator().manual_seed(1)
    port = tbench.init_lm_7b_int8(_port_lm_cfg(cfg), gen, "cpu")
    stacked = {k: v for k, v in port.items() if k != "layers"}
    stacked["layers"] = {name: {key: torch.stack([lp[name][key] for lp in port["layers"]])
                                for key in port["layers"][0][name]}
                         if isinstance(port["layers"][0][name], dict)
                         else torch.stack([lp[name] for lp in port["layers"]])
                         for name in port["layers"][0]}
    got = _leaf_specs(stacked)
    assert got.keys() == want.keys()
    dtypes = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == dtypes[str(w.dtype)], name
        if name.endswith("/scale"):
            np.testing.assert_array_equal(g.numpy(), w)  # the constant 0.02 / 127
        if name.endswith(("/bias", "layernorm", "/norm")):
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
        if name.endswith("kernel_int8"):
            assert int(g.min()) >= -127 and int(g.max()) <= 127
    assert all(lp["q_proj"]["kernel_int8"].t().is_contiguous() for lp in port["layers"])


def test_untied_int8_vlm_built_like_7b_matches_bench(monkeypatch):
    """A tiny VLM built as bench.py builds the 7B one (everything at a
    one-layer LM depth, then `_init_lm_7b_int8`'s LM, then the tower
    prequantized), converted, gives bench.build_pipeline's tokens while the
    port's top-2 margin exceeds the tolerance, and its prefill logits."""
    lm = dataclasses.replace(TINY.lm, tie_word_embeddings=False)
    cfg = dataclasses.replace(TINY, lm=lm, pipeline=dataclasses.replace(TINY.pipeline,
                                                                        tower_int8=True))
    shallow = dataclasses.replace(cfg, lm=dataclasses.replace(lm, num_hidden_layers=1))
    jparams = jvlm.init_params(shallow, jax.random.key(0))
    jparams["language_model"] = bench._init_lm_7b_int8(lm, jax.random.key(1))
    jparams["vision_tower"] = jsiglip.prequantize_int8(jparams["vision_tower"])
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      convert.config_from_fields(cfg), device="cpu")
    assert "lm_head" in tparams["language_model"]
    # the JAX tower's fused path (bf16 q/k/v) is TPU-gated: force it, interpreted
    monkeypatch.setattr(jsiglip, "forward", functools.partial(jsiglip.forward, use_flash=True,
                                                              _interpret=True))
    (jtok, jlogits), (ttok, tlogits) = _both(cfg, jparams, tparams, 12, 12)
    np.testing.assert_allclose(tlogits[0], jlogits, **TOL)
    compared = 0
    for step in range(MAX_NEW):
        top2 = np.sort(tlogits[step, 0])[-2:]
        if float(top2[1] - top2[0]) <= TOL["atol"]:
            break
        assert int(ttok[step, 0]) == int(jtok[step, 0]), step
        compared += 1
    assert compared >= 1


def test_config_from_fields_gives_the_7b_config():
    got = convert.config_from_fields(VLMConfig.onevision_7b())
    assert got == tconfig.VLMConfig.onevision_7b()
    assert got.lm == tconfig.LMConfig.qwen2_7b() and not got.lm.tie_word_embeddings
    mcfg = got.memory
    assert mcfg.hidden_size == 3584 and mcfg.hidden_size // mcfg.num_attention_heads == 448
    assert tbench.serving_config("7b").pipeline.tower_int8
    assert tbench.kv_int8("7b", False) is False and tbench.kv_int8("0.5b", False) is True


# ------------------------------------------ the memory at head dim 448

WIDE_MEM = MemoryConfig(hidden_size=3584, num_attention_heads=8, patch_size=4,
                        num_memory_tokens=2, depth=1, intermediate_mult=1, cache_cap=3,
                        segment_frames=4)


@functools.lru_cache(maxsize=1)
def _wide_memory():
    jp = jmem.init_params(WIDE_MEM, jax.random.key(31))
    layers = [jax.tree.map(lambda a: np.asarray(a)[i], jp["layers"])
              for i in range(WIDE_MEM.depth)]
    tp = convert._tree({**jax.tree.map(np.asarray, jp), "layers": layers}, "cpu", None)
    pcfg = tconfig.MemoryConfig(**{f.name: getattr(WIDE_MEM, f.name)
                                   for f in dataclasses.fields(tconfig.MemoryConfig)})
    return jp, tp, pcfg


def test_memory_attention_at_head_dim_448_matches_jax():
    jp, tp, pcfg = _wide_memory()
    rng = np.random.default_rng(32)
    q_in = rng.standard_normal((1, 8, 3584)).astype(np.float32)
    kv_in = rng.standard_normal((1, 40, 3584)).astype(np.float32)
    want = jmem.attention(jp["memory_update_attention"], WIDE_MEM, jnp.asarray(q_in),
                          jnp.asarray(kv_in), kv_valid_len=jnp.asarray([29], jnp.int32))
    got = tmem.attention(tp["memory_update_attention"], pcfg, _t(q_in), _t(kv_in),
                         torch.tensor([29], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_memory_segment_step_at_head_dim_448_matches_jax():
    jp, tp, pcfg = _wide_memory()
    rng = np.random.default_rng(33)
    cache = rng.standard_normal((3, 2, 4, 3584)).astype(np.float32)
    seg = rng.standard_normal((4, 4, 3584)).astype(np.float32)
    valid = np.array([True, True, True, False])
    want = jmem.segment_step(jp, WIDE_MEM, jmem.MemoryState(jnp.asarray(cache),
                                                            jnp.asarray(2, jnp.int32)),
                             jnp.asarray(seg), jnp.asarray(valid))
    got = tmem.segment_step(tp, pcfg, tmem.MemoryState(_t(cache), 2), _t(seg), _t(valid))
    assert got.cache_len == int(want.cache_len) == 3
    np.testing.assert_allclose(got.cache.numpy(), np.asarray(want.cache), **TOL)


@pytest.mark.parametrize("causal,valid", [(False, (300, 37)), (False, (0, 1)), (True, (90, 0))])
def test_tiled_reference_at_head_dim_448_matches_pallas_interpret(causal, valid):
    """The plain version of the wide kernel, `flash_attention_reference`
    at its 32-key tile, against JAX's Pallas kernel at 64-row, 32-key
    blocks in interpret mode (no pad: interpret mode takes D = 448), bf16:
    as the narrower head dims' test holds, bit for bit but for XLA's CPU
    rounding, and closer than the one-tile version."""
    skv = 90 if causal else 300
    rng = np.random.default_rng(34 + len(valid))
    q, k, v = (rng.standard_normal((2, 90 if causal else 70, 2, 448)).astype(np.float32),
               *(rng.standard_normal((2, skv, 2, 448)).astype(np.float32) for _ in range(2)))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = pallas_flash_attention(jq, jk, jv, causal=causal,
                                  kv_valid_len=jnp.asarray(valid, jnp.int32), block_q=64,
                                  block_k=32, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    vl = torch.tensor(valid, dtype=torch.int32)
    got = flash.flash_attention_reference(tq, tk, tv, vl, causal=causal,
                                          block_k=32).float().numpy()
    one_tile = flash.flash_attention_reference(tq, tk, tv, vl, causal=causal).float().numpy()
    assert float((got == want).mean()) >= 0.995
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    if max(valid) > 32:  # some row sees two tiles, where the one-tile version differs
        assert float((one_tile == want).mean()) < float((got == want).mean())
    for bi, n in enumerate(valid):
        if n == 0:
            assert not got[bi].any()


def test_head_dim_448_reaches_the_wide_wrapper(monkeypatch):
    """`flash_attention` sends head dim 448 to `flash_forward_wide` (its
    own launch count), which takes the plain version on the CPU; the fp32
    kernel does not take 448 and the argument check says so."""
    calls = []
    real = flash.flash_forward_wide
    monkeypatch.setattr(flash, "flash_forward_wide",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    q = torch.randn(1, 5, 2, 448)
    out = flash.flash_attention(q, q, q, torch.tensor([5], dtype=torch.int32))
    assert calls == [(1, 5, 2, 448)] and out.shape == q.shape
    with pytest.raises(ValueError, match="bf16 only"):
        flash._check_kernel_args(q, q, q, torch.tensor([5], dtype=torch.int32), 448)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_forward_wide(q[..., :64], q[..., :64], q[..., :64], None, causal=False,
                                 scale=0.125, kv_groups=1)


# ------------------------------------------------------- decode's work

def _former_loop(lm, cfg, logits, cache, act_dtype, max_new_tokens):
    """The decode loop before it did JAX's work: it stopped after the last
    token's pick, so it ran one decode step and one unembed fewer."""
    tokens, rows = [], []
    for step in range(max_new_tokens):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens.append(tok)
        rows.append(logits)
        if step + 1 == max_new_tokens:
            break
        emb = tqwen2.embed_tokens(lm, tok[:, None]).to(act_dtype)
        hidden, cache = tqwen2.decode_step(lm, cfg.lm, emb, cache)
        logits = tqwen2.unembed(lm, hidden)[:, 0]
    return torch.stack(tokens), torch.stack(rows)


def test_pipeline_does_jax_decode_work(weights, monkeypatch):
    _, tparams = weights
    cfg = convert.config_from_fields(TINY)
    counts = {"decode_step": 0, "unembed": 0}
    seen = {}
    for name in counts:
        real = getattr(tqwen2, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tqwen2, name, counted)
    real_reset = tvlm._Decoder.reset

    def spy(dec, logits, st):
        seen["args"] = (logits.clone(), tqwen2.KVCache(*(x.clone() for x in dec.cache[:3])))
        return real_reset(dec, logits, st)
    monkeypatch.setattr(tvlm._Decoder, "reset", spy)
    pix = _t(_pixels(12, 5))
    fn, _ = pipeline.build_pipeline(cfg, 12, return_logits=True, max_new_tokens=32)
    tokens, _, logits = fn(tparams, pix, _t(TEXT_BEFORE), _t(TEXT_AFTER))
    assert counts == {"decode_step": 32, "unembed": 33}
    assert tokens.shape == (32, 1) and logits.shape == (32, 1, TINY.lm.vocab_size)
    monkeypatch.undo()
    logits0, cache = seen["args"]
    want_tokens, want_logits = _former_loop(tparams["language_model"], cfg, logits0, cache,
                                            torch.float32, 32)
    torch.testing.assert_close(tokens, want_tokens, rtol=0, atol=0)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)


def test_prefill_fills_a_persistent_cache_in_place():
    """`forward(cache=...)` and `quantize_cache(out=...)` write into the
    tensors they are given (the graph's persistent buffers), with the same
    values as a fresh cache."""
    jp, tp = _untied()
    pcfg = _port_lm_cfg(UNTIED)
    x = _t(np.random.default_rng(24).standard_normal((1, 20, 64)).astype(np.float32))
    pos, valid = torch.arange(20)[None], torch.tensor([17], dtype=torch.int32)
    _, fresh = tqwen2.forward(tp, pcfg, x, pos, valid_len=valid, cache_max_len=26)
    buf = tqwen2.KVCache.zeros(pcfg, 1, 26, "cpu", torch.float32)
    ptrs = [t.data_ptr() for t in buf[:3]]
    _, got = tqwen2.forward(tp, pcfg, x, pos, valid_len=valid, cache=buf)
    assert got is buf and [t.data_ptr() for t in got[:3]] == ptrs
    for a, b in zip(got[:3], fresh[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    qbuf = tqwen2.KVCache.zeros(pcfg, 1, 26, "cpu", torch.int8)
    qptrs = [t.data_ptr() for t in qbuf]
    qgot = tqwen2.quantize_cache(fresh, out=qbuf)
    assert qgot is qbuf and [t.data_ptr() for t in qgot] == qptrs
    for a, b in zip(qgot, tqwen2.quantize_cache(fresh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cannot take"):
        tqwen2.forward(tp, pcfg, x, pos, valid_len=valid,
                       cache=tqwen2.KVCache.zeros(pcfg, 1, 12, "cpu", torch.float32))


def test_decode_graph_is_only_built_on_the_card(weights, monkeypatch):
    """On the CPU the pipeline decodes eagerly and never captures a graph."""
    monkeypatch.setattr(tvlm._Decoder, "_capture", lambda *a: pytest.fail("graph on cpu"))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda *a: pytest.fail("graph on cpu"))
    fn, _ = pipeline.build_pipeline(convert.config_from_fields(TINY), 12, max_new_tokens=2)
    tokens, _ = fn(weights[1], _t(_pixels(12, 6)), _t(TEXT_BEFORE), _t(TEXT_AFTER))
    assert tokens.shape == (2, 1)
