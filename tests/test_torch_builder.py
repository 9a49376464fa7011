"""The port's `eval/builder.load_pretrained_model` and
`eval/model.MavlmForCausalLM` against the JAX package's, on the tiny
checkpoint of tests/test_builder_roundtrip.py (a 2-layer Qwen2 of width 32,
a 3-layer SigLIP of width 24 at 56², the memory modules), loaded onto the
CPU.

- config fields, `context_len`, the image processor's size and
  `overwrite_config` as JAX's;
- every leaf equal to `convert.from_jax_params` of JAX's loaded params,
  bit for bit, in fp32 and in bf16; with `load_8bit`, the int8 codes equal
  and the scales within 1e-7 relative (tests/test_torch_int8.py's rule),
  every other leaf equal;
- `NotImplementedError` for what the port does not run, a raise without a
  card unless `device_map="cpu"`, the tokenizer loaded only where the
  directory has one (its errors raised), seeded modules at JAX's shapes;
- `generate` and `generate_stream` give JAX's tokens: text only, a video of
  40 uint8 frames at 56² (and the same frames pre-normalized, channel-first,
  as a torch tensor), B = 2 with an attention mask, beam search, prompt
  lookup, and sampling with JAX's draws passed in.

The tower loads with 1 head, not the 4 its HF config had: JAX's head-count
rule (hidden // 64, at least 1, for a width outside its table), which the
port copies (ROADMAP §3, known reference-side traps).
"""

import json
import os
import shutil
import types

import numpy as np
import jax
import pytest
import torch

from memory_augmented_vlm_tpu.eval.builder import load_pretrained_model as jload
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.checkpoint import hf_import
from memory_augmented_vlm_torch.eval import builder as tbuilder
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model as tload
from memory_augmented_vlm_torch.eval.model import MavlmForCausalLM
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str
from test_builder_roundtrip import ckpt_dir  # noqa: F401  (the tiny checkpoint)
from test_torch_checkpoint import assert_trees_equal
from test_torch_generate import _jax_gumbel

SCALE_RTOL = 1e-7  # tests/test_torch_int8.py's rule for a prequantized scale
NEW = 6
VIDEO_IDS = np.array([[10, 20, constants.IMAGE_TOKEN_INDEX, 30, 40]], np.int64)


@pytest.fixture(scope="module")
def loaded(ckpt_dir):  # noqa: F811
    """Both packages' fp32 loads of the tiny checkpoint."""
    return (jload(ckpt_dir, None, "llava_qwen", torch_dtype="float32"),
            tload(ckpt_dir, None, "llava_qwen", torch_dtype="float32", device_map="cpu"))


def _frames(seed=0, n=40):
    return np.random.default_rng(seed).integers(0, 256, (n, 56, 56, 3), dtype=np.uint8)


# ------------------------------------------------------------- loading

def test_config_context_and_processor_match_jax(loaded):
    (jtok, jm, jproc, jctx), (ttok, tm, tproc, tctx) = loaded
    assert tctx == jctx == 2048
    assert tproc.size == jproc.size == (56, 56)
    assert tm.cfg == convert.config_from_fields(jm.cfg)
    assert tm.cfg.vision.num_attention_heads == 1  # JAX's head rule: 24 // 64, at least 1
    assert tm.cfg.vision.num_used_layers == 3 and tm.cfg.memory.num_memory_tokens == 2
    assert tm.cfg.memory.patch_size == 4 and tm.cfg.memory.depth == 2
    for key in ("hidden_size", "vocab_size", "max_position_embeddings", "mm_newline_position",
                "mm_spatial_pool_mode", "mm_patch_merge_type", "image_aspect_ratio",
                "tokenizer_model_max_length", "tokenizer_padding_side", "model_type"):
        assert getattr(tm.config, key) == getattr(jm.config, key), key
    assert type(ttok) is type(jtok) and ttok("hello world").input_ids == \
        jtok("hello world").input_ids
    assert tm.device == torch.device("cpu") and tm.dtype == torch.float32


@pytest.mark.parametrize("overwrite", [{"max_sequence_length": 1234},
                                       {"max_position_embeddings": None},
                                       {"image_aspect_ratio": "pad",
                                        "tokenizer_model_max_length": 777,
                                        "image_grid_pinpoints": [[56, 56], [112, 56]]}])
def test_overwrite_config_matches_jax(ckpt_dir, overwrite):  # noqa: F811
    _, jm, _, jctx = jload(ckpt_dir, None, "llava_qwen", torch_dtype="float32",
                           overwrite_config=overwrite)
    _, tm, _, tctx = tload(ckpt_dir, None, "llava_qwen", torch_dtype="float32",
                           device_map="cpu", overwrite_config=overwrite)
    assert tctx == jctx
    assert tm.cfg == convert.config_from_fields(jm.cfg)
    assert tm.config.image_aspect_ratio == jm.config.image_aspect_ratio


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_equals_jax(ckpt_dir, loaded, dtype):  # noqa: F811
    if dtype == "float32":
        (_, jm, _, _), (_, tm, _, _) = loaded
    else:
        _, jm, _, _ = jload(ckpt_dir, None, "llava_qwen", torch_dtype=dtype)
        _, tm, _, _ = tload(ckpt_dir, None, "llava_qwen", torch_dtype=dtype, device_map="cpu")
    want = convert.from_jax_params(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    assert_trees_equal(tm.params, want)
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert {x.dtype for _, x in leaves_with_path(tm.params)} == {want_dtype}


def test_load_8bit_leaves_follow_the_int8_rule(ckpt_dir):  # noqa: F811
    _, jm, _, _ = jload(ckpt_dir, None, "llava_qwen", torch_dtype="float32", load_8bit=True)
    _, tm, _, _ = tload(ckpt_dir, None, "llava_qwen", torch_dtype="float32",
                        device_map="cpu", load_8bit=True)
    assert tm.cfg.pipeline.tower_int8 and jm.cfg.pipeline.tower_int8
    want = dict(leaves_with_path(convert.from_jax_params(
        jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")))
    got = dict(leaves_with_path(tm.params))
    assert got.keys() == want.keys()
    kinds = set()
    for k, x in got.items():
        y = want[k]
        assert x.dtype == y.dtype, path_str(k)
        if k[-1] == "scale":
            kinds.add("scale")
            torch.testing.assert_close(x, y, rtol=SCALE_RTOL, atol=0, msg=path_str(k))
        else:
            if x.dtype == torch.int8:
                kinds.add("int8")
                assert x.t().is_contiguous(), path_str(k)  # column-major, the kernels' layout
            assert torch.equal(x, y), path_str(k)
    assert kinds == {"int8", "scale"}
    lm = tm.params["language_model"]
    assert "lm_head" in lm and "unembed_int8" not in lm  # the unembedding stays float
    assert "kernel_int8" in tm.params["vision_tower"]["layers"][0]["fc1"]
    assert "kernel_int8" in lm["layers"][0]["down_proj"]


@pytest.mark.parametrize("kwargs,item", [
    (dict(load_4bit=True), "item 8"),
    (dict(overwrite_config={"mm_spatial_pool_mode": "average"}), "item 8"),
    (dict(overwrite_config={"mm_newline_position": "frame"}), "item 8"),
    (dict(overwrite_config={"mm_projector_type": "linear"}), "item 8"),
    (dict(overwrite_config={"learnable_pe": True}), "item 8"),
    (dict(overwrite_config={"model_type": "llava_mixtral"}), "item 8"),
    (dict(overwrite_config={"mm_vision_tower": "openai/clip-vit-large-patch14-336"}), "item 8"),
])
def test_unported_modes_raise(ckpt_dir, kwargs, item):  # noqa: F811
    with pytest.raises(NotImplementedError, match=item):
        tload(ckpt_dir, torch_dtype="float32", device_map="cpu", **kwargs)


def test_clip_weights_raise():
    shapes = _Shapes({"vision_model.embeddings.class_embedding": (24,),
                      "vision_model.embeddings.patch_embedding.weight": (24, 3, 14, 14)})
    with pytest.raises(NotImplementedError, match="item 8"):
        tbuilder.infer_vision_config(shapes, "google/siglip-so400m-patch14-384")


class _Shapes:
    """A checkpoint's names and shapes, without tensors, as the port's
    builder reads them (`keys`, `shape`) and as JAX's does (a dict of
    arrays)."""

    def __init__(self, shapes):
        self.shapes = shapes

    def keys(self):
        return list(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def shape(self, k):
        return self.shapes[k]

    def __getitem__(self, k):
        return types.SimpleNamespace(shape=self.shapes[k])


def _siglip_shapes(hidden, side, patch=14, layers=2):
    p = "vision_tower.vision_model."
    shapes = {p + "embeddings.patch_embedding.weight": (hidden, 3, patch, patch),
              p + "embeddings.position_embedding.weight": (side * side, hidden)}
    for i in range(layers):
        shapes[p + f"encoder.layers.{i}.mlp.fc1.weight"] = (4 * hidden, hidden)
    return shapes


@pytest.mark.parametrize("tower", ["google/siglip-so400m-patch14-384", "siglip"])
def test_image_size_is_the_published_one(tower):
    """The SO400M tower's 27 x 27 position table: the port configures the
    384 px its name publishes (the reference's processor size); JAX's
    builder configures 27 * 14 = 378 (ROADMAP §3). Without a size in the
    name both take side * patch."""
    from memory_augmented_vlm_tpu.eval.builder import infer_vision_config as jinfer

    shapes = _Shapes(_siglip_shapes(1152, 27))
    got, want = tbuilder.infer_vision_config(shapes, tower), jinfer(shapes, tower)
    assert want.image_size == 378 and got.num_attention_heads == want.num_attention_heads == 16
    assert got.image_size == (384 if "384" in tower else 378)
    assert got.num_patches_per_side == want.num_patches_per_side == 27
    assert got.num_used_layers == want.num_used_layers == 2
    # a table the name's size does not fit takes side * patch, as JAX
    tiny = _Shapes(_siglip_shapes(24, 4))
    assert tbuilder.infer_vision_config(tiny, tower).image_size == jinfer(tiny, tower).image_size == 56


def test_no_card_raises_unless_cpu(ckpt_dir, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device_map in ("auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tload(ckpt_dir, torch_dtype="float32", device_map=device_map)
    with pytest.raises(ValueError, match="device_map"):
        tload(ckpt_dir, torch_dtype="float32", device_map="mps")
    _, model, _, _ = tload(ckpt_dir, torch_dtype="float32", device_map="cpu")
    assert model.device.type == "cpu"


def _copy(src, dst, keep=lambda name: True):
    os.makedirs(dst)
    for name in os.listdir(src):
        if keep(name):
            shutil.copy(os.path.join(src, name), dst)
    return str(dst)


def test_tokenizer_only_where_the_directory_has_one(ckpt_dir, tmp_path):  # noqa: F811
    bare = _copy(ckpt_dir, tmp_path / "bare", keep=lambda n: not n.startswith("tokenizer"))
    tok, _, _, _ = tload(bare, torch_dtype="float32", device_map="cpu")
    assert tok is None
    broken = _copy(ckpt_dir, tmp_path / "broken")
    with open(os.path.join(broken, "tokenizer.json"), "w") as f:
        f.write("{ not json")
    with pytest.raises(Exception):  # the tokenizer's own error, not hidden
        tload(broken, torch_dtype="float32", device_map="cpu")


def test_missing_modules_are_seeded_at_jax_shapes(ckpt_dir, tmp_path):  # noqa: F811
    """A checkpoint without the projector and the memory: both are seeded,
    at the shapes JAX initialises (JAX's draws cannot be matched)."""
    from safetensors.torch import load_file, save_file

    out = _copy(ckpt_dir, tmp_path / "lm_and_tower", keep=lambda n: n == "config.json")
    sd = load_file(os.path.join(ckpt_dir, "model.safetensors"))
    keep = {k: v for k, v in sd.items() if not any(
        t in k for t in ("mm_projector", "recurrent_memory_transformer", "memory_fuser",
                         "token_type_embedding", "image_newline"))}
    save_file(keep, os.path.join(out, "model.safetensors"))
    _, jm, _, _ = jload(out, None, "llava_qwen", torch_dtype="float32")
    _, tm, _, _ = tload(out, torch_dtype="float32", device_map="cpu")
    want = dict(leaves_with_path(convert.from_jax_params(
        jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")))
    got = dict(leaves_with_path(tm.params))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, path_str(k)
        if k[0] in ("language_model", "vision_tower", "positional_encoding"):
            assert torch.equal(got[k], want[k]), path_str(k)
    # without tower weights the geometry is the default SO400M one
    no_tower = hf_import.Tensors({k: v for k, v in sd.items() if "vision_tower" not in k})
    cfg = tbuilder.config_from_json_and_weights(json.load(open(os.path.join(out, "config.json"))),
                                                no_tower)
    assert cfg.vision.hidden_size == 1152 and cfg.vision.num_used_layers == 26


# ------------------------------------------------------------ generate

def _generate_both(loaded, *args, **kwargs):
    (_, jm, _, _), (_, tm, _, _) = loaded
    return np.asarray(jm.generate(*args, **kwargs)), tm.generate(*args, **kwargs)


def test_text_only_generate_matches_jax(loaded):
    want, got = _generate_both(loaded, np.array([[10, 20, 30, 40, 50]]), max_new_tokens=NEW)
    assert got.dtype == np.int64 and got.shape == (1, NEW)
    np.testing.assert_array_equal(got, want)


def test_video_generate_from_uint8_frames_matches_jax(loaded):
    frames = _frames()
    want, got = _generate_both(loaded, VIDEO_IDS, images=[frames], modalities=["video"],
                               max_new_tokens=NEW)
    assert got.shape == (1, NEW) and len(set(got[0].tolist())) > 1
    np.testing.assert_array_equal(got, want)
    # the processor's output, channel-first as a torch tensor, takes the same path
    (_, _, jproc, _), (_, tm, tproc, _) = loaded
    pixels = tproc.preprocess(frames)
    np.testing.assert_array_equal(pixels, jproc.preprocess(frames))
    chw = torch.from_numpy(pixels).permute(0, 3, 1, 2)
    again = tm.generate(torch.from_numpy(VIDEO_IDS), images=[chw], modalities=["video"],
                        max_new_tokens=NEW)
    np.testing.assert_array_equal(again, got)


def test_batched_generate_with_attention_mask_matches_jax(loaded):
    pad = 0
    ids = np.array([[pad, pad, 10, 20, constants.IMAGE_TOKEN_INDEX, 30],
                    [11, 21, 31, 41, constants.IMAGE_TOKEN_INDEX, 51]], np.int64)
    mask = np.array([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]])
    want, got = _generate_both(loaded, ids, images=[_frames(1, 24), _frames(2, 40)],
                               modalities=["video", "video"], attention_mask=mask,
                               max_new_tokens=NEW)
    assert got.shape == want.shape == (2, NEW)
    np.testing.assert_array_equal(got, want)


def test_beam_search_matches_jax(loaded):
    want, got = _generate_both(loaded, VIDEO_IDS, images=[_frames(3)], modalities=["video"],
                               num_beams=2, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


def test_prompt_lookup_matches_jax_and_greedy(loaded):
    ids = np.array([[10, 20, 30, constants.IMAGE_TOKEN_INDEX, 10, 20, 30, 40]], np.int64)
    kw = dict(images=[_frames(4)], modalities=["video"], max_new_tokens=NEW)
    want, got = _generate_both(loaded, ids, prompt_lookup_num_tokens=3, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, loaded[1][1].generate(ids, **kw))


def test_sampled_generate_takes_jax_draws(loaded):
    (_, jm, _, _), (_, tm, _, _) = loaded
    kw = dict(images=[_frames(5)], modalities=["video"], max_new_tokens=NEW, do_sample=True,
              temperature=0.9, top_k=50)
    want = np.asarray(jm.generate(VIDEO_IDS, rng_seed=3, **kw))
    noise = torch.from_numpy(_jax_gumbel(jax.random.key(3), NEW,
                                         (1, tm.cfg.lm.vocab_size)))
    got = tm.generate(VIDEO_IDS, noise=noise, **kw)
    np.testing.assert_array_equal(got, want)
    # without noise given, a seeded generator draws (the same run twice)
    a, b = tm.generate(VIDEO_IDS, rng_seed=1, **kw), tm.generate(VIDEO_IDS, rng_seed=1, **kw)
    np.testing.assert_array_equal(a, b)


def test_generate_stream_matches_jax(loaded):
    (_, jm, _, _), (_, tm, _, _) = loaded
    kw = dict(images=[_frames(6)], modalities=["video"], max_new_tokens=10, chunk_size=4)
    want = [np.asarray(c).tolist() for c in jm.generate_stream(VIDEO_IDS, **kw)]
    got = [c.tolist() for c in tm.generate_stream(VIDEO_IDS, **kw)]
    assert got == want and len(got) == 3
    whole = tm.generate(VIDEO_IDS, images=kw["images"], modalities=["video"],
                        max_new_tokens=10)
    assert sum(got, []) == whole[0].tolist()


def test_image_modality_and_wrong_tiles_raise(loaded):
    """An image now runs (the anyres path, JAX's tokens); pre-normalized
    tiles of the wrong size still raise."""
    want, got = _generate_both(loaded, VIDEO_IDS, images=[_frames()[0]], modalities=["image"],
                               max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    tm = loaded[1][1]
    with pytest.raises(ValueError, match="56x56"):
        tm.generate(VIDEO_IDS, images=[np.zeros((4, 48, 48, 3), np.float32)],
                    modalities=["video"], max_new_tokens=2)


def test_model_shell_takes_the_params_device(loaded):
    tm = loaded[1][1]
    shell = MavlmForCausalLM(tm.params, tm.cfg, {"extra_field": 7}, dtype=torch.float32)
    assert shell.device == torch.device("cpu") and shell.config.extra_field == 7
    assert shell.eval() is shell and shell.to("cuda") is shell
