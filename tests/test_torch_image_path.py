"""The port's single-image path (`memory_augmented_vlm_torch/models/image_path.py`)
and the image and device-preprocess branches of `eval/model.MavlmForCausalLM`
against the JAX package's, on the tiny config of tests/test_vlm.py (tower
56 px, 4 x 4 patches), fp32, the same converted weights and numpy-seeded
images.

- `get_anyres_image_grid_shape` and `unpad_image_map` equal to JAX's (the
  reference's integer geometry: `int()` truncations, `//` paddings);
- `build_image_embeds` within 1e-5 of JAX's for a single view (flat and a
  newline), anyres with unpad, the `anyres_max_N` bilinear downscale,
  `nobase`, and the grid without unpad; `image_qa_embeds` from a PIL image;
- `generate(modalities=["image"])` gives JAX's tokens (LM matrices times 5,
  so that greedy tokens vary): a uint8 image through the host anyres
  processor, through the device preprocess, a pre-normalized single view,
  and explicit `image_sizes`; the embeddings of both processors within the
  host processor's quantization (JAX's envelope);
- a uint8 video with `device_preprocess` gives JAX's tokens, and the same
  tokens as the frames preprocessed first;
- the tower's patch embeddings are contiguous whatever the pixels' strides
  (channel-first tensors made channel-last, the preprocess's products):
  the int8 layers' kernels refuse anything else on the card.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from memory_augmented_vlm_tpu.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_tpu.data.preprocessing import process_anyres_image
from memory_augmented_vlm_tpu.eval.model import MavlmForCausalLM as JModel
from memory_augmented_vlm_tpu.models import image_path as jimage
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.eval.model import MavlmForCausalLM as TModel
from memory_augmented_vlm_torch.models import image_path as timage
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.ops import preprocess as tpre
from test_vlm import TINY

EMBED_TOL = 1e-5  # fp32 tower and projector on the CPU in both packages
NEW = 6
IDS = np.array([[10, 20, constants.IMAGE_TOKEN_INDEX, 30, 40]], np.int64)
PINPOINTS = "(1x1),...,(3x3)"


def _cfg(**pipeline):
    return dataclasses.replace(TINY, pipeline=dataclasses.replace(
        TINY.pipeline, image_grid_pinpoints=PINPOINTS, **pipeline))


@pytest.fixture(scope="module")
def weights():
    """JAX's seeded tiny params, LM matrices times 5 (lively greedy tokens),
    and the port's conversion of them."""
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    jp = dict(jp, language_model=jax.tree.map(lambda a: a * 5 if a.ndim >= 2 else a,
                                              jp["language_model"]))
    return jp, convert.from_jax_params(jp, convert.config_from_fields(TINY), device="cpu")


def _image(hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("size", [(120, 80), (80, 120), (56, 56), (700, 300), (1920, 1080),
                                  (1000, 999)])
@pytest.mark.parametrize("pinpoints,patch", [("(1x1),...,(6x6)", 384), (PINPOINTS, 56),
                                             (((384, 768), (768, 384)), 384)])
def test_grid_shape_matches_jax(size, pinpoints, patch):
    assert timage.get_anyres_image_grid_shape(size, pinpoints, patch) == \
        jimage.get_anyres_image_grid_shape(size, pinpoints, patch)


@pytest.mark.parametrize("original", [(200, 100), (50, 300), (1920, 1080), (1080, 1920),
                                      (135, 81), (7, 3)])
@pytest.mark.parametrize("grid", [(10, 6), (81, 135), (12, 12)])
def test_unpad_matches_jax(original, grid):
    fmap = np.random.default_rng(1).standard_normal((3, *grid)).astype(np.float32)
    want = np.asarray(jimage.unpad_image_map(jnp.asarray(fmap), original))
    got = timage.unpad_image_map(torch.from_numpy(fmap), original)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- embeddings

VARIANTS = {
    "single_view": dict(image_aspect_ratio="square"),
    "anyres_unpad": dict(),
    "anyres_max_downscale": dict(image_aspect_ratio="anyres_max_1"),
    "nobase": dict(mm_patch_merge_type="spatial_unpad_nobase"),
    "grid_without_unpad": dict(mm_patch_merge_type="spatial"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_image_embeds_matches_jax(weights, variant):
    jp, tp = weights
    cfg = _cfg(**VARIANTS[variant])
    img = Image.fromarray(_image((80, 150), seed=2))
    proc = SigLipImageProcessor(size=(56, 56))
    if variant == "single_view":
        pixels, size = proc.preprocess(img), img.size
    else:
        pixels, size = process_anyres_image(img, proc, PINPOINTS)
    want = np.asarray(jimage.build_image_embeds(jp, cfg, pixels, size))
    got = timage.build_image_embeds(tp, convert.config_from_fields(cfg), pixels, size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMBED_TOL)
    if variant == "anyres_max_downscale":  # the budget of one 4 x 4 view cut the grid
        npw, nph = jimage.get_anyres_image_grid_shape(size, PINPOINTS, 56)
        assert got.shape[0] < 16 + nph * 4 * (npw * 4 + 1)


def test_image_qa_embeds_matches_jax(weights):
    jp, tp = weights
    img = Image.fromarray(_image((90, 70), seed=3))
    cfg = _cfg()
    want = np.asarray(jimage.image_qa_embeds(jp, cfg, img, IDS[0]))
    got = timage.image_qa_embeds(tp, convert.config_from_fields(cfg), img, IDS[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMBED_TOL)


# ------------------------------------------------------------- generate

def _models(weights, cfg, device_preprocess):
    jp, tp = weights
    return (JModel(jp, cfg, dtype=jnp.float32, device_preprocess=device_preprocess),
            TModel(tp, convert.config_from_fields(cfg), dtype=torch.float32,
                   device_preprocess=device_preprocess))


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_uint8_image_generate_matches_jax(weights, device_preprocess):
    jm, tm = _models(weights, _cfg(), device_preprocess)
    img = _image((90, 70), seed=4)
    kw = dict(images=[img[None]], modalities=["image"], max_new_tokens=NEW)
    want = np.asarray(jm.generate(IDS, **kw))
    got = tm.generate(IDS, **kw)
    assert got.shape == (1, NEW) and len(set(got[0].tolist())) > 1
    np.testing.assert_array_equal(got, want)
    # a torch tensor of the image takes the same path
    np.testing.assert_array_equal(tm.generate(torch.from_numpy(IDS), images=[
        torch.from_numpy(img)], modalities=["image"], max_new_tokens=NEW), got)


def test_device_and_host_processor_embeds_agree(weights):
    """The two processors' spliced sequences: the same length, and within
    the host processor's uint8 requantization through one tower forward
    (JAX's envelope for its uint8 video path, 0.15 relative RMS)."""
    host = _models(weights, _cfg(), False)[1]
    dev = _models(weights, _cfg(), True)[1]
    img = _image((90, 70), seed=5)
    a = host._row_embeds(IDS[0], [img[None]], "image")
    b = dev._row_embeds(IDS[0], [img[None]], "image")
    assert a.shape == b.shape
    rel = float((a - b).pow(2).mean().sqrt() / a.pow(2).mean().sqrt())
    assert rel < 0.15, rel


def test_normalized_view_and_image_sizes_match_jax(weights):
    jm, tm = _models(weights, _cfg(), False)
    img = Image.fromarray(_image((90, 70), seed=6))
    proc = SigLipImageProcessor(size=(56, 56))
    view = proc.preprocess(img)  # one 56 x 56 view: flat and a newline
    tiles, size = process_anyres_image(img, proc, PINPOINTS)
    for kw in (dict(images=[view]), dict(images=[tiles], image_sizes=[size])):
        want = np.asarray(jm.generate(IDS, modalities=["image"], max_new_tokens=NEW, **kw))
        np.testing.assert_array_equal(tm.generate(IDS, modalities=["image"],
                                                  max_new_tokens=NEW, **kw), want)
    stream = [c.tolist() for c in tm.generate_stream(IDS, images=[tiles], image_sizes=[size],
                                                     modalities=["image"], max_new_tokens=NEW,
                                                     chunk_size=4)]
    assert sum(stream, []) == want[0].tolist()


def test_uint8_video_with_device_preprocess_matches_jax(weights):
    """13 frames (not a multiple of the segment: JAX pads the uint8 frames,
    the port the features) through the device preprocess: JAX's tokens,
    and the tokens of the same frames preprocessed first and fed as
    float."""
    jm, tm = _models(weights, TINY, True)
    frames = np.random.default_rng(7).integers(0, 256, (13, 60, 80, 3), dtype=np.uint8)
    kw = dict(modalities=["video"], max_new_tokens=NEW)
    want = np.asarray(jm.generate(IDS, images=[frames], **kw))
    got = tm.generate(IDS, images=[frames], **kw)
    np.testing.assert_array_equal(got, want)
    pixels = tpre.preprocess_frames(frames, size=(56, 56), dtype=torch.float32)
    np.testing.assert_array_equal(tm.generate(IDS, images=[pixels], **kw), got)


def test_tower_hidden_is_contiguous_for_any_pixel_layout(weights):
    tp = weights[1]
    vision = convert.config_from_fields(TINY).vision
    chw = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 3, 56, 56),
                                                                     dtype=np.float32))
    for pixels in (chw.permute(0, 2, 3, 1), chw.permute(0, 2, 3, 1).contiguous(),
                   tpre.preprocess_frames(_image((48, 64))[None], size=(56, 56),
                                          dtype=torch.float32)):
        hidden = tsiglip.embed_patches(tp["vision_tower"], vision, pixels)
        assert hidden.is_contiguous()
        np.testing.assert_array_equal(hidden.numpy(), tsiglip.embed_patches(
            tp["vision_tower"], vision, pixels.contiguous()).numpy())
