"""Single-image (anyres / spatial_unpad) path (counterpart of
`memory_augmented_vlm_tpu/models/image_path.py`): the LLaVA-OneVision
inheritance the reference keeps beside the video spine
(llava/model/llava_arch.py:635-698, llava/mm_utils.py anyres helpers).

Flow for `image_aspect_ratio="anyres_max_9"` and `mm_patch_merge_type=
"spatial_unpad"`:
  host or device: pick the best grid resolution, pad and split the image
        into s x s tiles plus a base s x s view (`data/preprocessing.
        process_anyres_image` on the host, `ops/preprocess.
        preprocess_anyres_image` on the card);
  device: tower and projector over all tiles (no 2x2 pool for images); the
        base view's features stay flat; the grid's tiles are re-assembled
        into an (H, nph*side, npw*side) map, unpadded back to the image's
        aspect, bilinear-downscaled when it exceeds `anyres_max_N`'s patch
        budget (llava_arch.py:666-677), given an `image_newline` column,
        flattened and put after the base view.
"""

from __future__ import annotations

import math
import re
from typing import Tuple

import numpy as np
import torch

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor, \
    parse_grid_pinpoints, process_anyres_image, select_best_resolution
from memory_augmented_vlm_torch.models import projector as projector_mod
from memory_augmented_vlm_torch.models import siglip
from memory_augmented_vlm_torch.models.vlm import splice_image_embeds
from memory_augmented_vlm_torch.ops.pooling import bilinear_resize


def get_anyres_image_grid_shape(image_size: Tuple[int, int], grid_pinpoints,
                                patch_size: int) -> Tuple[int, int]:
    """(num_patch_width, num_patch_height) of the selected grid resolution
    (llava/mm_utils.py get_anyres_image_grid_shape)."""
    possible = parse_grid_pinpoints(grid_pinpoints, patch_size)
    width, height = select_best_resolution(image_size, possible)
    return width // patch_size, height // patch_size


def unpad_image_map(feature_map: torch.Tensor, original_size: Tuple[int, int]) -> torch.Tensor:
    """Remove the aspect-ratio padding from an (H, gh, gw) feature map
    (llava_arch.py:231-263 `unpad_image`; original_size = (width, height)),
    with the reference's `int()` truncations and floor divisions."""
    original_width, original_height = original_size
    _, current_height, current_width = feature_map.shape
    original_aspect = original_width / original_height
    current_aspect = current_width / current_height
    if original_aspect > current_aspect:
        scale = current_width / original_width
        new_height = int(original_height * scale)
        padding = (current_height - new_height) // 2
        return feature_map[:, padding:current_height - padding, :]
    scale = current_height / original_height
    new_width = int(original_width * scale)
    padding = (current_width - new_width) // 2
    return feature_map[:, :, padding:current_width - padding]


def _pixels(params, pixels) -> torch.Tensor:
    """Tiles on the weights' device in their float dtype (JAX feeds the
    tower bf16 under a bf16 LM, else fp32; the port's LM dtype is its
    weights')."""
    emb = params["language_model"]["embed_tokens"]
    if not isinstance(pixels, torch.Tensor):
        pixels = torch.from_numpy(np.ascontiguousarray(pixels))
    return pixels.to(emb.device, emb.dtype)


def build_image_embeds(params, cfg: VLMConfig, pixels, image_size: Tuple[int, int]
                       ) -> torch.Tensor:
    """anyres tiles (1 + n_tiles, s, s, 3), numpy or a tensor, of an image
    of `image_size` (width, height) -> its (L, H) visual sequence. The tower
    runs in int8 where it is prequantized (`cfg.pipeline.tower_int8`); the
    tower and projector run under `torch.no_grad()` (JAX's
    `stop_gradient`)."""
    pipe = cfg.pipeline
    with torch.no_grad():
        feats = siglip.forward(params["vision_tower"], cfg.vision, _pixels(params, pixels),
                               int8=pipe.tower_int8)
        feats = projector_mod.forward(params["mm_projector"], feats)

    side = cfg.vision.num_patches_per_side
    h = feats.shape[-1]
    newline = params["memory"]["image_newline"].to(feats.dtype)

    if feats.shape[0] == 1:
        # a single s x s view: flat, and a newline under unpad (llava_arch.py:692-698)
        flat = feats[0]
        if "unpad" in pipe.mm_patch_merge_type:
            flat = torch.cat([flat, newline[None]], dim=0)
        return flat

    base = feats[0]
    npw, nph = get_anyres_image_grid_shape(image_size, pipe.image_grid_pinpoints,
                                           cfg.vision.image_size)
    grid = feats[1:].reshape(nph, npw, side, side, h)

    m = re.match(r"anyres_max_(\d+)", pipe.image_aspect_ratio)
    max_num_patches = int(m.group(1)) if m else None

    if "unpad" in pipe.mm_patch_merge_type:
        # (nph, npw, s, s, H) -> (H, nph*s, npw*s)
        fmap = grid.permute(4, 0, 2, 1, 3).reshape(h, nph * side, npw * side)
        fmap = unpad_image_map(fmap, image_size)
        if max_num_patches is not None:
            _, gh, gw = fmap.shape
            times = math.sqrt(gh * gw / (max_num_patches * side ** 2))
            if times > 1.1:
                fmap = bilinear_resize(fmap.permute(1, 2, 0), int(gh // times),
                                       int(gw // times)).permute(2, 0, 1)
        _, gh, gw = fmap.shape
        col = newline[:, None, None].expand(h, gh, 1)
        tile_tokens = torch.cat([fmap, col], dim=2).reshape(h, -1).t()  # (gh*(gw+1), H)
    else:
        tile_tokens = grid.permute(0, 2, 1, 3, 4).reshape(-1, h)

    if "nobase" in pipe.mm_patch_merge_type:
        return tile_tokens
    return torch.cat([base, tile_tokens], dim=0)


def splice(params, input_ids, visual: torch.Tensor) -> torch.Tensor:
    """The visual sequence in place of the single IMAGE_TOKEN_INDEX of
    `input_ids` (S,): `vlm.splice_image_embeds` between the ids before and
    after it."""
    ids = np.asarray(input_ids)
    pos = int(np.where(ids == constants.IMAGE_TOKEN_INDEX)[0][0])
    return splice_image_embeds(params, torch.as_tensor(ids[:pos], dtype=torch.long), visual,
                               torch.as_tensor(ids[pos + 1:], dtype=torch.long))


def image_qa_embeds(params, cfg: VLMConfig, image, input_ids, image_processor=None
                    ) -> torch.Tensor:
    """PIL image and ids (S,) with one IMAGE_TOKEN_INDEX -> the spliced
    embedding sequence (the docs/image_tutorial.py flow, BASELINE config
    #1): the host processor (anyres where the config asks for it), then
    `build_image_embeds` on the weights' device and the splice."""
    processor = image_processor or SigLipImageProcessor(
        size=(cfg.vision.image_size, cfg.vision.image_size))
    if cfg.pipeline.image_aspect_ratio.startswith("anyres"):
        pixels, size = process_anyres_image(image, processor, cfg.pipeline.image_grid_pinpoints)
    else:
        pixels, size = processor.preprocess(image), image.size
    return splice(params, input_ids, build_image_embeds(params, cfg, pixels, tuple(size)))
