"""Host-side image preprocessing (a copy of
`memory_augmented_vlm_tpu/data/preprocessing.py` that imports Pillow only
inside the functions that use it, so the port imports without it).

Reproduces the reference `SigLipImageProcessor` pipeline bit-for-bit
(siglip_encoder.py:34-67): convert to RGB, PIL bicubic resize to 384x384,
rescale by 1/255, normalize with mean=std=0.5.  Output is **channel-last**
(H, W, C) float32 — the TPU conv layout consumed by models/siglip.py
(the reference emits channel-first for torch; only the layout differs).

Also provides the anyres geometry helpers used by the single-image path
(llava/mm_utils.py: process_anyres_image / select_best_resolution).
"""

from __future__ import annotations

import ast
import math
from typing import List, Sequence, Tuple, Union

import numpy as np


class SigLipImageProcessor:
    """Drop-in equivalent of the reference processor (numpy/channel-last)."""

    def __init__(
        self,
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
        size=(384, 384),
        rescale_factor=1 / 255,
    ):
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.size = tuple(size)
        self.rescale_factor = np.float32(rescale_factor)
        self.crop_size = {"height": size[0], "width": size[1]}

    def preprocess_one(self, image: Union["Image.Image", np.ndarray]) -> np.ndarray:
        from PIL import Image

        if isinstance(image, np.ndarray):
            image = Image.fromarray(image.astype(np.uint8))
        image = image.convert("RGB")
        # PIL resize takes (width, height); reference `resize` helper uses
        # bicubic with the same convention.
        image = image.resize((self.size[1], self.size[0]), Image.BICUBIC)
        arr = np.asarray(image, dtype=np.float32) * self.rescale_factor
        arr = (arr - self.image_mean) / self.image_std
        return arr  # (H, W, C)

    def preprocess(self, images) -> np.ndarray:
        from PIL import Image

        if isinstance(images, (Image.Image, np.ndarray)) and not (
            isinstance(images, np.ndarray) and images.ndim == 4
        ):
            images = [images]
        return np.stack([self.preprocess_one(im) for im in images])  # (N, H, W, C)

    __call__ = preprocess


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """Pick the grid resolution maximizing effective resolution then minimizing
    waste (llava/mm_utils.py select_best_resolution semantics)."""
    original_width, original_height = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        dw, dh = int(original_width * scale), int(original_height * scale)
        effective = min(dw * dh, original_width * original_height)
        wasted = (width * height) - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best_fit = (width, height)
    return best_fit


def parse_grid_pinpoints(grid_pinpoints, patch_size: int) -> List[Tuple[int, int]]:
    """Accept either a literal list or the `(1x1),...,(6x6)` range syntax used
    by the active recipe (scripts/train/finetune_short.sh)."""
    if isinstance(grid_pinpoints, (list, tuple)):
        return [tuple(p) for p in grid_pinpoints]
    s = grid_pinpoints.strip()
    if "x" in s and "(" in s:
        import re

        dims = re.findall(r"\((\d+)x(\d+)\)", s)
        if len(dims) == 2 and "..." in s:
            (a1, b1), (a2, b2) = [(int(a), int(b)) for a, b in dims]
            pts = []
            for i in range(a1, a2 + 1):
                for j in range(b1, b2 + 1):
                    pts.append((i * patch_size, j * patch_size))
            return pts
        return [(int(a) * patch_size, int(b) * patch_size) for a, b in dims]
    return [tuple(p) for p in ast.literal_eval(s)]


def divide_to_patches(image: "Image.Image", patch_size: int) -> List["Image.Image"]:
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def resize_and_pad_image(image: "Image.Image", target: Tuple[int, int]) -> "Image.Image":
    """Aspect-preserving resize then center-pad to target (mm_utils semantics)."""
    from PIL import Image

    tw, th = target
    w, h = image.size
    scale = min(tw / w, th / h)
    nw, nh = min(math.ceil(w * scale), tw), min(math.ceil(h * scale), th)
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def process_anyres_image(
    image: "Image.Image", processor: SigLipImageProcessor, grid_pinpoints
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """anyres single-image path: base 384² view + best-resolution grid patches
    (llava/mm_utils.py process_anyres_image). Returns ((1+n, H, W, C), size)."""
    possible = parse_grid_pinpoints(grid_pinpoints, processor.size[0])
    best = select_best_resolution(image.size, possible)
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, processor.crop_size["height"])
    base = image.resize((processor.size[1], processor.size[0]))
    all_images = [base] + patches
    return processor.preprocess(all_images), image.size
