"""Frame and image preprocessing on the device (counterpart of
`memory_augmented_vlm_tpu/ops/preprocess.py`).

The host processor (`data/preprocessing.SigLipImageProcessor`, after
reference `siglip_encoder.py:34-67`) resizes one frame at a time in PIL: a
64-frame 480x640 clip takes most of a loaded request's time on the host.
Here decoded frames cross to the card as raw uint8 (a quarter of fp32's
bytes) and are resized and normalized there, on whatever device the input
lies on.

The resize is JAX's `jax.image.resize(..., "bicubic", antialias=True)`
computed as JAX computes it: for each axis whose size changes, a weight
matrix from Keys' cubic (a = -0.5), its support widened by the scale on a
downscale, each output's weights normalized, built in float32 as JAX's
`compute_weight_mat` builds it (`_weights`); then one product per axis in
fp32. `F.interpolate(mode="bicubic", antialias=True)` is the same filter
but places its samples in double precision, which moves a non-integer
upscale by up to 4e-5 from JAX's; `antialias=False` there is another filter
(a = -0.75). The products also sidestep that kernel's shared-memory limit
on large downscales. JAX computes this in XLA, not in a Pallas kernel, so
the port's is plain torch. fp32 products run in full fp32 on the card
(PyTorch's default: TF32 off for matmul).

PIL quantizes the resized image back to uint8 before the rescale; the
device path stays in float, so it differs from the host processor by up
to about one uint8 step per channel before normalization.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from memory_augmented_vlm_torch.data.preprocessing import parse_grid_pinpoints, \
    select_best_resolution

_F32_EPS = float(np.finfo(np.float32).eps)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |offset| (float32)."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(in_size, out_size) float32 resampling weights of one axis (JAX
    `jax._src.image.scale.compute_weight_mat`, scale out/in, no
    translation, as XLA evaluates it on the CPU): half-pixel sample
    positions, the kernel's support widened
    by in/out on a downscale when `antialias`, each column normalized to
    sum 1, and zero where the sample falls outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0) if antialias else 1.0)
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one multiply-add, so the
    # position is rounded to float32 once (the float32 product is exact in
    # float64); rounding twice moves a long upscale's weights by up to 4e-5
    centres = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    sample = (centres.astype(np.float64) * float(np.float32(inv_scale)) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _F32_EPS, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize(x: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """(..., H, W, C) fp32 -> (..., *size, C): JAX's bicubic resize, one
    fp32 product per axis whose size changes (an axis of equal size is left
    as it is, as JAX leaves it), then clipped to [0, 1] (bicubic
    overshoots; PIL clamps when it requantizes)."""
    h, w = x.shape[-3], x.shape[-2]
    if h != size[0]:
        wh = torch.from_numpy(_weights(h, size[0], antialias)).to(x.device)
        x = torch.einsum("ho,...hwc->...owc", wh, x)
    if w != size[1]:
        ww = torch.from_numpy(_weights(w, size[1], antialias)).to(x.device)
        x = torch.einsum("wp,...owc->...opc", ww, x)
    return x.clamp(0.0, 1.0)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 codes (or floats in [0, 255]) -> fp32 in [0, 1], times fp32
    1/255 as JAX computes it."""
    return x.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32, device=x.device)


def preprocess_frames(frames, size: Tuple[int, int] = (384, 384),
                      image_mean: Sequence[float] = (0.5, 0.5, 0.5),
                      image_std: Sequence[float] = (0.5, 0.5, 0.5),
                      dtype: torch.dtype = torch.bfloat16,
                      antialias: bool = True) -> torch.Tensor:
    """(T, H, W, 3) uint8 (or float in [0, 255]) -> (T, *size, 3) normalized
    in `dtype`, on the input's device (numpy input: the CPU). The
    `SigLipImageProcessor` semantics: channel-last RGB, bicubic resize (only
    where the size differs, then clipped), 1/255 rescale, mean/std
    normalize; the arithmetic in fp32. `antialias=False` leaves a
    downscale's support unwidened, as JAX's flag does."""
    frames = _as_tensor(frames)
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {tuple(frames.shape)}")
    x = _unit(frames)
    if tuple(frames.shape[1:3]) != tuple(size):
        x = _resize(x, size, antialias)
    mean = torch.tensor(image_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(image_std, dtype=torch.float32, device=x.device)
    # the products leave the frames in a permuted layout: hand them on
    # contiguous, as the host processor's arrays are
    return ((x - mean) / std).to(dtype).contiguous()


def anyres_tiles(image: torch.Tensor, s: int, tw: int, th: int, nw: int, nh: int,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 (H, W, 3) -> (1 + (th // s) * (tw // s), s, s, 3) normalized
    tiles (JAX `_anyres_tiles`): the base s x s view, the aspect-kept resize
    to (nw, nh) pasted centred on a black (tw, th) canvas, both clipped,
    the canvas cut into s x s tiles row-major (rows over the height, then
    columns over the width: `divide_to_patches`' order), mean = std = 0.5."""
    x = _unit(image)
    base = _resize(x, (s, s))
    canvas = torch.zeros((th, tw, 3), dtype=torch.float32, device=x.device)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = _resize(x, (nh, nw))
    tiles = canvas.reshape(th // s, s, tw // s, s, 3).permute(0, 2, 1, 3, 4).reshape(-1, s, s, 3)
    out = torch.cat([base[None], tiles])
    return ((out - 0.5) / 0.5).to(dtype)


def preprocess_anyres_image(image, grid_pinpoints, size: Tuple[int, int] = (384, 384),
                            dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """`process_anyres_image` on the device: the host picks the grid from
    (W, H) (`select_best_resolution` over `parse_grid_pinpoints`, integer
    geometry), `anyres_tiles` does the rest on the image's device. Returns
    ((1 + n, s, s, 3) tiles, (W, H))."""
    image = _as_tensor(image)
    if image.dim() != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {tuple(image.shape)}")
    h, w = int(image.shape[0]), int(image.shape[1])
    s = size[0]
    tw, th = select_best_resolution((w, h), parse_grid_pinpoints(grid_pinpoints, s))
    scale = min(tw / w, th / h)
    nw, nh = min(math.ceil(w * scale), tw), min(math.ceil(h * scale), th)
    return anyres_tiles(image, s, tw, th, nw, nh, dtype), (w, h)
