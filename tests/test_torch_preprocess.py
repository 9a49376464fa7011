"""The port's device preprocess (`memory_augmented_vlm_torch/ops/preprocess.py`)
against the JAX package's (`ops/preprocess.py`) on the CPU, on numpy-seeded
uint8 inputs.

- `preprocess_frames` at the identity size (within 1e-6: only the rescale
  and normalize run), a downscale (480x640), an upscale (48x64) and an odd
  aspect (300x700 -> 384x384: the height up, the width down), fp32 within
  1e-5 (JAX builds its weights in float32 under XLA, whose roundings the
  port follows to about 1e-6) and bf16 within one bf16 step at 1 (2^-8:
  both round the same fp32 values); `antialias=False` matches JAX's flag
  and is a control that must fail the antialiased check on every size it
  changes, as must PyTorch's own bicubic (`F.interpolate`, a = -0.75);
- the anyres tiles against `preprocess_anyres_image` (the 500x700 image of
  tests/test_device_preprocess.py on a 3x3 grid, and the card phase's
  1920x1080 on the 6x6 one), within 1e-5, the image's (W, H) equal;
- both against the host processor within JAX's quantization envelope
  (tests/test_device_preprocess.py: PIL requantizes to uint8 after the
  resize, the device path stays in float).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from memory_augmented_vlm_tpu.data.preprocessing import SigLipImageProcessor as JProcessor
from memory_augmented_vlm_tpu.data.preprocessing import process_anyres_image as jprocess_anyres
from memory_augmented_vlm_tpu.ops import preprocess as jpre
from memory_augmented_vlm_torch.ops import preprocess as tpre

F32_TOL = 1e-5
IDENTITY_TOL = 1e-6
BF16_STEP = 2.0 ** -8
SIZES = {"identity": (384, 384), "down": (480, 640), "up": (48, 64), "odd": (300, 700)}


def _frames(hw, seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _jax(frames, dtype=jnp.float32, antialias=True):
    return np.asarray(jpre.preprocess_frames(jnp.asarray(frames), dtype=dtype,
                                             antialias=antialias).astype(jnp.float32))


@pytest.mark.parametrize("name", list(SIZES))
def test_preprocess_frames_fp32_matches_jax(name):
    frames = _frames(SIZES[name])
    got = tpre.preprocess_frames(frames, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 384, 384, 3) and got.is_contiguous()
    tol = IDENTITY_TOL if name == "identity" else F32_TOL
    np.testing.assert_allclose(got.numpy(), _jax(frames), rtol=0, atol=tol)
    # a tensor input gives the same on its device
    again = tpre.preprocess_frames(torch.from_numpy(frames), dtype=torch.float32)
    assert again.device.type == "cpu" and torch.equal(again, got)


@pytest.mark.parametrize("name", list(SIZES))
def test_preprocess_frames_bf16_matches_jax(name):
    frames = _frames(SIZES[name], seed=1)
    got = tpre.preprocess_frames(frames)  # bf16, the default, as JAX's
    assert got.dtype == torch.bfloat16
    want = _jax(frames, dtype=jnp.bfloat16)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= BF16_STEP, diff.max()


@pytest.mark.parametrize("name", ["down", "up", "odd"])
def test_antialias_false_is_a_control_that_fails(name):
    frames = _frames(SIZES[name], seed=2)
    want = _jax(frames)
    no_aa = tpre.preprocess_frames(frames, dtype=torch.float32, antialias=False).numpy()
    # the port's flag is JAX's: the support is not widened on a downscale
    np.testing.assert_allclose(no_aa, _jax(frames, antialias=False), rtol=0, atol=F32_TOL)
    if name != "up":  # an upscale widens nothing: the flag changes nothing there
        assert np.abs(no_aa - want).max() > 100 * F32_TOL
    # PyTorch's bicubic without antialias is another filter (a = -0.75)
    x = torch.from_numpy(frames).float().permute(0, 3, 1, 2) / 255.0
    torch_bicubic = F.interpolate(x, size=(384, 384), mode="bicubic", antialias=False,
                                  align_corners=False).clamp(0, 1).permute(0, 2, 3, 1)
    assert np.abs((torch_bicubic.numpy() - 0.5) / 0.5 - want).max() > 100 * F32_TOL


@pytest.mark.parametrize("hw,pinpoints", [((500, 700), "(1x1),...,(3x3)"),
                                          ((1080, 1920), "(1x1),...,(6x6)")])
def test_anyres_tiles_match_jax(hw, pinpoints):
    img = _frames(hw, seed=3, n=1)[0]
    want, want_size = jpre.preprocess_anyres_image(img, pinpoints, dtype=jnp.float32)
    got, got_size = tpre.preprocess_anyres_image(img, pinpoints, dtype=torch.float32)
    assert got_size == want_size == (hw[1], hw[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("name", ["down", "up"])
def test_frames_within_the_host_processors_quantization(name):
    frames = _frames(SIZES[name], seed=4)
    host = JProcessor().preprocess(frames)
    diff = np.abs(tpre.preprocess_frames(frames, dtype=torch.float32).numpy() - host)
    assert diff.mean() < 0.01 and np.quantile(diff, 0.99) < 0.05


def test_anyres_within_the_host_processors_quantization():
    img = _frames((500, 700), seed=5, n=1)[0]
    host, host_size = jprocess_anyres(Image.fromarray(img), JProcessor(), "(1x1),...,(3x3)")
    got, got_size = tpre.preprocess_anyres_image(img, "(1x1),...,(3x3)", dtype=torch.float32)
    assert got_size == host_size and got.shape == host.shape
    diff = np.abs(got.numpy() - host)
    assert diff.mean() < 0.015 and np.quantile(diff, 0.99) < 0.08


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="frames"):
        tpre.preprocess_frames(np.zeros((2, 8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="image"):
        tpre.preprocess_anyres_image(np.zeros((2, 8, 8, 3), np.uint8), "(1x1),...,(2x2)")
