"""The port's host data modules against the JAX package's, on the CPU.

- `data/conversation.py`: every template of `conv_templates` renders the
  same prompt, byte for byte, for one- and two-turn conversations with an
  image turn;
- `data/tokenizer.py`: `tokenizer_image_token` and
  `KeywordsStoppingCriteria` on the tiny checkpoint's BPE tokenizer, equal;
- `data/preprocessing.py`: `SigLipImageProcessor` bit for bit, and the
  anyres helpers equal;
- `data/video.py`: `sample_frame_indices` and the dynamic sampler over a
  grid of clip lengths and rates, a y4m round trip, `load_video` and
  `load_video_dynamic` on y4m, npy and frame-directory sources, equal;
- `data/native_loader.py`: built from `runtime/frame_loader.cpp` into
  `build/` with `runtime/Makefile`'s flags, its y4m decoder within 1 code
  of the numpy decoder (it rounds where numpy truncates, as JAX's
  tests/test_y4m.py allows) and its `.npy` loader equal to numpy.
"""

import os

import numpy as np
import pytest
from PIL import Image

from memory_augmented_vlm_tpu.data import conversation as jconv
from memory_augmented_vlm_tpu.data import preprocessing as jpre
from memory_augmented_vlm_tpu.data import tokenizer as jtokenizer
from memory_augmented_vlm_tpu.data import video as jvideo
from memory_augmented_vlm_torch.data import conversation as tconv
from memory_augmented_vlm_torch.data import native_loader
from memory_augmented_vlm_torch.data import preprocessing as tpre
from memory_augmented_vlm_torch.data import tokenizer as ttokenizer
from memory_augmented_vlm_torch.data import video as tvideo
from test_builder_roundtrip import ckpt_dir  # noqa: F401  (the tiny checkpoint)


# --------------------------------------------------------- conversation

def test_template_registry_is_the_same():
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    assert len(tconv.conv_templates) >= 21


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_every_template_renders_as_jax(name):
    for turns in (1, 2):
        prompts = []
        for mod in (tconv, jconv):
            conv = mod.conv_templates[name].copy()
            conv.append_message(conv.roles[0], "<image>\nWhat is in the video?")
            if turns == 2:
                conv.append_message(conv.roles[1], "A cat.")
                conv.append_message(conv.roles[0], "And then?")
            conv.append_message(conv.roles[1], None)
            prompts.append(conv.get_prompt())
        assert prompts[0] == prompts[1], (name, turns)
    assert tconv.conv_templates[name].sep_style.name == jconv.conv_templates[name].sep_style.name


# ------------------------------------------------------------ tokenizer

@pytest.fixture(scope="module")
def bpe(ckpt_dir):  # noqa: F811
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(ckpt_dir)


@pytest.mark.parametrize("prompt", ["<image>\ndescribe the video", "hello world",
                                    "a cat <image> sits <image> here", "<image>", ""])
def test_tokenizer_image_token_matches_jax(bpe, prompt):
    got = ttokenizer.tokenizer_image_token(prompt, bpe)
    want = jtokenizer.tokenizer_image_token(prompt, bpe)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got == -200).sum() == prompt.count("<image>")


def test_keywords_stopping_matches_jax(bpe):
    keywords = ["<|im_end|>", "what is"]
    t = ttokenizer.KeywordsStoppingCriteria(keywords, bpe)
    j = jtokenizer.KeywordsStoppingCriteria(keywords, bpe)
    assert [k.tolist() for k in t.keyword_ids] == [k.tolist() for k in j.keyword_ids]
    stops = 0
    for text in ("a cat sits", "a cat sits what is", "hello<|im_end|>", "describe"):
        ids = np.asarray(bpe(text).input_ids, np.int64)
        assert t.should_stop(ids) == j.should_stop(ids), text
        stops += t.should_stop(ids)
    assert stops == 2


def test_load_qwen_tokenizer(ckpt_dir, bpe):  # noqa: F811
    tok = ttokenizer.load_qwen_tokenizer(ckpt_dir)
    assert tok("a cat sits").input_ids == bpe("a cat sits").input_ids


# --------------------------------------------------------- preprocessing

@pytest.mark.parametrize("shape,size", [((480, 640, 3), (384, 384)), ((56, 56, 3), (56, 56)),
                                        ((17, 33, 3), (28, 42))])
def test_siglip_processor_bit_for_bit(shape, size):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, (3, *shape), dtype=np.uint8)
    t, j = tpre.SigLipImageProcessor(size=size), jpre.SigLipImageProcessor(size=size)
    got, want = t.preprocess(frames), j.preprocess(frames)
    assert got.shape == (3, *size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t(Image.fromarray(frames[0])), j(Image.fromarray(frames[0])))
    np.testing.assert_array_equal(t.preprocess(frames[0]), j.preprocess(frames[0]))
    assert t.crop_size == j.crop_size and t.size == j.size


def test_anyres_helpers_match_jax():
    for spec in ("(1x1),...,(3x3)", [[384, 768], [768, 384]], "[(384, 384), (768, 768)]"):
        assert tpre.parse_grid_pinpoints(spec, 384) == jpre.parse_grid_pinpoints(spec, 384)
    pins = jpre.parse_grid_pinpoints("(1x1),...,(3x3)", 384)
    for size in ((640, 480), (300, 900), (1000, 1000)):
        assert tpre.select_best_resolution(size, pins) == jpre.select_best_resolution(size, pins)
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (300, 500, 3), np.uint8))
    got, gsize = tpre.process_anyres_image(img, tpre.SigLipImageProcessor(size=(56, 56)),
                                           "(1x1),...,(2x2)")
    want, wsize = jpre.process_anyres_image(img, jpre.SigLipImageProcessor(size=(56, 56)),
                                            "(1x1),...,(2x2)")
    assert gsize == wsize and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- video

@pytest.mark.parametrize("fps", [1.0, 24.0, 29.97, 30.0, 60.0])
def test_frame_samplers_match_jax(fps):
    for total in (1, 5, 9, 10, 60, 99, 100, 250, 901, 2000, 7200):
        assert tvideo.sample_frame_indices(total, fps) == jvideo.sample_frame_indices(total, fps)
        for upbound, force in ((0, False), (64, False), (64, True), (32, True)):
            got = tvideo.dynamic_sample_frame_indices(total, fps, 1, upbound, force)
            want = jvideo.dynamic_sample_frame_indices(total, fps, 1, upbound, force)
            assert got == want, (total, upbound, force)


def _synthetic(f=8, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 216, (f, h // 8, w // 8, 3), dtype=np.uint8)
    return np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)


def test_y4m_round_trip_matches_jax(tmp_path):
    frames = _synthetic()
    tvideo.write_y4m(str(tmp_path / "t.y4m"), frames, fps=25)
    jvideo.write_y4m(str(tmp_path / "j.y4m"), frames, fps=25)
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    got, fps = tvideo.load_y4m(str(tmp_path / "t.y4m"))
    want, jfps = jvideo.load_y4m(str(tmp_path / "t.y4m"))
    assert fps == jfps == 25.0 and got.shape == frames.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int) - frames.astype(int)).mean() < 3.0


@pytest.mark.parametrize("loader", ["load_video", "load_video_dynamic"])
@pytest.mark.parametrize("source", ["y4m", "npy", "dir"])
def test_load_video_matches_jax(tmp_path, loader, source):
    frames = _synthetic(f=45, seed=1)
    if source == "y4m":
        path = str(tmp_path / "clip.y4m")
        tvideo.write_y4m(path, frames, fps=1)
    elif source == "npy":
        path = str(tmp_path / "clip.npy")
        np.save(path, frames.transpose(0, 3, 1, 2))  # the (F, C, H, W) torch layout
    else:
        path = str(tmp_path / "frames")
        os.makedirs(path)
        for i, fr in enumerate(frames):
            Image.fromarray(fr).save(os.path.join(path, f"{i:04d}.png"))
    for upbound, force in ((0, False), (16, False), (64, True)):
        got = getattr(tvideo, loader)(path, 1, upbound, force)
        want = getattr(jvideo, loader)(path, 1, upbound, force)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_load_video_force_sample_to_64(tmp_path):
    """The lmms-eval path of the card phase: a 64-frame 30 fps clip read
    back whole with frames_upbound=64 and force_sample."""
    frames = _synthetic(f=64, h=48, w=64, seed=2)
    path = str(tmp_path / "clip.y4m")
    tvideo.write_y4m(path, frames, fps=30)
    got, seconds, times, num = tvideo.load_video(path, frames_upbound=64, force_sample=True)
    assert got.shape == (64, 48, 64, 3) and num == 64
    np.testing.assert_array_equal(got, tvideo.load_y4m(path)[0])


# ---------------------------------------------------------- native loader

def test_native_loader_builds_with_the_makefile_flags():
    if native_loader.compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    lib = native_loader.build()
    assert lib.parent == native_loader.BUILD_DIR and lib.exists()
    assert native_loader.make_variable("CXXFLAGS") == "-O3 -std=c++17 -fPIC -Wall -pthread"
    assert native_loader.native_available()
    assert native_loader.build() == lib  # built once


def test_native_loader_reports_unavailable_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert native_loader.compiler() is None and not native_loader.native_available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.build()
    np.save(tmp_path / "a.npy", np.arange(6, dtype=np.uint8).reshape(2, 3))
    with native_loader.NativeFrameLoader([str(tmp_path / "a.npy")]) as loader:
        (i, arr), = list(loader)
    assert i == 0 and arr.dtype == np.float32 and arr.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert native_loader.decode_y4m_native(str(tmp_path / "none.y4m")) is None


def test_native_build_error_raises(monkeypatch, tmp_path):
    if native_loader.compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    bad = tmp_path / "frame_loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="building the frame loader failed"):
        native_loader.native_available()


def test_native_decoders_match_numpy(tmp_path, monkeypatch):
    if native_loader.compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    frames = _synthetic(f=5, seed=3)
    path = str(tmp_path / "clip.y4m")
    tvideo.write_y4m(path, frames, fps=30)
    native, fps = native_loader.decode_y4m_native(path)
    monkeypatch.setattr(native_loader, "decode_y4m_native", lambda p: None)
    numpy_frames, nfps = tvideo.load_y4m(path)
    assert fps == nfps == 30.0
    # the native decoder rounds where numpy truncates (JAX's test_y4m bound)
    assert np.abs(native.astype(int) - numpy_frames.astype(int)).max() <= 1
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 4, 4, 3)).astype(np.float32) for _ in range(5)]
    paths = []
    for i, arr in enumerate(arrays):
        paths.append(str(tmp_path / f"f{i}.npy"))
        np.save(paths[-1], arr)
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not a npy")
    with native_loader.NativeFrameLoader(paths[:2] + [str(bad)] + paths[2:], num_threads=3,
                                         queue_cap=2) as loader:
        got = dict(iter(loader))
    assert sorted(got) == [0, 1, 3, 4, 5]  # the unreadable file is skipped
    for i, arr in zip([0, 1, 3, 4, 5], arrays):
        np.testing.assert_array_equal(got[i], arr)


def test_build_dir_is_ignored_by_git():
    root = native_loader.ROOT
    assert "build/" in (root / ".gitignore").read_text().split()
    assert native_loader.BUILD_DIR.is_relative_to(root / "build")
