"""Host-side video frame loading (a copy of
`memory_augmented_vlm_tpu/data/video.py` over the port's native loader;
Pillow, decord and PyAV are imported only by the loaders that use them).

The reference decodes with decord/PyAV (llava/utils.py:26-113); this
environment ships neither, so the loader supports the sources the training
recipe actually uses plus optional codec backends when present:

  1. pre-extracted tensor files (`.pt`/`.npy`/`.npz`) — the active recipe's
     `--video_folder ..._tensors` path (train.py:1183-1231,
     extract_video_frames/video_reader_tmp.py);
  2. directories of frame images (train.py's folder-of-frames branch);
  3. Y4M (YUV4MPEG2) files — a real container decode that needs no codec:
     native C++ fast path (runtime/frame_loader.cpp) with a numpy fallback;
  4. decord / PyAV when importable (same preference order as the reference).

Frame-sampling arithmetic reproduces `process_video_with_decord`
(llava/utils.py:26-52): >=32 s videos sample n*32 frames with
n = (t-1)//32, else 1 fps.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def sample_frame_indices(
    total_frames: int,
    avg_fps: float,
    video_fps: int = 1,
) -> Tuple[List[int], List[float], int]:
    """Reference sampling rule (llava/utils.py:32-46).

    Returns (frame_idx, frame_times_s, num_frames_to_sample).
    """
    video_time = total_frames / avg_fps
    if video_time >= 32:
        # the reference formula degenerates to 0 frames for 32 <= t < 33 s
        # (n = (t-1)//32 == 0); clamp to one segment so the clip is usable
        n = max(int((video_time - 1) // 32), 1)
        num = min(n * 32, total_frames)
        idx = np.linspace(0, total_frames - 1, num, dtype=int).tolist()
    else:
        step = max(1, round(avg_fps / video_fps))
        idx = list(range(0, total_frames, step))
        num = len(idx)
    times = [i / avg_fps for i in idx]
    return idx, times, num


def dynamic_sample_frame_indices(
    total_frames: int,
    avg_fps: float,
    video_fps: int = 1,
    frames_upbound: int = 0,
    force_sample: bool = False,
) -> Tuple[List[int], List[float], int]:
    """`dynamic_process_video_with_decord` sampling ladder
    (llava/utils.py:55-89): <10 frames pad to 10 by repeating the last,
    <100 frames keep all, >=100 s sample ~1/video_fps, otherwise oversample
    so at least ~100 frames survive; then the upbound/force_sample uniform
    resample. Returns (frame_idx, frame_times_s, num_frames_to_sample).

    Bug-compatible detail: the ladder's frame times divide by the ROUNDED
    fps ratio (the reference reassigns `avg_fps = round(fps/video_fps)`),
    while the upbound branch divides by the true fps.
    """
    import math

    video_time = total_frames / avg_fps
    # reference: avg_fps = round(vr.get_avg_fps() / data_args.video_fps);
    # clamped to >= 1 so sub-video_fps sources don't raise on a zero step
    step = max(1, round(avg_fps / video_fps))
    if total_frames < 10:
        idx = list(range(total_frames)) + [total_frames - 1] * (10 - total_frames)
    elif total_frames < 100:
        idx = list(range(total_frames))
    elif video_time >= 100:
        idx = list(range(0, total_frames, step))
    else:
        effective_rate = math.ceil(100 / video_time)
        interval = max(1, int(step / effective_rate))
        idx = list(range(0, total_frames, interval))
    times = [i / step for i in idx]

    if frames_upbound > 0 and (len(idx) > frames_upbound or force_sample):
        idx = np.linspace(0, total_frames - 1, frames_upbound, dtype=int).tolist()
        times = [i / avg_fps for i in idx]
    return idx, times, len(idx)


def load_frames_from_dir(path: str) -> np.ndarray:
    """Directory of frame images (sorted) -> (F, H, W, 3) uint8."""
    from PIL import Image

    names = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
    )
    frames = [np.asarray(Image.open(os.path.join(path, f)).convert("RGB")) for f in names]
    return np.stack(frames)


def load_frames_from_tensor(path: str) -> np.ndarray:
    """Pre-extracted frame tensors (.pt torch / .npy / .npz)."""
    if path.endswith(".pt"):
        import torch

        t = torch.load(path, map_location="cpu")
        arr = t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    elif path.endswith(".npz"):
        arr = np.load(path)["frames"]
    else:
        arr = np.load(path)
    # accept (F, C, H, W) torch layout
    if arr.ndim == 4 and arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(0, 2, 3, 1)
    return arr


def _yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 limited-range planar 4:2:0 -> (H, W, 3) uint8 (the decord /
    ffmpeg default for yuv420p)."""
    h, w = y.shape
    u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[:h, :w]
    v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[:h, :w]
    yf = 1.164383 * (y.astype(np.float32) - 16.0)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + 1.596027 * vf
    g = yf - 0.391762 * uf - 0.812968 * vf
    b = yf + 2.017232 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def load_y4m(path: str) -> Tuple[np.ndarray, float]:
    """Decode a YUV4MPEG2 (.y4m) file -> ((F, H, W, 3) uint8, fps).

    Handles C420* colorspaces (420 / 420jpeg / 420mpeg2 / 420paldv differ in
    chroma siting only). Prefers the native C++ decoder (frame_loader.cpp)
    where it builds; this numpy path is taken where there is no compiler
    to build it (a build that fails raises)."""
    from memory_augmented_vlm_torch.data.native_loader import decode_y4m_native

    out = decode_y4m_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        data = f.read()
    nl = data.index(b"\n")
    header = data[:nl].decode()
    if not header.startswith("YUV4MPEG2"):
        raise ValueError(f"{path}: not a YUV4MPEG2 stream")
    w = h = 0
    fps = 30.0
    colorspace = "420"
    for tok in header.split()[1:]:
        if tok[0] == "W":
            w = int(tok[1:])
        elif tok[0] == "H":
            h = int(tok[1:])
        elif tok[0] == "F":
            num, den = tok[1:].split(":")
            fps = float(num) / float(den)
        elif tok[0] == "C":
            colorspace = tok[1:]
    if not colorspace.startswith("420"):
        raise ValueError(f"{path}: unsupported colorspace C{colorspace} "
                         "(only 4:2:0 variants)")
    ysz, csz = w * h, (w // 2) * (h // 2)
    frame_bytes = ysz + 2 * csz
    pos = nl + 1
    frames = []
    while pos < len(data):
        fnl = data.index(b"\n", pos)
        if not data[pos:fnl].startswith(b"FRAME"):
            raise ValueError(f"{path}: bad FRAME marker at byte {pos}")
        pos = fnl + 1
        raw = np.frombuffer(data, np.uint8, count=frame_bytes, offset=pos)
        pos += frame_bytes
        y = raw[:ysz].reshape(h, w)
        u = raw[ysz:ysz + csz].reshape(h // 2, w // 2)
        v = raw[ysz + csz:].reshape(h // 2, w // 2)
        frames.append(_yuv420_to_rgb(y, u, v))
    return np.stack(frames), fps


def write_y4m(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Encode (F, H, W, 3) uint8 RGB -> .y4m (inverse of load_y4m; used by
    the frame-extraction tools and tests)."""
    f_, h, w, _ = frames.shape
    with open(path, "wb") as out:
        out.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420\n".encode())
        for frame in frames:
            rf = frame.astype(np.float32)
            r, g, b = rf[..., 0], rf[..., 1], rf[..., 2]
            y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
            u = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
            v = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b
            out.write(b"FRAME\n")
            out.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
            for plane in (u, v):
                sub = plane.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
                out.write(np.clip(sub, 0, 255).astype(np.uint8).tobytes())


def _load_source(video_path: str, video_fps: int) -> Tuple[np.ndarray, float]:
    if os.path.isdir(video_path):
        frames = load_frames_from_dir(video_path)
        avg_fps = float(video_fps)  # frame dirs are assumed pre-sampled at 1fps
    elif video_path.endswith((".pt", ".npy", ".npz")):
        frames = load_frames_from_tensor(video_path)
        avg_fps = float(video_fps)
    elif video_path.endswith(".y4m"):
        frames, avg_fps = load_y4m(video_path)
    else:
        frames, avg_fps = _decode_with_codec(video_path)
    return frames, avg_fps


def load_video(
    video_path: str,
    video_fps: int = 1,
    frames_upbound: int = 0,
    force_sample: bool = False,
) -> Tuple[np.ndarray, float, str, int]:
    """Load + sample a video from any supported source.

    Returns (frames (F, H, W, 3), video_time_s, frame_times_str, num_sampled)
    — the `process_video_with_decord` contract (llava/utils.py:26-52).
    """
    frames, avg_fps = _load_source(video_path, video_fps)
    total = frames.shape[0]
    idx, times, num = sample_frame_indices(total, avg_fps, video_fps)
    if frames_upbound > 0 and (len(idx) > frames_upbound or force_sample):
        idx = np.linspace(0, total - 1, frames_upbound, dtype=int).tolist()
        times = [i / avg_fps for i in idx]
        num = len(idx)
    sampled = frames[np.asarray(idx)]
    time_str = ",".join(f"{t:.2f}s" for t in times)
    return sampled, total / avg_fps, time_str, num


def load_video_dynamic(
    video_path: str,
    video_fps: int = 1,
    frames_upbound: int = 0,
    force_sample: bool = False,
) -> Tuple[np.ndarray, float, str, int]:
    """`dynamic_process_video_with_decord` counterpart (llava/utils.py:55-89)
    over the same source loaders: density-adaptive sampling (pad tiny clips
    to 10 frames, keep <100-frame clips whole, oversample short-but-dense
    clips to ~100 frames) instead of the n*32 rule."""
    frames, avg_fps = _load_source(video_path, video_fps)
    total = frames.shape[0]
    idx, times, num = dynamic_sample_frame_indices(
        total, avg_fps, video_fps, frames_upbound, force_sample)
    sampled = frames[np.asarray(idx)]
    time_str = ",".join(f"{t:.2f}s" for t in times)
    return sampled, total / avg_fps, time_str, num


def _decode_with_codec(video_path: str) -> Tuple[np.ndarray, float]:
    try:
        from decord import VideoReader, cpu  # type: ignore

        vr = VideoReader(video_path, ctx=cpu(0), num_threads=1)
        fps = vr.get_avg_fps()
        frames = vr.get_batch(range(len(vr))).asnumpy()
        return frames, fps
    except ImportError:
        pass
    try:
        import av  # type: ignore

        container = av.open(video_path)
        container.streams.video[0].thread_type = "AUTO"
        frames = []
        for packet in container.demux():
            if packet.stream.type == "video":
                for frame in packet.decode():
                    frames.append(frame.to_ndarray(format="rgb24"))
        stream = container.streams.video[0]
        fps = float(stream.average_rate) if stream.average_rate else 30.0
        return np.stack(frames), fps
    except ImportError as e:
        raise RuntimeError(
            f"no codec backend for {video_path}: install decord or pyav, or "
            "pre-extract frames to .npy/.pt (extract tooling in tools/)"
        ) from e
