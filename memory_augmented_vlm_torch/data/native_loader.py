"""ctypes bindings for the native threaded frame loader (counterpart of
`memory_augmented_vlm_tpu/data/native_loader.py`, over the same
`runtime/frame_loader.cpp`).

A C++ worker pool fills a bounded queue with pre-extracted `.npy` frame
tensors so host IO overlaps device compute, and `fl_decode_y4m` decodes a
Y4M file natively. The library is built at first use from the source in
the checkout into `build/frame_loader/` (named after a hash of the source
and the flags), with `runtime/Makefile`'s compiler and flags; the
`runtime/libframe_loader.so` that may lie beside the source was built
elsewhere and is not used. Without a C++ compiler the loader reports
itself unavailable and its callers take their numpy paths, as JAX's do;
a build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "runtime" / "frame_loader.cpp"
MAKEFILE = ROOT / "runtime" / "Makefile"
BUILD_DIR = ROOT / "build" / "frame_loader"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def make_variable(name: str) -> str:
    """`runtime/Makefile`'s default for `name` (its `NAME ?= value`), which
    the environment overrides as make's `?=` lets it."""
    if name in os.environ:
        return os.environ[name]
    m = re.search(rf"^{name}\s*\?=\s*(.*)$", MAKEFILE.read_text(), re.M)
    if m is None:
        raise ValueError(f"{MAKEFILE} sets no {name}")
    return m.group(1).strip()


def compiler() -> Optional[str]:
    """The Makefile's C++ compiler, where this machine has it."""
    return shutil.which(make_variable("CXX"))


def build() -> Path:
    """Build the library (once per source and flags) and return its path.
    Raises if there is no compiler or the build fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({make_variable('CXX')}) to build {SOURCE}")
    flags = shlex.split(make_variable("CXXFLAGS"))
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join([cxx, *flags]).encode())
    out = BUILD_DIR / f"libframe_loader_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-shared", "-o", str(tmp), str(SOURCE)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"building the frame loader failed ({shlex.join(cmd)}):\n"
                           f"{done.stderr}")
    os.replace(tmp, out)  # a concurrent build of the same source writes the same file
    return out


def _load_library() -> Optional[ctypes.CDLL]:
    """The built library; None where there is no compiler."""
    global _lib
    with _lib_lock:
        if _lib is not None or compiler() is None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        lib.fl_decode_y4m.restype = ctypes.c_int
        lib.fl_decode_y4m.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fl_free_u8.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_library() is not None


class NativeFrameLoader:
    """Iterate (index, frames) over .npy files with background prefetch.

    Results may arrive out of order (worker races); `index` identifies the
    source path. Copies each buffer into an owned numpy array. Loads
    synchronously with numpy where the library is unavailable.
    """

    def __init__(self, paths: List[str], num_threads: int = 4, queue_cap: int = 8):
        self.paths = list(paths)
        self._lib = _load_library()
        self._handle = None
        if self._lib is not None:
            self._names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in self.paths])
            self._handle = self._lib.fl_create(self._names, len(paths), num_threads,
                                               queue_cap)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        if self._handle is None:  # no library: synchronous
            for i, p in enumerate(self.paths):
                yield i, np.load(p).astype(np.float32)
            return
        data_p = ctypes.POINTER(ctypes.c_float)()
        shape = (ctypes.c_int64 * 8)()
        ndim = ctypes.c_int()
        index = ctypes.c_int64()
        while True:
            status = self._lib.fl_next(
                self._handle, ctypes.byref(data_p), shape,
                ctypes.byref(ndim), ctypes.byref(index))
            if status == 1:
                break
            if status < 0:
                continue  # skip unreadable file (reference retry-ladder spirit)
            shp = tuple(shape[i] for i in range(ndim.value))
            count = int(np.prod(shp)) if shp else 0
            buf = np.ctypeslib.as_array(data_p, shape=(count,)).reshape(shp)
            yield int(index.value), buf.copy()

    def close(self):
        if self._handle is not None and self._lib is not None:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def decode_y4m_native(path: str):
    """Decode a .y4m with the native decoder (`fl_decode_y4m`). Returns
    ((F, H, W, 3) uint8, fps), or None where the library is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    data_p = ctypes.POINTER(ctypes.c_ubyte)()
    shape = (ctypes.c_int64 * 4)()
    fps = ctypes.c_double()
    rc = lib.fl_decode_y4m(path.encode(), ctypes.byref(data_p), shape, ctypes.byref(fps))
    if rc != 0:
        raise ValueError(f"fl_decode_y4m({path}) failed with {rc}")
    shp = tuple(int(shape[i]) for i in range(4))
    count = int(np.prod(shp))
    frames = np.ctypeslib.as_array(data_p, shape=(count,)).reshape(shp).copy()
    lib.fl_free_u8(data_p)
    return frames, float(fps.value)
