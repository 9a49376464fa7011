"""Build and load the port's CUDA kernels.

The sources under `memory_augmented_vlm_torch/csrc/` are compiled by `nvcc`
for Hopper (`sm_90a`) into one shared library with a plain C interface, which
is loaded with `ctypes`. The build happens at first use, into
`build/kernels/` at the root of the checkout, and is named after a hash of
the sources and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. There is no fallback: without `nvcc` the build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the toolkit's default install prefix

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = {"seconds": None, "path": None, "ptxas": ""}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME, else the toolkit's default
    install prefix. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME, {DEFAULT_CUDA_HOME}): the CUDA kernels "
        "of memory_augmented_vlm_torch are built from source at first use "
        "and need the CUDA toolkit")


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):  # sources and any headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists;
    returns its path."""
    out = BUILD_DIR / f"libmavlm_kernels_{_digest()}.so"
    if out.is_file():
        BUILD_LOG.update(path=str(out), seconds=0.0)
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG.update(path=str(out), seconds=time.perf_counter() - t0,
                     ptxas=proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    c_int, c_ll, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.flash_fwd.argtypes = (
        [c_int, c_int, ptr, ptr, ptr, ptr, ptr]
        + [c_int] * 6
        + [c_ll] * 12
        + [ctypes.c_float, ptr])
    lib.flash_fwd.restype = c_int
    lib.flash_error_string.argtypes = [c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
