"""Build and load the port's CUDA kernels.

The sources under `memory_augmented_vlm_torch/csrc/` are compiled by `nvcc`
for Hopper (`sm_90a`), one `nvcc` process per source, all started together,
and linked into one shared library with a plain C interface, which is
loaded with `ctypes`. The build happens at first use, into
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
from typing import List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the toolkit's default install prefix

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def nvcc_commands(nvcc: str, out: Path) -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command) for a library at
    `out`; the objects go beside it."""
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out), *map(str, objs)]
    return compiles, link


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
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    compiles, link = nvcc_commands(nvcc, tmp)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in compiles]
    results = [(cmd, *proc.communicate(), proc.returncode)
               for cmd, proc in zip(compiles, procs)]
    failed = [r for r in results if r[3] != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(cmd)} ({rc}):\n{so}\n{se}" for cmd, so, se, rc in failed))
    proc = subprocess.run(link, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG.update(path=str(out), seconds=time.perf_counter() - t0,
                     ptxas="".join(se for _, _, se, _ in results))
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
    lib.flash_merge.argtypes = [c_int, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int,
                                ctypes.c_float, ptr]
    # qkv_int8(dtype, hidden, ln_w, ln_b, 3 x (w, s, b), q, k, v, xq, sx,
    #          B, S, H, NH, eps, stream)
    lib.qkv_int8.argtypes = [c_int] + [ptr] * 17 + [c_int] * 4 + [ctypes.c_float, ptr]
    # mlp_int8(dtype, hidden, ln_w, ln_b, w1, s1, b1, w2, s2, b2, out,
    #          xq, h, hq, sx, hmax, sh, M, K, I, eps, stream)
    lib.mlp_int8.argtypes = [c_int] + [ptr] * 16 + [c_int] * 3 + [ctypes.c_float, ptr]
    # mlp_int8_core(dtype, x, w1, s1, b1, w2, s2, b2, out, xq, h, hq, sx, hmax, sh,
    #               M, K, I, stream)
    lib.mlp_int8_core.argtypes = [c_int] + [ptr] * 14 + [c_int] * 3 + [ptr]
    # swiglu_int8(dtype, hidden, rms_w, wg, sg, wu, su, wd, sd, out, xq, h, hq, sx, hmax,
    #             sh, M, K, I, eps, stream)
    lib.swiglu_int8.argtypes = [c_int] + [ptr] * 15 + [c_int] * 3 + [ctypes.c_float, ptr]
    # int8_matmul(dtype, x, w, sw, bias, out, xq, sx, M, N, K, stream)
    lib.int8_matmul.argtypes = [c_int] + [ptr] * 7 + [c_int] * 3 + [ptr]
    # flash_merge_oproj(head_dim, q, k, v, valid_len, dtype, hidden, wo, so, bo, out,
    #                   attn, xq, sx, B, NH, S, scale_log2, stream)
    lib.flash_merge_oproj.argtypes = ([c_int] + [ptr] * 4 + [c_int] + [ptr] * 8 + [c_int] * 3
                                      + [ctypes.c_float, ptr])
    # flash_merge_int8(head_dim, q, k, v, o, valid_len, scales, B, NH, S, tile,
    #                  scale_log2, stream)
    lib.flash_merge_int8.argtypes = [c_int] + [ptr] * 6 + [c_int] * 4 + [ctypes.c_float, ptr]
    # attn_block_int8(dtype, hidden, ln_w, ln_b, 4 x (w, s, b), out, xq, sx, q, k, v, oq,
    #                 sa, B, S, H, NH, valid, eps, scale, stream)
    lib.attn_block_int8.argtypes = ([c_int] + [ptr] * 23 + [c_int] * 5 + [ctypes.c_float] * 2
                                    + [ptr])
    # int8_gemm_bf16(x, w, out, M, N, K, stream)
    lib.int8_gemm_bf16.argtypes = [ptr] * 3 + [c_int] * 3 + [ptr]
    # gemv_bf16(x, w, y, part, K, N, splits, rows_per_split, vec, stream)
    lib.gemv_bf16.argtypes = [ptr] * 4 + [c_int] * 5 + [ptr]
    strides = ctypes.POINTER(c_ll)
    # flash_fwd_lse(dtype, head_dim, q, k, v, out, lse, valid_len, B, Sq, Skv,
    #               H, kv_groups, causal, 4 x strides, scale, scale_log2, stream)
    lib.flash_fwd_lse.argtypes = ([c_int, c_int] + [ptr] * 6 + [c_int] * 6 + [strides] * 4
                                  + [ctypes.c_float] * 2 + [ptr])
    # flash_bwd_dq(dtype, head_dim, q, k, v, dout, lse, delta, dq, valid_len,
    #              B, Sq, Skv, H, kv_groups, causal, 5 x strides, scale, scale_log2, stream)
    lib.flash_bwd_dq.argtypes = ([c_int, c_int] + [ptr] * 8 + [c_int] * 6 + [strides] * 5
                                 + [ctypes.c_float] * 2 + [ptr])
    # flash_bwd_dkv(..., dk, dv, valid_len, ...): as flash_bwd_dq with two outputs
    lib.flash_bwd_dkv.argtypes = ([c_int, c_int] + [ptr] * 9 + [c_int] * 6 + [strides] * 5
                                  + [ctypes.c_float] * 2 + [ptr])
    for fn in (lib.flash_fwd, lib.flash_merge, lib.flash_merge_oproj, lib.qkv_int8,
               lib.mlp_int8, lib.mlp_int8_core, lib.swiglu_int8, lib.int8_matmul,
               lib.flash_fwd_lse, lib.flash_bwd_dq, lib.flash_bwd_dkv, lib.flash_merge_int8,
               lib.attn_block_int8, lib.int8_gemm_bf16, lib.gemv_bf16):
        fn.restype = c_int
    lib.kernel_error_string.argtypes = [c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise unless a launch function returned 0."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.kernel_error_string(rc).decode()}")
