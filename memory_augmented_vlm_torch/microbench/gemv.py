"""The decode GEMV: the CUDA kernel `csrc/gemv.cu`, its plain PyTorch
version, and the micro-benchmark of a chain of them.

Counterpart of the JAX package's `tools_gemv_bench.py`, whose Pallas kernel
(`_gemv_kernel`, called by `pallas_gemv`) computes y (1, N) = x (1, K) .
W (K, N) with both read as fp32, fp32 accumulation and y in x's dtype
(bf16). W is (K, N) row-major, the port's layout for a float kernel.

    python -m memory_augmented_vlm_torch.microbench.gemv

chains the tool's 12 layers of 896 -> 4864 -> 896 (bf16) and times one
chain through the kernel and through `torch.matmul`, each captured in a
CUDA graph and replayed (CUDA events, median of 5), so that the device's
time is measured and not the host's time to enqueue 24 small launches. The
chain reads 209.2 MB of weights, four times the H100's 50 MB L2, so each
replay streams them from device memory; a single product repeated would
read its 8.7 MB from L2 and show more than the memory's rate. It prints
GB/s and the share of 3.35 TB/s. It runs on the card only.
"""

from __future__ import annotations

import json

import torch

from memory_augmented_vlm_torch.microbench.timing import graph_ms, require_card
from memory_augmented_vlm_torch.ops import cuda_lib

H, I, L = 896, 4864, 12  # tools_gemv_bench.py's shapes
PEAK_BYTES = 3.35e12  # H100 SXM, NVIDIA data sheet
BLOCKS_PER_SM = 4


def _shapes(x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv takes (1, K) . (K, N), got {tuple(x.shape)} . {tuple(w.shape)}")
    return w.shape


def gemv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 product of the fp32 operands, cast to x's dtype."""
    _shapes(x, w)
    return (x.float() @ w.float()).to(x.dtype)


def split_plan(k: int, n: int, vec: int, sms: int):
    """(splits, rows per split) of K: about BLOCKS_PER_SM blocks per SM over
    the column strips of 32 * vec columns, at least 8 rows (one per warp)
    per split."""
    strips = -(-n // (32 * vec))
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // strips), -(-k // 8), 65535))
    rows = -(-k // splits)
    rows = -(-rows // 8) * 8
    return -(-k // rows), rows


def gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (1, K) bf16; w (K, N) bf16 row-major. Returns (1, N) bf16. CPU
    tensors take the plain version; CUDA tensors launch the kernel (any K
    and N; contiguous operands) and count one launch in `gemv.launches`."""
    k, n = _shapes(x, w)
    if x.device.type == "cpu":
        return gemv_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gemv runs on cpu or cuda, not {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemv kernel takes bf16, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemv kernel takes contiguous operands")
    if k == 0:
        return torch.zeros((1, n), dtype=x.dtype, device=x.device)
    out = torch.empty((1, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    vec = 8 if n % 8 == 0 and w.data_ptr() % 16 == 0 else 1
    splits, rows = split_plan(k, n, vec, torch.cuda.get_device_properties(x.device)
                              .multi_processor_count)
    part = torch.empty((splits, n), dtype=torch.float32, device=x.device)  # scratch
    lib = cuda_lib.load()
    rc = lib.gemv_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(), k, n,
                       splits, rows, vec, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(lib, rc, "gemv_bf16")
    gemv.launches += 1
    return out


gemv.launches = 0


def operands(seed: int = 0, device="cuda"):
    """The tool's operands on `device`: x (1, H) ~ N(0, 0.1^2), W1 (L, H, I)
    and W2 (L, I, H) ~ N(0, 0.02^2), all bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    return randn(1, H, std=0.1), randn(L, H, I, std=0.02), randn(L, I, H, std=0.02)


def chain(fn, x, w1, w2):
    """The tool's chain: y = fn(x, W1[l]); x = fn(y, W2[l]) over the layers."""
    for l in range(w1.shape[0]):
        x = fn(fn(x, w1[l]), w2[l])
    return x


def chain_bytes(x, w1, w2) -> int:
    """Bytes one chain must move: every weight and every vector read once,
    every output written once."""
    layers, h, i = w1.shape
    return layers * (2 * h * i + 2 * (h + i)) * x.element_size()


def measure(x, w1, w2) -> dict:
    """ms per chain, GB/s and share of the memory rate, for the kernel and
    for torch.matmul, each replayed from a CUDA graph."""
    nbytes = chain_bytes(x, w1, w2)
    rows = {}
    for name, fn in (("kernel", gemv), ("torch.matmul", torch.matmul)):
        ms = graph_ms(lambda fn=fn: chain(fn, x, w1, w2))
        rows[name] = {"ms_per_chain": ms, "gb_per_s": nbytes / ms / 1e6,
                      "share_of_memory_rate": nbytes / ms / 1e-3 / PEAK_BYTES}
    return {"layers": w1.shape[0], "shape": list(w1.shape[1:]), "mb_per_chain": nbytes / 1e6,
            "timing": "one chain replayed from a CUDA graph, weights 4x the L2", **rows}


def main():
    card = require_card()
    print(card)
    print(json.dumps({"gemv": measure(*operands())}))


if __name__ == "__main__":
    main()
