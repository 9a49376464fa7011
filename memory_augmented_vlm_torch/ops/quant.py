"""Int8 quantization (counterpart of `memory_augmented_vlm_tpu/ops/quant.py`
and `ops/pallas_int8.py::quantize_rows`, the prequantized path only).

  - `quantize_rows`      : per-row symmetric int8 of an activation,
                           `x * (1/s)` with a 1e-12 floor (the formula of
                           `pallas_int8.quantize_rows` and of the fused
                           kernels).
  - `prequantize_kernel` : static per-output-channel int8 of a (K, N)
                           kernel, `w / s` with a 1e-12 floor.
  - `int8_linear`        : dynamic row quant, an int8 x int8 -> int32
                           product, `acc * sx * s` cast to x's dtype, then
                           + bias (`quant.int8_linear`'s order).
  - `int_mm`             : the int8 product itself, `torch._int_mm`. JAX
                           leaves this plain matrix product to XLA; here
                           it goes to the library the same way.

Weight layout: an int8 kernel keeps the JAX shape (K, N) but is stored
column-major (`w.t().is_contiguous()`), so each output channel's K values
are contiguous. That is the operand layout the int8 tensor-core kernels
read (`csrc/int8_gemm.cuh`) and the canonical one of `torch._int_mm` on
CUDA. `column_major` makes the layout; `prequantize_kernel` returns it.
"""

from __future__ import annotations

from typing import Tuple

import torch

QUANT_FLOOR = 1e-12


def column_major(w: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values with each column's K values contiguous."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> ((..., K) int8, (..., 1) fp32 scale): s = max(|x|, 1e-12)
    / 127 over the row, q = clip(round(x * (1/s)), -127, 127)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(QUANT_FLOOR) / 127.0
    q = torch.round(xf * (1.0 / s)).clamp_(-127, 127).to(torch.int8)
    return q, s


def prequantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static symmetric per-output-channel int8 of a (K, N) kernel:
    (w_int8 (K, N) column-major, scale (N,) fp32), w ~= w_int8 * scale."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2).clamp_min(QUANT_FLOOR) / 127.0
    wq = torch.round(wf / scale.unsqueeze(-2)).clamp_(-127, 127).to(torch.int8)
    return column_major(wq), scale


# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_CUDA_MIN_ROWS = 32


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On CUDA, M <= 16
    rows are zero-padded to 32 (decode runs M = 1) and N to a multiple of 8
    (zero columns), and sliced back; K must be a multiple of 8."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int_mm takes (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("int_mm takes int8 operands")
    m, n = a.shape[0], b.shape[1]
    if a.device.type == "cuda":
        if a.shape[1] % 8:
            raise ValueError(f"int_mm on CUDA needs K a multiple of 8, got K={a.shape[1]}")
        if m <= 16:
            a = torch.nn.functional.pad(a, (0, 0, 0, _CUDA_MIN_ROWS - m))
        if n % 8:  # padded as N rows of K: b stays column-major
            b = torch.nn.functional.pad(b.t(), (0, 0, 0, -n % 8)).t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def int8_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Prequantized dense layer. p: {"kernel_int8": (K, N) int8, "scale":
    (N,) fp32, optional "bias"}. The bias is added after the cast to x's
    dtype, so its dtype promotes the result as it does in JAX."""
    xq, sx = quantize_rows(x)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), p["kernel_int8"])
    acc = acc.reshape(*lead, acc.shape[-1])
    out = (acc.float() * sx * p["scale"]).to(x.dtype)
    if "bias" in p:
        out = out + p["bias"]
    return out
