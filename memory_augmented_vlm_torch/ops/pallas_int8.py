"""The standalone w8a8 layer: the CUDA kernel `csrc/int8_matmul.cu` and its
plain PyTorch version.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_int8.py` (the name is
kept so that a reader finds it; nothing here is Pallas):

  - `quantize_weight` : static per-output-channel int8 of a (K, N) kernel,
                        `w / s` with the 1e-12 floor on the scale itself
                        (`quant.prequantize_kernel` floors the row max).
  - `int8_matmul`     : rows of x quantized (`quant.quantize_rows`,
                        `x * (1/s)`), int8 x int8 -> int32 product,
                        `acc * sx * sw [+ bias]` in fp32, cast to x's dtype.
  - `int8_linear`     : `...i,io->...o` against a `{w_int8, scale, bias}`
                        dict; the bias is added after the cast, outside the
                        kernel, as in JAX.

Unlike `quant.int8_linear`, whose product JAX leaves to XLA and the port to
`torch._int_mm`, `int8_matmul` computes its product in the kernel's body on
both sides. The int8 weights keep the JAX shape (K, N) stored column-major
(`quant.column_major`); `quantize_weight` returns that layout.

`int8_matmul` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.quant import QUANT_FLOOR, column_major, int_mm, quantize_rows


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (K, N) tensor or array:
    (w_int8 (K, N) int8 column-major, scale (N,) fp32), w ~= w_int8 * scale."""
    wf = torch.as_tensor(w).float()
    scale = (wf.abs().amax(dim=0) / 127.0).clamp_min(QUANT_FLOOR)
    wq = torch.round(wf / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return column_major(wq), scale


def int8_matmul_reference(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version. x (M, K); w_int8 (K, N) int8; w_scale (N,); bias (N,)
    or None. Returns (M, N) in x's dtype."""
    xq, sx = quantize_rows(x)
    out = int_mm(xq, w_int8).float() * sx * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """See `int8_matmul_reference` for the arguments. CUDA tensors launch
    `csrc/int8_matmul.cu` (x bf16 or fp32, contiguous, any M and N >= 1;
    weights int8 column-major; K a multiple of 16) and count one launch in
    `int8_matmul.launches`."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if w_int8.dim() != 2 or w_int8.shape[0] != k:
        raise ValueError(f"w_int8 must be ({k}, N), got {tuple(w_int8.shape)}")
    n = w_int8.shape[1]
    if tuple(w_scale.shape) != (n,) or (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"w_scale and bias must be ({n},)")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_int8, w_scale, bias)
    int8_common.check_cuda(x, "x")
    dev = x.device
    int8_common.check_weight(w_int8, k, n, dev)
    sw = int8_common.f32_vector(w_scale, n, dev, "w_scale")
    b = None if bias is None else int8_common.f32_vector(bias, n, dev, "bias")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)  # scratch: codes and row scales
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    rc = lib.int8_matmul(
        int8_common.DTYPES[x.dtype], x.data_ptr(), w_int8.data_ptr(), sw.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        m, n, k, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_linear(x: torch.Tensor, qp: dict) -> torch.Tensor:
    """`...i,io->...o` against pre-quantized weights {w_int8, scale, bias}:
    `int8_matmul` without a bias, then + bias after the cast."""
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]), qp["w_int8"], qp["scale"])
    return out.reshape(*lead, qp["w_int8"].shape[-1]) + qp["bias"]
