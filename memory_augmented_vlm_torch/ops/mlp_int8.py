"""The int8 transformer MLP, as a half-block and bare: the CUDA kernels of
`csrc/mlp_int8.cu` and their plain PyTorch versions.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py::
fused_mlp_block_int8`:

    hidden + fc2(requant(gelu_tanh(fc1(quant(LayerNorm(hidden))))))

and of `fused_mlp_int8`, the same without the LayerNorm and the residual:

    fc2(requant(gelu_tanh(fc1(quant(x)))))  cast to x's dtype

with fc1 = `acc * sx * s1 + b1` in fp32, the requant scale taken over the
whole intermediate row (I wide) and applied to the fp32 GELU output,
fc2 = `acc * sh * s2 + b2`, and (in the block) the residual added in fp32
before the cast to hidden's dtype. Both quantizations are `x * (1/s)` with
a 1e-12 floor. The LM's SwiGLU block is in `ops/swiglu_int8.py`.

Each wrapper takes its plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.qkv_int8 import layer_norm_f32
from memory_augmented_vlm_torch.ops.quant import int_mm, quantize_rows

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(x, approximate=True)` in its own evaluation order."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def fused_mlp_block_int8_reference(hidden, ln_w, ln_b, w1, s1, b1, w2, s2, b2,
                                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version. hidden (M, K); ln_w, ln_b (K,); w1 (K, I) int8 with
    s1, b1 (I,); w2 (I, K) int8 with s2, b2 (K,). Returns (M, K) in
    hidden's dtype."""
    hf = hidden.float()
    xq, sx = quantize_rows(layer_norm_f32(hf, ln_w, ln_b, eps))
    h = gelu_tanh(int_mm(xq, w1).float() * sx * s1.float() + b1.float())
    hq, sh = quantize_rows(h)
    mlp = int_mm(hq, w2).float() * sh * s2.float() + b2.float()
    return (hf + mlp).to(hidden.dtype)


def mlp_shapes(x, w1, w2, name: str):
    """(M, K, I) of an (M, K) activation with (K, I) and (I, K) kernels."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if w1.dim() != 2 or w1.shape[0] != k:
        raise ValueError(f"the first kernel must be ({k}, I), got {tuple(w1.shape)}")
    i = w1.shape[1]
    if tuple(w2.shape) != (i, k):
        raise ValueError(f"the last kernel must be ({i}, {k}), got {tuple(w2.shape)}")
    return m, k, i


def mlp_scratch(m: int, k: int, i: int, dev):
    """The scratch of the staged MLP kernels: the input's codes (M, K), the
    fp32 intermediate (M, I) and its codes, and three (M,) fp32 rows (the
    input's scales, the intermediate's row max and its scales)."""
    return (torch.empty((m, k), dtype=torch.int8, device=dev),
            torch.empty((m, i), dtype=torch.float32, device=dev),
            torch.empty((m, i), dtype=torch.int8, device=dev),
            torch.empty((3, m), dtype=torch.float32, device=dev))


def fused_mlp_block_int8(hidden, ln_w, ln_b, w1, s1, b1, w2, s2, b2,
                         eps: float = 1e-6) -> torch.Tensor:
    """See `fused_mlp_block_int8_reference` for the arguments. CUDA tensors
    launch `csrc/mlp_int8.cu` (hidden bf16 or fp32, contiguous; weights
    int8 column-major; K and I multiples of 16) and count one launch in
    `fused_mlp_block_int8.launches`."""
    m, k, i = mlp_shapes(hidden, w1, w2, "hidden")
    if hidden.device.type == "cpu":
        return fused_mlp_block_int8_reference(hidden, ln_w, ln_b, w1, s1, b1, w2, s2, b2,
                                              eps)
    int8_common.check_cuda(hidden, "hidden")
    dev = hidden.device
    int8_common.check_weight(w1, k, i, dev)
    int8_common.check_weight(w2, i, k, dev)
    vecs = [int8_common.f32_vector(t, n, dev, name) for t, n, name in (
        (ln_w, k, "ln_w"), (ln_b, k, "ln_b"), (s1, i, "s1"), (b1, i, "b1"),
        (s2, k, "s2"), (b2, k, "b2"))]
    out = torch.empty_like(hidden)
    if m == 0:
        return out
    xq, h, hq, rows = mlp_scratch(m, k, i, dev)
    lib = cuda_lib.load()
    rc = lib.mlp_int8(
        int8_common.DTYPES[hidden.dtype], hidden.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), w1.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        w2.data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(), out.data_ptr(),
        xq.data_ptr(), h.data_ptr(), hq.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), rows[2].data_ptr(), m, k, i, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "mlp_int8")
    fused_mlp_block_int8.launches += 1
    return out


fused_mlp_block_int8.launches = 0


def fused_mlp_int8_reference(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Plain version. x (M, K); w1 (K, I) int8 with s1, b1 (I,); w2 (I, K)
    int8 with s2, b2 (K,). Returns (M, K) in x's dtype."""
    xq, sx = quantize_rows(x)
    h = gelu_tanh(int_mm(xq, w1).float() * sx * s1.float() + b1.float())
    hq, sh = quantize_rows(h)
    return (int_mm(hq, w2).float() * sh * s2.float() + b2.float()).to(x.dtype)


def fused_mlp_int8(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """See `fused_mlp_int8_reference` for the arguments. CUDA tensors launch
    `csrc/mlp_int8.cu`'s bare-MLP entry (x bf16 or fp32, contiguous; weights
    int8 column-major; K and I multiples of 16) and count one launch in
    `fused_mlp_int8.launches`."""
    m, k, i = mlp_shapes(x, w1, w2, "x")
    if x.device.type == "cpu":
        return fused_mlp_int8_reference(x, w1, s1, b1, w2, s2, b2)
    int8_common.check_cuda(x, "x")
    dev = x.device
    int8_common.check_weight(w1, k, i, dev)
    int8_common.check_weight(w2, i, k, dev)
    vecs = [int8_common.f32_vector(t, n, dev, name) for t, n, name in (
        (s1, i, "s1"), (b1, i, "b1"), (s2, k, "s2"), (b2, k, "b2"))]
    out = torch.empty_like(x)
    if m == 0:
        return out
    xq, h, hq, rows = mlp_scratch(m, k, i, dev)
    lib = cuda_lib.load()
    rc = lib.mlp_int8_core(
        int8_common.DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), w2.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        out.data_ptr(), xq.data_ptr(), h.data_ptr(), hq.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), rows[2].data_ptr(), m, k, i,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "mlp_int8_core")
    fused_mlp_int8.launches += 1
    return out


fused_mlp_int8.launches = 0
