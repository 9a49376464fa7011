"""The LM's int8 SwiGLU MLP half-block: the CUDA kernel
`csrc/swiglu_int8.cu` and its plain PyTorch version.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py::
fused_swiglu_block_int8`:

    hidden + down(requant(silu(gate(xq)) * up(xq))),  xq = quant(RMSNorm(hidden))

with RMSNorm = `hidden * rsqrt(mean(hidden^2) + eps) * rms_w` in fp32 (the
caller folds a `1 + w` convention into `rms_w`), gate = `acc * sx * sg` and
up = `acc * sx * su` in fp32, the requant scale taken over the whole
intermediate row (I wide), down = `acc * sh * sd`, and the residual added
in fp32 before the cast to hidden's dtype. No projection has a bias. Both
quantizations are `x * (1/s)` with a 1e-12 floor, so a row of zeros (the
prompt's padding) takes the floor scale and comes back unchanged.

`fused_swiglu_block_int8` takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.mlp_int8 import mlp_scratch, mlp_shapes
from memory_augmented_vlm_torch.ops.quant import int_mm, quantize_rows


def silu_f32(g: torch.Tensor) -> torch.Tensor:
    """`g * sigmoid(g)` written as the kernel writes it: g * (1 / (1 + exp(-g)))."""
    return g * (1.0 / (1.0 + torch.exp(-g)))


def fused_swiglu_block_int8_reference(hidden, rms_w, wg, sg, wu, su, wd, sd,
                                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version. hidden (M, K); rms_w (K,); wg, wu (K, I) int8 with sg,
    su (I,); wd (I, K) int8 with sd (K,). Returns (M, K) in hidden's dtype."""
    hf = hidden.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    xq, sx = quantize_rows(hf * torch.rsqrt(var + eps) * rms_w.float())
    g = int_mm(xq, wg).float() * sx * sg.float()
    u = int_mm(xq, wu).float() * sx * su.float()
    hq, sh = quantize_rows(silu_f32(g) * u)
    mlp = int_mm(hq, wd).float() * sh * sd.float()
    return (hf + mlp).to(hidden.dtype)


def fused_swiglu_block_int8(hidden, rms_w, wg, sg, wu, su, wd, sd,
                            eps: float = 1e-6) -> torch.Tensor:
    """See `fused_swiglu_block_int8_reference` for the arguments. CUDA
    tensors launch `csrc/swiglu_int8.cu` (hidden bf16 or fp32, contiguous;
    weights int8 column-major; K and I multiples of 16) and count one launch
    in `fused_swiglu_block_int8.launches`."""
    m, k, i = mlp_shapes(hidden, wg, wd, "hidden")
    if tuple(wu.shape) != (k, i):
        raise ValueError(f"wu must be ({k}, {i}), got {tuple(wu.shape)}")
    if hidden.device.type == "cpu":
        return fused_swiglu_block_int8_reference(hidden, rms_w, wg, sg, wu, su, wd, sd, eps)
    int8_common.check_cuda(hidden, "hidden")
    dev = hidden.device
    int8_common.check_weight(wg, k, i, dev)
    int8_common.check_weight(wu, k, i, dev)
    int8_common.check_weight(wd, i, k, dev)
    vecs = [int8_common.f32_vector(t, n, dev, name) for t, n, name in (
        (rms_w, k, "rms_w"), (sg, i, "sg"), (su, i, "su"), (sd, k, "sd"))]
    out = torch.empty_like(hidden)
    if m == 0:
        return out
    xq, h, hq, rows = mlp_scratch(m, k, i, dev)
    lib = cuda_lib.load()
    rc = lib.swiglu_int8(
        int8_common.DTYPES[hidden.dtype], hidden.data_ptr(), vecs[0].data_ptr(),
        wg.data_ptr(), vecs[1].data_ptr(), wu.data_ptr(), vecs[2].data_ptr(),
        wd.data_ptr(), vecs[3].data_ptr(), out.data_ptr(), xq.data_ptr(), h.data_ptr(),
        hq.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        m, k, i, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "swiglu_int8")
    fused_swiglu_block_int8.launches += 1
    return out


fused_swiglu_block_int8.launches = 0
