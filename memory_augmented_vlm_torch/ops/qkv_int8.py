"""Fused LayerNorm + row quant + int8 q/k/v projections, head-major out: the
CUDA kernel `csrc/qkv_int8.cu` and its plain PyTorch version.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_qkv_int8.py::
fused_qkv_int8`. Per row of the residual stream: fp32 LayerNorm (biased
variance), per-row int8 quant (`x * (1/s)`, floor 1e-12), three int8
products with Wq, Wk, Wv, then `acc * sx * s + b` in fp32, rounded to bf16
(always bf16, whatever the input dtype) and stored head-major,
(B, NH, S, HD). Unlike the TPU kernel, S is not padded to a block multiple.

`fused_qkv_int8` takes the plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.quant import int_mm, quantize_rows


def layer_norm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """fp32 LayerNorm written as the fused kernels write it: two-pass
    biased variance, `(x - mu) * rsqrt(var + eps) * w + b`."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def fused_qkv_int8_reference(hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                             *, nh: int, eps: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version. hidden (B, S, H); ln_w, ln_b (H,); w* (H, H) int8;
    s*, b* (H,). Returns q, k, v, each (B, NH, S, H // NH) bf16."""
    b, s, h = hidden.shape
    x = layer_norm_f32(hidden, ln_w, ln_b, eps)
    xq, sx = quantize_rows(x.reshape(b * s, h))

    def proj(w, scale, bias):
        y = int_mm(xq, w).float() * sx * scale.float() + bias.float()
        return y.to(torch.bfloat16).view(b, s, nh, h // nh).transpose(1, 2).contiguous()

    return proj(wq, sq, bq), proj(wk, sk, bk), proj(wv, sv, bv)


def fused_qkv_int8(hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                   *, nh: int, eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See `fused_qkv_int8_reference` for the arguments. CUDA tensors launch
    `csrc/qkv_int8.cu` (hidden bf16 or fp32, contiguous; weights int8
    column-major; even head dim) and count one launch in
    `fused_qkv_int8.launches`."""
    if hidden.dim() != 3:
        raise ValueError(f"hidden must be (B, S, H), got {tuple(hidden.shape)}")
    b, s, h = hidden.shape
    if nh < 1 or h % nh:
        raise ValueError(f"hidden size {h} does not split into {nh} heads")
    weights = ((wq, sq, bq), (wk, sk, bk), (wv, sv, bv))
    for w, scale, bias in weights:
        if tuple(w.shape) != (h, h) or tuple(scale.shape) != (h,) or tuple(bias.shape) != (h,):
            raise ValueError(f"each projection must be ({h}, {h}) with ({h},) scale and bias")
    if hidden.device.type == "cpu":
        return fused_qkv_int8_reference(hidden, ln_w, ln_b, *[t for wt in weights for t in wt],
                                        nh=nh, eps=eps)
    int8_common.check_cuda(hidden, "hidden")
    hd = h // nh
    if hd % 2:
        raise ValueError(f"qkv kernel head dim must be even, got {hd}")
    m = b * s
    dev = hidden.device
    vecs = [int8_common.f32_vector(t, h, dev, n) for t, n in ((ln_w, "ln_w"), (ln_b, "ln_b"))]
    mats = []
    for w, scale, bias in weights:
        int8_common.check_weight(w, h, h, dev)
        mats.append((w, int8_common.f32_vector(scale, h, dev, "scale"),
                     int8_common.f32_vector(bias, h, dev, "bias")))
    out = [torch.empty((b, nh, s, hd), dtype=torch.bfloat16, device=dev) for _ in range(3)]
    if m == 0:
        return tuple(out)
    xq = torch.empty((m, h), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    rc = lib.qkv_int8(
        int8_common.DTYPES[hidden.dtype], hidden.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), *[t.data_ptr() for mat in mats for t in mat],
        *[o.data_ptr() for o in out], xq.data_ptr(), sx.data_ptr(),
        b, s, h, nh, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "qkv_int8")
    fused_qkv_int8.launches += 1
    return tuple(out)


fused_qkv_int8.launches = 0
