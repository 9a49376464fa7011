"""The fused int8 attention half-block: the CUDA kernel `csrc/attn_block.cu`
and its plain PyTorch version.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_attn_block.py::
fused_attn_block_int8`, which computes, per transformer layer of the int8
tower,

    hidden + out_proj(attn(LN1(hidden) @ {Wq, Wk, Wv}))

It is not wired into the tower, in JAX or here: it is an alternative to the
composed attention half (`fused_qkv_int8` -> merge-heads attention -> int8
out-projection), kept and measured beside it. Its numerics differ from
that composition in three places: the softmax scale goes on the fp32
logits and the base is e; `o = (P.v) / l` stays fp32; and the
out-projection quantizes o per (row, head) instead of per row, summing the
heads' rescaled int32 products in order.

Weights take the port's int8 layout, (H, H) stored column-major
(`quant.column_major`); `convert.attn_block_weights` turns JAX's row-major
ones into it. The kernel's out-projection reads Wo with each head's rows
zero-padded to the s8 wgmma depth (`pad_head_rows`, built per call).
`fused_attn_block_int8` takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.qkv_int8 import fused_qkv_int8_reference
from memory_augmented_vlm_torch.ops.quant import quantize_rows

NEG_INF = -1e30  # pallas_attn_block.NEG_INF
KERNEL_HEAD_DIMS = (32, 64, 72, 128)
WGMMA_DEPTH = 32  # bytes of K an s8 wgmma takes


def padded_head_dim(hd: int) -> int:
    """A head's depth as the out-projection reads it: hd rounded up to the
    s8 wgmma depth (72 -> 96)."""
    return -(-hd // WGMMA_DEPTH) * WGMMA_DEPTH


def pad_head_rows(w: torch.Tensor, nh: int) -> torch.Tensor:
    """w (nh * hd, N) int8 with each head's hd rows zero-padded to
    `padded_head_dim(hd)`: (nh * kp, N), column-major as w. Row h * kp + d
    is w's row h * hd + d for d < hd, and zero past it, so a product that
    reads kp codes of a head meets zeros wherever it reads past the head."""
    k, n = w.shape
    if nh < 1 or k % nh:
        raise ValueError(f"{k} rows do not split into {nh} heads")
    hd = k // nh
    kp = padded_head_dim(hd)
    out = torch.zeros((n, nh, kp), dtype=w.dtype, device=w.device)
    out[:, :, :hd] = w.t().reshape(n, nh, hd)
    return out.reshape(n, nh * kp).t()


def _shapes(hidden, weights, nh, valid):
    if hidden.dim() != 3:
        raise ValueError(f"hidden must be (B, S, H), got {tuple(hidden.shape)}")
    b, s, h = hidden.shape
    if nh < 1 or h % nh:
        raise ValueError(f"hidden size {h} does not split into {nh} heads")
    if valid < 0:
        raise ValueError(f"valid must be >= 0, got {valid}")
    for w, scale, bias in weights:
        if tuple(w.shape) != (h, h) or tuple(scale.shape) != (h,) or tuple(bias.shape) != (h,):
            raise ValueError(f"each projection must be ({h}, {h}) with ({h},) scale and bias")
    return b, s, h, h // nh


def fused_attn_block_int8_reference(hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                                    wo, so, bo, *, nh: int, valid: int, eps: float = 1e-6,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. hidden (B, S, H); ln_w, ln_b (H,); w* (H, H) int8;
    s*, b* (H,); keys at or past `valid` are masked (every query row is
    computed). Returns (B, S, H) in hidden's dtype.

    LN1 + row quant + the three int8 projections rounded to bf16 are
    `fused_qkv_int8`'s; per head, fp32 logits q.k * scale, -1e30 where
    masked, p = exp(logits - max), l = sum(p), o = (bf16(P).v) / l; o is
    quantized per (row, head) and the heads' int32 products with their
    rows of Wo are summed in head order, acc = acc + part_h * s_h; then
    acc * so + bo + hidden in fp32, cast once. The int8 products of the
    attention output run in float64, where they are exact."""
    weights = ((wq, sq, bq), (wk, sk, bk), (wv, sv, bv), (wo, so, bo))
    b, s, h, hd = _shapes(hidden, weights, nh, valid)
    scale = hd ** -0.5 if scale is None else scale
    q, k, v = fused_qkv_int8_reference(hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                                       nh=nh, eps=eps)  # (B, NH, S, hd) bf16
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = torch.arange(s, device=hidden.device) < valid
    logits = torch.where(keep, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float()) / l
    oq, so_row = quantize_rows(o)  # per (row, head): (B, NH, S, hd), (B, NH, S, 1)
    wo3 = wo.double().reshape(nh, hd, h)
    acc = torch.zeros((b, s, h), dtype=torch.float32, device=hidden.device)
    for i in range(nh):
        part = torch.matmul(oq[:, i].double(), wo3[i]).float()
        acc = acc + part * so_row[:, i]
    out = acc * so.float() + bo.float()
    return (hidden.float() + out).to(hidden.dtype)


def fused_attn_block_int8(hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so, bo,
                          *, nh: int, valid: int, eps: float = 1e-6,
                          scale: Optional[float] = None) -> torch.Tensor:
    """See `fused_attn_block_int8_reference` for the arguments. CUDA tensors
    launch `csrc/attn_block.cu` (hidden bf16 or fp32, contiguous; weights
    int8 column-major; head dims 32/64/72/128) and count one launch in
    `fused_attn_block_int8.launches`. S is not padded."""
    weights = ((wq, sq, bq), (wk, sk, bk), (wv, sv, bv), (wo, so, bo))
    b, s, h, hd = _shapes(hidden, weights, nh, valid)
    if hidden.device.type == "cpu":
        return fused_attn_block_int8_reference(hidden, ln_w, ln_b, *[t for w in weights for t in w],
                                               nh=nh, valid=valid, eps=eps, scale=scale)
    scale = hd ** -0.5 if scale is None else scale
    int8_common.check_cuda(hidden, "hidden")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention-block kernel head dim must be one of {KERNEL_HEAD_DIMS}, "
                         f"got {hd}")
    if b > 65535 or nh > 65535:
        raise ValueError("batch and head counts must fit a CUDA grid axis")
    dev = hidden.device
    vecs = [int8_common.f32_vector(t, h, dev, n) for t, n in ((ln_w, "ln_w"), (ln_b, "ln_b"))]
    mats = []
    for w, sc, bias in weights:
        int8_common.check_weight(w, h, h, dev)
        mats.append((w, int8_common.f32_vector(sc, h, dev, "scale"),
                     int8_common.f32_vector(bias, h, dev, "bias")))
    out = torch.empty_like(hidden)
    m = b * s
    if m == 0:
        return out
    # scratch: LN codes and row scales, head-major bf16 q/k/v, the attention
    # output's codes (each head's zero-padded to the depth of Wo's padded
    # rows) and per-(row, head) scales
    xq = torch.empty((m, h), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    qkv = [torch.empty((b, nh, s, hd), dtype=torch.bfloat16, device=dev) for _ in range(3)]
    oq = torch.empty((m, nh * padded_head_dim(hd)), dtype=torch.int8, device=dev)
    sa = torch.empty((m, nh), dtype=torch.float32, device=dev)
    mats[3] = (pad_head_rows(mats[3][0], nh), *mats[3][1:])
    lib = cuda_lib.load()
    rc = lib.attn_block_int8(
        int8_common.DTYPES[hidden.dtype], hidden.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), *[t.data_ptr() for mat in mats for t in mat], out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), *[x.data_ptr() for x in qkv], oq.data_ptr(),
        sa.data_ptr(), b, s, h, nh, min(valid, s), float(eps), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "attn_block_int8")
    fused_attn_block_int8.launches += 1
    return out


fused_attn_block_int8.launches = 0
