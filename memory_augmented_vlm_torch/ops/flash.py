"""Flash attention: the CUDA kernels `csrc/flash_fwd.cu` and
`csrc/flash_merge.cu` and their plain PyTorch versions.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_flash.py::
pallas_flash_attention` (bshd layout). Both versions compute the TPU
kernel's function: q scaled by scale*log2(e) and rounded to the input dtype,
fp32 scores, a base-2 softmax, keys at or past `kv_valid_len[b]` masked (and
above the diagonal when `causal`), P rounded to the input dtype before PV,
zero rows where no key is valid, and the output in the input dtype.
`flash_attention` is differentiable, as `pallas_flash_attention`'s
`custom_vjp` is: its backward recomputes `xla_attention_reference` in
plain PyTorch and takes that function's gradient (JAX's `_flash_bwd` is
XLA code outside any Pallas kernel). The LM's training attention has
kernels of its own (`ops/flash_bwd.py`).

`flash_attention_merge_heads` is the counterpart of `pallas_flash.py::
flash_attention_merge_heads`: head-major (B, NH, S, D) q/k/v in, merged
heads (B, S, NH*D) out, and a one-shot softmax over the whole key axis with
the TPU kernel's finite MASK_VALUE. Its approximate `int8_scores` mode runs
both attention products on int8 codes with scalar scales
(`flash_attention_merge_heads_int8_scores`, `csrc/flash_merge_int8.cu`).
`flash_attention_out_proj_int8` is the counterpart of `pallas_flash.py::
flash_attention_out_proj_int8`: that attention, rounded to bf16, through
the int8 out-projection (`acc * sx * so + bo` with the bias added in fp32)
and onto the residual stream, in one launch.

Each wrapper takes its plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.quant import QUANT_FLOOR, int_mm, quantize_rows

LOG2E = 1.4426950408889634
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # pallas_flash.MASK_VALUE
KERNEL_HEAD_DIMS = (64, 72, 112, 128)
MERGE_HEAD_DIMS = (64, 72, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _shapes(q, k, v, kv_groups, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes bshd tensors (B, S, H, D)")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if kv_groups < 1 or h % kv_groups:
        raise ValueError(f"{h} query heads do not split into kv_groups={kv_groups}")
    want = (b, skv, h // kv_groups, d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"k/v must be {want}, got {tuple(k.shape)}/{tuple(v.shape)}")
    if causal and sq != skv:
        raise ValueError("causal flash attention requires equal q/kv lengths")
    return b, sq, skv, h, d


def attention_mask(b: int, sq: int, skv: int, kv_valid_len: Optional[torch.Tensor],
                   causal: bool, device) -> torch.Tensor:
    """Bool mask broadcastable to (B, H, Sq, Skv): key c is visible to query
    row r when c < kv_valid_len[b] (every key when it is None) and, when
    causal, c <= r."""
    col = torch.arange(skv, device=device)
    if kv_valid_len is None:
        mask = torch.ones((b, 1, 1, skv), dtype=torch.bool, device=device)
    else:
        mask = (col[None, :] < kv_valid_len.to(device)[:, None])[:, None, None, :]
    if causal:
        mask = mask & (col[None, :] <= torch.arange(sq, device=device)[:, None])
    return mask


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_groups: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same base-2 math.

    q: (B, Sq, H, D); k, v: (B, Skv, H // kv_groups, D); kv_valid_len: (B,)
    int. Query head h reads key/value head h // kv_groups (HF `repeat_kv`
    order). Returns (B, Sq, H, D) in q.dtype."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    scale = d ** -0.5 if scale is None else scale
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=2)
        v = v.repeat_interleave(kv_groups, dim=2)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    mask = attention_mask(b, sq, skv, kv_valid_len, causal, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1)  # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = l.transpose(1, 2)[..., None]  # (B, Sq, H, 1)
    o = torch.where(l == 0, torch.zeros_like(o), o / l)
    return o.to(q.dtype)


def _check_kernel_args(q, k, v, kv_valid_len, d):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {KERNEL_HEAD_DIMS}, got {d}")
    # 16-byte vector loads: rows start on 16 bytes, the head dim is contiguous
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
        if any(st % align for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")
    if (kv_valid_len.device != q.device or kv_valid_len.dtype != torch.int32
            or tuple(kv_valid_len.shape) != (q.shape[0],)
            or not kv_valid_len.is_contiguous()):
        raise ValueError("kv_valid_len must be a contiguous (B,) int32 tensor on q's device")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError("batch and head counts must fit a CUDA grid axis")


def _flash_forward(q, k, v, kv_valid_len, causal, scale, kv_groups):
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_valid_len, causal=causal,
                                         scale=scale, kv_groups=kv_groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_kernel_args(q, k, v, kv_valid_len, d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b == 0:
        return out
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd(
        _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), kv_valid_len.data_ptr(), b, sq, skv, h, kv_groups,
        int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale * LOG2E, stream)
    cuda_lib.check(lib, rc, "flash_fwd")
    flash_attention.launches += 1
    return out


def xla_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    kv_groups: int = 1,
) -> torch.Tensor:
    """The function whose gradient is the kernel's backward (JAX
    `pallas_flash._xla_attention`): fp32 logits of the unrounded q, times
    `scale`, MASK_VALUE where masked, a natural-base fp32 softmax, and the
    probabilities cast to q's dtype before PV."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=2)
        v = v.repeat_interleave(kv_groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(b, sq, skv, kv_valid_len, causal, q.device)
    probs = torch.softmax(torch.where(mask, logits, MASK_VALUE), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel; backward as JAX's `_flash_bwd`, which is
    XLA code outside any Pallas kernel: recompute `xla_attention_reference`
    in plain PyTorch and take its gradient with `torch.autograd.grad`. The
    recompute holds (B, H, Sq, Skv) fp32 logits, about 0.8 GB at the
    memory's evolve shape (8 heads, 1568 x 15680)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len, causal, scale, kv_groups):
        ctx.save_for_backward(q, k, v, kv_valid_len)
        ctx.opts = dict(causal=causal, scale=scale, kv_groups=kv_groups)
        return _flash_forward(q, k, v, kv_valid_len, causal, scale, kv_groups)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_valid_len = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = xla_attention_reference(*inputs, kv_valid_len, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_groups: int = 1,
) -> torch.Tensor:
    """Flash attention over bshd tensors; see `flash_attention_reference` for
    the arguments. CPU tensors take the plain version; CUDA tensors launch
    `csrc/flash_fwd.cu` (head dims 64/72/112/128, bf16 or fp32) and count
    the launch in `flash_attention.launches`. Differentiable: the backward
    is `_FlashAttention`'s plain recompute."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    scale = d ** -0.5 if scale is None else scale
    if kv_valid_len is None:
        kv_valid_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(q, k, v, kv_valid_len, causal, scale, kv_groups)


flash_attention.launches = 0


def _merge_shapes(q, k, v, kv_valid_len):
    if q.dim() != 4:
        raise ValueError("merge-heads attention takes bhsd tensors (B, NH, S, D)")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k and v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(kv_valid_len.shape) != (q.shape[0],):
        raise ValueError(f"kv_valid_len must be ({q.shape[0]},)")
    return q.shape


def flash_attention_merge_heads_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version. q, k, v (B, NH, S, D); kv_valid_len (B,). Returns
    (B, S, NH*D) in q.dtype.

    Per head: q * scale * log2(e) rounded to q's dtype, fp32 scores with
    MASK_VALUE for keys at or past the valid length, m = the row max over
    all S keys, p = exp2(s - m), l = sum(p) in fp32, P rounded to bf16 for
    PV, out = o * (1/l). A batch with valid length 0 masks every key with
    the same finite value, so each of its rows is the mean of V over all S
    keys, as on the TPU."""
    b, nh, s, d = _merge_shapes(q, k, v, kv_valid_len)
    scale = d ** -0.5 if scale is None else scale
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    sc = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    keep = torch.arange(s, device=q.device)[None, :] < kv_valid_len.to(q.device)[:, None]
    sc = torch.where(keep[:, None, None, :], sc, MASK_VALUE)
    p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), v.float())
    out = (o * (1.0 / l)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, nh * d)


def _check_merge_kernel_args(q, k, v, kv_valid_len):
    """What `csrc/flash_merge.cu` takes: bf16 contiguous CUDA q/k/v of a
    built head dim and an int32 valid length beside them."""
    b, nh, _, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"merge-heads attention runs on cpu or cuda, not {q.device}")
    if d not in MERGE_HEAD_DIMS:
        raise ValueError(f"merge kernel head dim must be one of {MERGE_HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"merge kernel takes bf16, {name} is {x.dtype}")
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {q.device}")
    if (kv_valid_len.device != q.device or kv_valid_len.dtype != torch.int32
            or not kv_valid_len.is_contiguous()):
        raise ValueError("kv_valid_len must be a contiguous int32 tensor on q's device")
    if b > 65535 or nh > 65535:
        raise ValueError("batch and head counts must fit a CUDA grid axis")


def flash_attention_merge_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    *, scale: Optional[float] = None, block_q: int = 128, int8_scores: bool = False,
) -> torch.Tensor:
    """One-shot attention with a merged-head store; see
    `flash_attention_merge_heads_reference`. CPU tensors take the plain
    version; CUDA tensors launch `csrc/flash_merge.cu` (bf16, contiguous,
    head dims 64/72/128) and count the launch in
    `flash_attention_merge_heads.launches`. `int8_scores=True` takes the
    approximate mode instead, `flash_attention_merge_heads_int8_scores`,
    whose q tiles `block_q` sets; the exact mode's result does not depend
    on `block_q`."""
    if int8_scores:
        return flash_attention_merge_heads_int8_scores(q, k, v, kv_valid_len, scale=scale,
                                                       block_q=block_q)
    b, nh, s, d = _merge_shapes(q, k, v, kv_valid_len)
    if q.device.type == "cpu":
        return flash_attention_merge_heads_reference(q, k, v, kv_valid_len, scale=scale)
    scale = d ** -0.5 if scale is None else scale
    _check_merge_kernel_args(q, k, v, kv_valid_len)
    out = torch.empty((b, s, nh * d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = cuda_lib.load()
    rc = lib.flash_merge(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         kv_valid_len.data_ptr(), b, nh, s, scale * LOG2E,
                         torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(lib, rc, "flash_merge")
    flash_attention_merge_heads.launches += 1
    return out


flash_attention_merge_heads.launches = 0


def merge_q_tile(s: int, block_q: int = 128) -> int:
    """Query rows per scale tile of the `int8_scores` mode: JAX's rule
    (`block_q` halved until it divides the stream) applied to S rounded up
    to 8, the sublane-aligned stream that JAX's tower pads to. For S a
    multiple of 8 this is JAX's own tiling; at S = 729 it is JAX's 32-row
    tower tile, and the last of 23 tiles holds 25 rows."""
    if block_q < 1:
        raise ValueError(f"block_q must be positive, got {block_q}")
    s8 = max(-(-s // 8) * 8, 8)
    tile = min(block_q, s8)
    while s8 % tile:
        tile //= 2
    return tile


def _scalar_scale(x: torch.Tensor) -> torch.Tensor:
    """max(|x|, 1e-12) / 127 over the last two axes, kept as (..., 1, 1)."""
    return x.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(QUANT_FLOOR) / 127.0


def _codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x * (1/s)), -127, 127), as float values."""
    return torch.round(x * (1.0 / s)).clamp_(-127, 127)


def flash_attention_merge_heads_int8_scores_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    *, scale: Optional[float] = None, block_q: int = 128,
) -> torch.Tensor:
    """Plain version of the `int8_scores` mode. q, k, v (B, NH, S, D);
    kv_valid_len (B,). Returns (B, S, NH*D) in q.dtype.

    Per (batch, head): qf = q * scale * log2(e) in fp32 (not rounded to
    q's dtype), one scale sq = max(|qf|, 1e-12) / 127 per tile of
    `merge_q_tile(S, block_q)` query rows (the last tile may be ragged);
    one scale each for k and v over all S keys, masked keys included;
    codes clip(round(x * (1/s)), +-127). Scores are the exact int32 product
    of the codes times sq*sk, MASK_VALUE at or past the valid length;
    p = exp2(s - max), l = sum(p) over the unrounded p, P stored as
    round(p * 127); out = (P . vq) * ((sv / 127) / l). JAX's tower pads
    the stream from 729 to 736 rows, so its last q tile and its k/v scales
    also see 7 pad rows; here there are none. The integer products run in
    float64, where they are exact."""
    b, nh, s, d = _merge_shapes(q, k, v, kv_valid_len)
    scale = d ** -0.5 if scale is None else scale
    tile = merge_q_tile(s, block_q)
    nt = -(-s // tile)
    qf = torch.nn.functional.pad(q.float() * (scale * LOG2E), (0, 0, 0, nt * tile - s))
    qf = qf.view(b, nh, nt, tile, d)
    sq = _scalar_scale(qf)  # (B, NH, nt, 1, 1)
    qq = _codes(qf, sq).view(b, nh, nt * tile, d)[:, :, :s]
    sq = sq.view(b, nh, nt, 1).repeat_interleave(tile, dim=2)[:, :, :s]
    kf, vf = k.float(), v.float()
    sk, sv = _scalar_scale(kf), _scalar_scale(vf)  # (B, NH, 1, 1)
    raw = torch.matmul(qq.double(), _codes(kf, sk).double().transpose(-1, -2)).float()
    keep = torch.arange(s, device=q.device)[None, :] < kv_valid_len.to(q.device)[:, None]
    sc = torch.where(keep[:, None, None, :], raw * (sq * sk), MASK_VALUE)
    p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(torch.round(p * 127.0).double(), _codes(vf, sv).double()).float()
    out = (acc * ((sv / 127.0) / l)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, nh * d)


def flash_attention_merge_heads_int8_scores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    *, scale: Optional[float] = None, block_q: int = 128,
) -> torch.Tensor:
    """The approximate `int8_scores` mode of the merge-heads attention; see
    `flash_attention_merge_heads_int8_scores_reference`. CPU tensors take
    the plain version; CUDA tensors launch `csrc/flash_merge_int8.cu`
    (bf16, contiguous, head dims 64/72/128) and count one launch in
    `flash_attention_merge_heads_int8_scores.launches`."""
    b, nh, s, d = _merge_shapes(q, k, v, kv_valid_len)
    tile = merge_q_tile(s, block_q)
    if q.device.type == "cpu":
        return flash_attention_merge_heads_int8_scores_reference(q, k, v, kv_valid_len,
                                                                 scale=scale, block_q=block_q)
    scale = d ** -0.5 if scale is None else scale
    _check_merge_kernel_args(q, k, v, kv_valid_len)
    out = torch.empty((b, s, nh * d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    nt = -(-s // tile)
    # scratch: per (batch, head), the nt q-tile scales, then sk and sv
    scales = torch.empty((b * nh, nt + 2), dtype=torch.float32, device=q.device)
    lib = cuda_lib.load()
    rc = lib.flash_merge_int8(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              kv_valid_len.data_ptr(), scales.data_ptr(), b, nh, s, tile,
                              scale * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(lib, rc, "flash_merge_int8")
    flash_attention_merge_heads_int8_scores.launches += 1
    return out


flash_attention_merge_heads_int8_scores.launches = 0


def _oproj_shapes(q, k, v, kv_valid_len, hidden, wo, so, bo):
    b, nh, s, d = _merge_shapes(q, k, v, kv_valid_len)
    h = nh * d
    if tuple(hidden.shape) != (b, s, h):
        raise ValueError(f"residual stream {tuple(hidden.shape)} must match q's geometry "
                         f"{(b, s, h)}")
    if tuple(wo.shape) != (h, h) or tuple(so.shape) != (h,) or tuple(bo.shape) != (h,):
        raise ValueError(f"the out-projection must be ({h}, {h}) with ({h},) scale and bias")
    return b, nh, s, d


def flash_attention_out_proj_int8_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    hidden: torch.Tensor, wo: torch.Tensor, so: torch.Tensor, bo: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version. q, k, v (B, NH, S, D); kv_valid_len (B,); hidden
    (B, S, NH*D), the residual stream; wo (NH*D, NH*D) int8 with so, bo
    (NH*D,). Returns hidden + out_proj(attention) in hidden's dtype.

    The attention of `flash_attention_merge_heads_reference` is rounded to
    bf16 whatever q's dtype (the TPU kernel's merged scratch is bf16), its
    rows are quantized over the whole NH*D width, and `acc * sx * so + bo`
    and the residual add are fp32, cast once. `quant.int8_linear` adds the
    bias after the cast instead, so this and the unfused layer differ by
    roundings."""
    b, nh, s, d = _oproj_shapes(q, k, v, kv_valid_len, hidden, wo, so, bo)
    attn = flash_attention_merge_heads_reference(q, k, v, kv_valid_len, scale=scale)
    xq, sx = quantize_rows(attn.to(torch.bfloat16).reshape(b * s, nh * d))
    y = int_mm(xq, wo).float() * sx * so.float() + bo.float()
    return (hidden.float() + y.reshape(b, s, nh * d)).to(hidden.dtype)


def flash_attention_out_proj_int8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    hidden: torch.Tensor, wo: torch.Tensor, so: torch.Tensor, bo: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Merged-head attention + int8 out-projection + residual; see
    `flash_attention_out_proj_int8_reference`. CPU tensors take the plain
    version; CUDA tensors launch `csrc/flash_merge.cu`'s fused entry (q, k,
    v bf16 contiguous, head dims 64/72/128; hidden bf16 or fp32 contiguous;
    wo int8 column-major) and count one launch in
    `flash_attention_out_proj_int8.launches`. S is not padded."""
    b, nh, s, d = _oproj_shapes(q, k, v, kv_valid_len, hidden, wo, so, bo)
    if q.device.type == "cpu":
        return flash_attention_out_proj_int8_reference(q, k, v, kv_valid_len, hidden, wo, so,
                                                       bo, scale=scale)
    scale = d ** -0.5 if scale is None else scale
    _check_merge_kernel_args(q, k, v, kv_valid_len)
    int8_common.check_cuda(hidden, "hidden")
    dev, h = q.device, nh * d
    if hidden.device != dev:
        raise ValueError(f"hidden is on {hidden.device}, q on {dev}")
    int8_common.check_weight(wo, h, h, dev)
    so = int8_common.f32_vector(so, h, dev, "so")
    bo = int8_common.f32_vector(bo, h, dev, "bo")
    out = torch.empty_like(hidden)
    if b == 0 or s == 0:
        return out
    # scratch: the merged bf16 attention rows, their codes and row scales
    attn = torch.empty((b * s, h), dtype=torch.bfloat16, device=dev)
    xq = torch.empty((b * s, h), dtype=torch.int8, device=dev)
    sx = torch.empty((b * s,), dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    rc = lib.flash_merge_oproj(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid_len.data_ptr(),
        int8_common.DTYPES[hidden.dtype], hidden.data_ptr(), wo.data_ptr(), so.data_ptr(),
        bo.data_ptr(), out.data_ptr(), attn.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        b, nh, s, scale * LOG2E, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, rc, "flash_merge_oproj")
    flash_attention_out_proj_int8.launches += 1
    return out


flash_attention_out_proj_int8.launches = 0
