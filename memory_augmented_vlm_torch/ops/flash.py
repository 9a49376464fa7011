"""Flash attention: the CUDA kernels `csrc/flash_fwd_sm90.cu` (bf16),
`csrc/flash_fwd_wide_sm90.cu` (bf16 at head dims 256 and 448) and
`csrc/flash_fwd.cu` (fp32 at every head dim, 3xTF32 on the tensor cores),
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

import ctypes
import math
from typing import Optional, Tuple

import torch

from memory_augmented_vlm_torch.ops import cuda_lib, int8_common
from memory_augmented_vlm_torch.ops.quant import QUANT_FLOOR, int_mm, quantize_rows

LOG2E = 1.4426950408889634
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # pallas_flash.MASK_VALUE
KERNEL_HEAD_DIMS = (64, 72, 112, 128)
# the 7B memory's head dim (3584 / 8): bf16 through the kernel of
# csrc/flash_fwd_wide_sm90.cu (`flash_forward_wide`), fp32 through the
# 3xTF32 kernel of csrc/flash_fwd.cu (`flash_forward_d448_f32`)
WIDE_HEAD_DIM = 448
# Gemma's head dim, and the memory's at Gemma-2B's width (2048 / 8): bf16
# through the same wide kernel (`flash_forward_d256`), fp32 through the
# 3xTF32 kernel (`flash_forward_d256_f32`)
D256 = 256
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


def online_softmax(qs, k, v, kv_valid_len, causal, block_k, *, round_p=True, diagonal=0):
    """The TPU kernels' online softmax (`_accumulate` of `_flash_fwd_kernel`
    and `_fwd_lse_kernel`), step by step over tiles of `block_k` keys: the
    running max m, alpha = exp2(m_prev - m_next), p = exp2(s - m_next)
    rounded to v's dtype for PV (left in fp32 with `round_p=False`), l and
    the fp32 accumulator rescaled by alpha, MASK_VALUE for masked scores.

    qs: (B, Sq, H, D), q already scaled (in log2 units); k, v: (B, Skv, H,
    D), one K/V head per query head; kv_valid_len: (B,). A tile at or past
    a batch's valid length runs for none of its rows, as on the TPU; with
    `causal`, rows above a tile see none of its keys and are left out (a
    fully masked tile is an exact no-op for a row that has seen a key).
    `diagonal` moves the causal diagonal by that many keys. Returns (out =
    acc * (1 / l), zero where l = 0, as (B, Sq, H, D); m, l (B, H, Sq)),
    fp32; a row that ran no tile has m = -inf and l = 0."""
    b, sq, h, d = qs.shape
    skv, dev = k.shape[1], qs.device
    valid = kv_valid_len.to(dev)
    m = torch.full((b, h, sq), -math.inf, device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, d), device=dev)
    for n0 in range(0, skv, block_k):
        n1 = min(n0 + block_k, skv)
        r0 = min(max(n0 - diagonal, 0), sq) if causal else 0
        cols = torch.arange(n0, n1, device=dev)
        keep = (cols[None, :] < valid[:, None])[:, None, None, :]
        if causal:
            keep = keep & (cols[None, :] <= torch.arange(r0, sq, device=dev)[:, None] + diagonal)
        s = torch.einsum("bqhd,bkhd->bhqk", qs[:, r0:], k[:, n0:n1].float())
        s = torch.where(keep, s, MASK_VALUE)
        m_prev, l_prev, a_prev = m[:, :, r0:], l[:, :, r0:], acc[:, :, r0:]
        m_next = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp2(m_prev - m_next)
        p = torch.exp2(s - m_next[..., None])
        l_next = alpha * l_prev + p.sum(dim=-1)
        pv = p.to(v.dtype).float() if round_p else p
        a_next = a_prev * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv,
                                                          v[:, n0:n1].float())
        run = (n0 < valid)[:, None, None]  # no block runs a tile past the valid length
        m[:, :, r0:] = torch.where(run, m_next, m_prev)
        l[:, :, r0:] = torch.where(run, l_next, l_prev)
        acc[:, :, r0:] = torch.where(run[..., None], a_next, a_prev)
    out = acc * torch.where(l == 0, 1.0, 1.0 / l)[..., None]
    return out.transpose(1, 2), m, l


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_groups: int = 1,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same base-2 math.

    q: (B, Sq, H, D); k, v: (B, Skv, H // kv_groups, D); kv_valid_len: (B,)
    int. Query head h reads key/value head h // kv_groups (HF `repeat_kv`
    order). Returns (B, Sq, H, D) in q.dtype.

    `block_k=None` takes one tile over the whole key axis: P is rounded to
    q's dtype against the row's final max. An integer runs the kernels'
    online softmax over tiles of `block_k` keys (`online_softmax`): P is
    rounded against the running max of each tile, which is the function
    the TPU kernel and the bf16 CUDA kernel compute at that tile, and the
    output is acc * (1 / l) (zero where l = 0)."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    scale = d ** -0.5 if scale is None else scale
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=2)
        v = v.repeat_interleave(kv_groups, dim=2)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    if block_k is not None:
        if kv_valid_len is None:
            kv_valid_len = torch.full((b,), skv, dtype=torch.int32)
        return online_softmax(qs, k, v, kv_valid_len, causal, block_k)[0].to(q.dtype)
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


def map_strides(x: torch.Tensor):
    """x's (batch, sequence, head) strides, as a TMA tensor map takes them:
    a dim of size 1 is never stepped, so its stride only has to be a valid
    one (16 bytes)."""
    return tuple(st if n > 1 else 8 for st, n in zip(x.stride()[:3], x.shape[:3]))


def _check_kernel_args(q, k, v, kv_valid_len, d):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d not in KERNEL_HEAD_DIMS + (D256, WIDE_HEAD_DIM):
        raise ValueError(f"flash kernel head dim must be one of {KERNEL_HEAD_DIMS}, {D256} "
                         f"or {WIDE_HEAD_DIM}, got {d}")
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


# Query rows of a block of the wide kernel (csrc/flash_fwd_wide_sm90.cu),
# its only block size at each head dim: 128 at D256 (two consumer
# warpgroups of 64 rows), 64 at WIDE_HEAD_DIM (two warpgroups splitting the
# columns of the same 64 rows). `forward_plan` checks it against the
# library's `flash_fwd_tiles`.
WIDE_BLOCK_ROWS = {D256: 128, WIDE_HEAD_DIM: 64}


def forward_tiles(head_dim: int) -> Tuple[int, int]:
    """(keys per K/V tile, most query rows per block) of the bf16 forward
    kernel at a head dim, as the built library reports them: its online
    softmax rounds P against the running max of each key tile, so the plain
    version that holds it takes the same `block_k`. At `D256` and
    `WIDE_HEAD_DIM` the tiles are the wide kernel's (64 and 32 keys,
    `WIDE_BLOCK_ROWS`)."""
    key_tile, rows = ctypes.c_int(), ctypes.c_int()
    lib = cuda_lib.load()
    cuda_lib.check(lib, lib.flash_fwd_tiles(head_dim, ctypes.byref(key_tile),
                                            ctypes.byref(rows)), "flash_fwd_tiles")
    return key_tile.value, rows.value


def forward_block_rows(b: int, sq: int, h: int, d: int, max_rows: int, sms: int) -> int:
    """Query rows per block of the bf16 forward kernel at head dim `d`. The
    wide kernel (`D256`, `WIDE_HEAD_DIM`) has one block size,
    `WIDE_BLOCK_ROWS[d]`: at 256 its two warpgroups own 64 rows each, so a
    64-row block would leave one idle (the memory's fuse, 8 heads of 1568
    rows, runs 104 blocks of 128 rows in one wave on 132 SMs). The narrower
    kernel takes `max_rows` (three consumer warpgroups of 64 rows, two at
    D >= 112) when that grid gives each of the card's `sms` SMs two blocks
    or more, else one warpgroup's 64 (two such blocks share an SM): the
    memory's cross-attentions at head dim 112 would make 72 blocks of 192
    rows; they take 200 of 64, since the kernel does not split the key axis
    (that would move P's rounding points)."""
    if d in WIDE_BLOCK_ROWS:
        return WIDE_BLOCK_ROWS[d]
    return max_rows if b * h * -(-sq // max_rows) >= 2 * sms else 64


def forward_work_list(b: int, sq: int, skv: int, h: int, causal: bool, block_rows: int,
                      key_tile: int):
    """The bf16 forward kernel's blocks, (batch, query head, query tile of
    `block_rows` rows). Causal: the dQ kernel's work list at the forward's
    tiles (its loop is dQ's), the longest loop first so that short ones
    fill the tail. Otherwise every loop is as long, and each head's tiles
    come side by side, so the blocks that read one head's K/V run together."""
    if causal:
        from memory_augmented_vlm_torch.ops import flash_bwd  # it imports this module
        return flash_bwd.work_list("dq", b, sq, skv, h, True, block_rows, key_tile)
    tiles = -(-sq // block_rows)
    return tuple((bi, hi, i) for bi in range(b) for hi in range(h) for i in range(tiles))


_FWD_PLANS = {}


def forward_plan(b, sq, skv, h, d, causal, device) -> Tuple[int, torch.Tensor]:
    """(block rows, work items as an (n, 3) int32 tensor on `device`) of the
    bf16 forward kernel, made once per shape."""
    key = (b, sq, skv, h, d, causal, str(device))
    if key not in _FWD_PLANS:
        key_tile, max_rows = forward_tiles(d)
        if d in WIDE_BLOCK_ROWS and max_rows != WIDE_BLOCK_ROWS[d]:
            raise RuntimeError(f"the wide kernel's block rows at {d}: library {max_rows}, "
                               f"WIDE_BLOCK_ROWS {WIDE_BLOCK_ROWS[d]}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        rows = forward_block_rows(b, sq, h, d, max_rows, sms)
        items = forward_work_list(b, sq, skv, h, causal, rows, key_tile)
        _FWD_PLANS[key] = rows, torch.tensor(items, dtype=torch.int32,
                                             device=device).reshape(-1, 3)
    return _FWD_PLANS[key]


def _flash_forward(q, k, v, kv_valid_len, causal, scale, kv_groups):
    if q.dtype == torch.float32:
        wide = {D256: flash_forward_d256_f32, WIDE_HEAD_DIM: flash_forward_d448_f32}
    else:
        wide = {D256: flash_forward_d256, WIDE_HEAD_DIM: flash_forward_wide}
    wide = wide.get(q.shape[-1])
    if wide is not None:
        return wide(q, k, v, kv_valid_len, causal=causal, scale=scale, kv_groups=kv_groups)
    return _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups, flash_attention)


def flash_forward_wide(q, k, v, kv_valid_len, *, causal, scale, kv_groups):
    """#1 at `WIDE_HEAD_DIM` (the 7B memory's cross-attentions), which
    `flash_attention` reaches at that head dim: CPU tensors take the plain
    version; bf16 CUDA tensors launch `csrc/flash_fwd_wide_sm90.cu` (key
    tiles of 32, `forward_tiles`), counted in `flash_forward_wide.launches`;
    fp32 CUDA tensors raise (`flash_forward_d448_f32` takes them)."""
    if q.shape[-1] != WIDE_HEAD_DIM:
        raise ValueError(f"flash_forward_wide takes head dim {WIDE_HEAD_DIM}, got "
                         f"{q.shape[-1]}")
    if q.dtype == torch.float32 and q.device.type == "cuda":
        raise TypeError("flash_forward_wide takes bf16 CUDA tensors; fp32 goes to "
                        "flash_forward_d448_f32")
    return _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups,
                           flash_forward_wide)


flash_forward_wide.launches = 0


def flash_forward_d256(q, k, v, kv_valid_len, *, causal, scale, kv_groups):
    """#1 at head dim `D256` (Gemma's LM prefill, and the memory's
    cross-attentions at Gemma-2B's width), which `flash_attention` reaches
    at that head dim in bf16: CPU tensors take the plain version; bf16 CUDA
    tensors launch `csrc/flash_fwd_wide_sm90.cu` at 256 (blocks of 128 rows,
    key tiles of 64, `forward_tiles`), counted in
    `flash_forward_d256.launches`."""
    if q.shape[-1] != D256:
        raise ValueError(f"flash_forward_d256 takes head dim {D256}, got {q.shape[-1]}")
    if q.dtype == torch.float32 and q.device.type == "cuda":
        raise TypeError("flash_forward_d256 takes bf16 CUDA tensors; fp32 goes to "
                        "flash_forward_d256_f32")
    return _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups,
                           flash_forward_d256)


flash_forward_d256.launches = 0


def flash_forward_d256_f32(q, k, v, kv_valid_len, *, causal, scale, kv_groups):
    """#1 at head dim `D256` in fp32 (the fp32 parity runs of a Gemma-2B
    model: the memory at 2048 over 8 heads), which `flash_attention` reaches
    at that head dim and dtype: CPU tensors take the plain version; CUDA
    tensors launch the 3xTF32 kernel of `csrc/flash_fwd.cu` at 256, counted
    in `flash_forward_d256_f32.launches`."""
    if q.shape[-1] != D256 or q.dtype != torch.float32:
        raise ValueError(f"flash_forward_d256_f32 takes fp32 at head dim {D256}, got "
                         f"{q.dtype} at {q.shape[-1]}")
    return _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups,
                           flash_forward_d256_f32)


flash_forward_d256_f32.launches = 0


def flash_forward_d448_f32(q, k, v, kv_valid_len, *, causal, scale, kv_groups):
    """#1 at `WIDE_HEAD_DIM` in fp32 (the fp32 parity runs of a 7B model:
    the memory at 3584 over 8 heads), which `flash_attention` reaches at
    that head dim and dtype: CPU tensors take the plain version; CUDA
    tensors launch the 3xTF32 kernel of `csrc/flash_fwd.cu` at 448, counted
    in `flash_forward_d448_f32.launches`."""
    if q.shape[-1] != WIDE_HEAD_DIM or q.dtype != torch.float32:
        raise ValueError(f"flash_forward_d448_f32 takes fp32 at head dim {WIDE_HEAD_DIM}, "
                         f"got {q.dtype} at {q.shape[-1]}")
    return _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups,
                           flash_forward_d448_f32)


flash_forward_d448_f32.launches = 0


def _launch_forward(q, k, v, kv_valid_len, causal, scale, kv_groups, counter):
    """The plain version on CPU tensors; on CUDA ones the forward kernel,
    counted in `counter.launches`."""
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
    rows, items = (forward_plan(b, sq, skv, h, d, causal, q.device) if q.dtype == torch.bfloat16
                   else (0, None))
    rc = lib.flash_fwd(
        _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), kv_valid_len.data_ptr(), b, sq, skv, h, kv_groups,
        int(causal), *map_strides(q), *map_strides(k), *map_strides(v),
        *out.stride()[:3], scale * LOG2E, stream, None if items is None else items.data_ptr(),
        0 if items is None else items.shape[0], rows)
    cuda_lib.check(lib, rc, "flash_fwd")
    counter.launches += 1
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
    `csrc/flash_fwd_sm90.cu` (bf16; one block per item of `forward_plan`)
    or `csrc/flash_fwd.cu` (fp32), head dims 64/72/112/128, and count the
    launch in `flash_attention.launches`; head dims 256 and 448 go to
    `flash_forward_d256` and `flash_forward_wide` (fp32:
    `flash_forward_d256_f32`, `flash_forward_d448_f32`), which count their
    own.
    Differentiable: the backward is `_FlashAttention`'s plain recompute."""
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


def _check_merge_kernel_args(q, k, v, kv_valid_len=None):
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
    if kv_valid_len is not None and (kv_valid_len.device != q.device
                                     or kv_valid_len.dtype != torch.int32
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
    """max(|x|, 1e-12) / 127 over the last two axes, kept as (..., 1, 1). The
    divisor is a tensor: on a CUDA tensor, PyTorch divides by a Python
    scalar as a multiply by its reciprocal, which is not the division the
    kernel and the CPU do."""
    amax = x.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(QUANT_FLOOR)
    return amax / amax.new_tensor(127.0)


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


def int8_scores_key_order(n: int) -> torch.Tensor:
    """The key at each of the first `n` places of PV's contraction in the
    `int8_scores` kernel: within each 32-key step, thread t's four P codes
    (keys 2t, 2t+1, 8+2t, 9+2t of its score accumulator, and 16 + those)
    are places 4t..4t+3 (and 16 + those) of the 8-bit A fragment, so place
    bits s3 s2 s1 s0 hold key bits s1 s3 s2 s0."""
    pl = torch.arange(n)
    return ((pl & ~15) | (((pl >> 1) & 1) << 3) | (((pl >> 3) & 1) << 2)
            | (((pl >> 2) & 1) << 1) | (pl & 1))


def merge_int8_prep_reference(k: torch.Tensor, v: torch.Tensor):
    """Plain version of the `int8_scores` kernel's prep pass, which
    quantizes K and V once per (batch, head). k, v (B, NH, S, D). Returns
    kq (B, NH, S, DK) int8, the K codes with the depth zero-padded to DK = D
    rounded up to 32; vt (B, NH, D, S16) int8, the V codes transposed with S
    rounded up to 16 and the keys in `int8_scores_key_order` (zero for keys
    past S); and scales (B, NH, 2) fp32, sk and sv, each over all S rows."""
    b, nh, s, d = k.shape
    dk, sp = -(-d // 32) * 32, -(-s // 16) * 16
    kf, vf = k.float(), v.float()
    sk, sv = _scalar_scale(kf), _scalar_scale(vf)
    kq = torch.nn.functional.pad(_codes(kf, sk), (0, dk - d)).to(torch.int8)
    vq = torch.nn.functional.pad(_codes(vf, sv), (0, 0, 0, sp - s))
    vt = vq[:, :, int8_scores_key_order(sp).to(vq.device)].transpose(-1, -2).contiguous()
    return kq, vt.to(torch.int8), torch.cat([sk, sv], dim=-1).view(b, nh, 2)


def merge_int8_prep(k: torch.Tensor, v: torch.Tensor):
    """The prep pass alone, as the `int8_scores` wrapper launches it before
    its main kernel; see `merge_int8_prep_reference`. CPU tensors take the
    plain version; CUDA tensors launch `csrc/flash_merge_int8.cu`'s prep
    kernel and count one launch in `merge_int8_prep.launches`."""
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be one (B, NH, S, D) shape, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nh, s, d = k.shape
    if k.device.type == "cpu":
        return merge_int8_prep_reference(k, v)
    _check_merge_kernel_args(k, k, v)
    kq, vt, scales = _int8_prep_scratch(b, nh, s, d, k.device)
    if b == 0 or s == 0:
        return kq, vt, scales
    lib = cuda_lib.load()
    rc = lib.flash_merge_int8_prep(d, k.data_ptr(), v.data_ptr(), kq.data_ptr(), vt.data_ptr(),
                                   scales.data_ptr(), b, nh, s,
                                   torch.cuda.current_stream(k.device).cuda_stream)
    cuda_lib.check(lib, rc, "flash_merge_int8_prep")
    merge_int8_prep.launches += 1
    return kq, vt, scales


merge_int8_prep.launches = 0


def _int8_prep_scratch(b, nh, s, d, dev):
    return (torch.empty((b, nh, s, -(-d // 32) * 32), dtype=torch.int8, device=dev),
            torch.empty((b, nh, d, -(-s // 16) * 16), dtype=torch.int8, device=dev),
            torch.empty((b, nh, 2), dtype=torch.float32, device=dev))


def flash_attention_merge_heads_int8_scores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid_len: torch.Tensor,
    *, scale: Optional[float] = None, block_q: int = 128,
) -> torch.Tensor:
    """The approximate `int8_scores` mode of the merge-heads attention; see
    `flash_attention_merge_heads_int8_scores_reference`. CPU tensors take
    the plain version; CUDA tensors launch `csrc/flash_merge_int8.cu` (its
    prep pass, then its main kernel; bf16, contiguous, head dims 64/72/128)
    and count one launch in
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
    # scratch: the prep pass's K codes, V^T codes and scales
    kq, vt, scales = _int8_prep_scratch(b, nh, s, d, q.device)
    lib = cuda_lib.load()
    rc = lib.flash_merge_int8(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              kv_valid_len.data_ptr(), kq.data_ptr(), vt.data_ptr(),
                              scales.data_ptr(), b, nh, s, tile, scale * LOG2E,
                              torch.cuda.current_stream(q.device).cuda_stream)
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
