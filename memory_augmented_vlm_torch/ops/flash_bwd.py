"""Differentiable flash attention for training: the CUDA kernels of
`csrc/flash_fwd_sm90.cu`, `csrc/flash_bwd_sm90.cu` and `csrc/flash_train.cu`
and their plain PyTorch versions.

Counterpart of `memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py` (bshd
layout, GQA through `kv_groups`):

  - `forward_with_lse` (`_forward_with_lse`): the flash forward of
    `ops/flash.py` with masked scores at the finite MASK_VALUE, that also
    returns lse (B, H, Sq) fp32 in log2 units, m + log2(max(l, 1e-30));
    a batch with valid length 0 gives out = 0 and lse = -inf;
  - `backward_dq` and `backward_dkv` (`_backward`'s two kernels): with q
    scaled by scale*log2(e) and rounded to its dtype, p = exp2(s - lse)
    zeroed where masked, ds = p * (dp - delta) * scale; dQ = ds K, dV =
    p^T dO with p rounded to dO's dtype, dK = ds^T Q with ds rounded to
    q's dtype. dK/dV of a KV head sum over its group of query heads;
  - `backward` adds delta = rowsum(dO * O) in fp32 (plain torch, as JAX
    leaves it to XLA) and runs both;
  - `flash_attention_train`, a `torch.autograd.Function` whose forward
    saves (q, k, v, out, lse, kv_valid_len), as `_flash_train_fwd` does.

The bf16 forward runs `csrc/flash_fwd_sm90.cu`, the kernel of
`flash.flash_attention`, with the lse epilogue (at head dim 256 the wide
kernel of `csrc/flash_fwd_wide_sm90.cu`, as #1 takes it there). The bf16
backward runs `csrc/flash_bwd_sm90.cu` (TMA and wgmma) over a work list
built here once per shape (`work_list`): items of (batch, query head,
tile), longest loop first (the causal forward takes dQ's list at its own
tiles). dK/dV items write each query head's fp32 partials, which a second
kernel sums over the group in head order (`backward_dkv_partials_reference`
and `group_sum` are their plain versions); at head dim 256 a dK/dV item's
two consumer warpgroups each hold one half of the columns and share the
scores of its 32-row query tiles. fp32 runs every product on the tensor
cores in 3xTF32: the forward is #1's fp32 kernel (`csrc/flash_fwd.cu`)
with its lse epilogue, the backward `csrc/flash_train.cu` over work lists
of its own tiles (`backward_tiles`), dK/dV with the same per-head
partials and group sum.

Each kernel wrapper takes its plain version (`*_reference`) only for
tensors on the CPU. For CUDA tensors it launches its kernel (bf16 or fp32,
head dims `TRAIN_HEAD_DIMS`) or raises, and counts the call in
`.launches`. Head dim 256 (Gemma's LM) goes through wrappers of its own,
`forward_with_lse_d256`, `backward_dq_d256` and `backward_dkv_d256`, which
the three entry points reach at that head dim, so that a run counts those
launches apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from memory_augmented_vlm_torch.ops import cuda_lib
from memory_augmented_vlm_torch.ops.flash import (_KERNEL_DTYPES, D256, LOG2E, MASK_VALUE,
                                                  _check_kernel_args, _shapes, attention_mask,
                                                  forward_plan, map_strides, online_softmax)

TRAIN_HEAD_DIMS = (64, 128, D256)
# Tiles of the bf16 backward kernels (`csrc/flash_bwd_sm90.cu`, checked
# against its `flash_bwd_tiles` when a list first goes to the card): a dQ
# item takes 64 query rows (128 at head dims 128 and 256, two warpgroups
# of 64 rows sharing each staged K/V tile) and loops over 64-key tiles; a
# dK/dV item takes 128 keys (64 at head dims 128 and 256) and loops over
# 64-row query tiles (32-row at 256, whose stages of qs, dO and q fit
# three to a block beside K and V).
DQ_BLOCK_K = 64
_DQ_BLOCK_Q = {64: 64, 128: 128, D256: 128}
_DKV_BLOCK_K = {64: 128, 128: 64, D256: 64}
_DKV_BLOCK_Q = {64: 64, 128: 64, D256: 32}
# Tiles of the fp32 backward kernels (`csrc/flash_train.cu`, checked against
# its `flash_bwd_f32_tiles`): an item takes 16-row warps' rows, 64 (32 at
# head dim 256) query rows for dQ or keys for dK/dV, and loops over tiles
# of 32 keys or query rows.
F32_TILE = 32
_F32_BLOCK_ROWS = {64: 64, 128: 64, D256: 32}


def dq_block_q(head_dim: int) -> int:
    return _DQ_BLOCK_Q[head_dim]


def dkv_block_k(head_dim: int) -> int:
    return _DKV_BLOCK_K[head_dim]


def dkv_block_q(head_dim: int) -> int:
    return _DKV_BLOCK_Q[head_dim]


def backward_tiles(head_dim: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(dQ item rows, dQ key tile, dK/dV query tile, dK/dV item keys) of the
    backward kernels at `dtype`: the bf16 kernels' or the fp32 ones'."""
    if dtype == torch.float32:
        rows = _F32_BLOCK_ROWS[head_dim]
        return rows, F32_TILE, F32_TILE, rows
    return dq_block_q(head_dim), DQ_BLOCK_K, dkv_block_q(head_dim), dkv_block_k(head_dim)


def _repeat(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def _scaled_scores(q, k, scale, kv_groups):
    """fp32 (B, H, Sq, Skv) scores of q * scale * log2(e) rounded to q's dtype."""
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    return torch.einsum("bqhd,bkhd->bhqk", qs, _repeat(k, kv_groups).float())


def forward_with_lse_reference(q, k, v, kv_valid_len, *, causal: bool, scale: float,
                               kv_groups: int = 1, block_k: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `forward_with_lse`: (out (B, Sq, H, D) in q's dtype,
    lse (B, H, Sq) fp32 in log2 units). `block_k=None` takes one tile over
    the whole key axis (P rounded against the final max); an integer runs
    the kernels' online softmax over tiles of `block_k` keys
    (`flash.online_softmax`), the function the TPU kernel and the bf16 CUDA
    kernel compute at that tile."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    if block_k is not None:
        qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
        o, m, l = online_softmax(qs, _repeat(k, kv_groups), _repeat(v, kv_groups),
                                 kv_valid_len, causal, block_k)
        return o.to(q.dtype), m + torch.log2(l.clamp_min(1e-30))
    mask = attention_mask(b, sq, skv, kv_valid_len, causal, q.device)
    s = _scaled_scores(q, k, scale, kv_groups).masked_fill(~mask, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                     _repeat(v, kv_groups).float())
    lse = m + torch.log2(l.clamp_min(1e-30))
    o = o / l.transpose(1, 2)[..., None]
    # a batch with no valid key runs no block on the TPU: out 0, lse -inf
    empty = (kv_valid_len.to(q.device) <= 0)
    o = o.masked_fill(empty[:, None, None, None], 0.0)
    lse = lse.masked_fill(empty[:, None, None], float("-inf"))
    return o.to(q.dtype), lse


def _probs(q, k, lse, kv_valid_len, causal, scale, kv_groups):
    """The backward's p = exp2(s - lse), fp32 (B, H, Sq, Skv), zero where
    masked."""
    b, sq, h, _ = q.shape
    mask = attention_mask(b, sq, k.shape[1], kv_valid_len, causal, q.device)
    p = torch.exp2(_scaled_scores(q, k, scale, kv_groups) - lse[..., None])
    return torch.where(mask, p, torch.zeros((), device=q.device))


def _dscores(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups):
    p = _probs(q, k, lse, kv_valid_len, causal, scale, kv_groups)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _repeat(v, kv_groups).float())
    return p, p * (dp - delta[..., None]) * scale


def backward_dq_reference(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool,
                          scale: float, kv_groups: int = 1) -> torch.Tensor:
    """Plain version of `backward_dq`: dQ (B, Sq, H, D) in q's dtype."""
    _, ds = _dscores(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      _repeat(k, kv_groups).float())
    return dq.to(q.dtype)


def backward_dkv_reference(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool,
                           scale: float, kv_groups: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `backward_dkv`: dK, dV (B, Skv, H // kv_groups, D)
    in k's and v's dtypes, each summed over its group in fp32."""
    p, ds = _dscores(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())

    def group_sum(x):
        b, skv, h, d = x.shape
        return x.reshape(b, skv, h // kv_groups, kv_groups, d).sum(dim=3)

    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def group_sum(partials: torch.Tensor, kv_groups: int) -> torch.Tensor:
    """(B, H, Skv, D) per-head fp32 partials -> (B, Skv, H // kv_groups, D):
    the heads of each group summed in head order, as the bf16 dK/dV
    kernel's second pass sums them."""
    b, h, skv, d = partials.shape
    x = partials.reshape(b, h // kv_groups, kv_groups, skv, d)
    total = x[:, :, 0]
    for i in range(1, kv_groups):
        total = total + x[:, :, i]
    return total.transpose(1, 2)


def backward_dkv_partials_reference(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool,
                                    scale: float, kv_groups: int = 1
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of what the bf16 dK/dV kernel writes before its group
    sum: each query head's fp32 dK and dV, (B, H, Skv, D)."""
    p, ds = _dscores(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups)
    dv = torch.einsum("bhqk,bqhd->bhkd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk, dv


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dq_key_tiles(m: int, sq: int, skv: int, causal: bool, block_q: int,
                 block_k: int = DQ_BLOCK_K) -> range:
    """Key tiles the dQ kernel's loop visits for query tile `m` when every key
    is valid: all of them, or up to the diagonal's when causal. The kernel
    also stops at kv_valid_len, which lives on the card."""
    end = min(skv, (m + 1) * block_q) if causal else skv
    return range(_cdiv(end, block_k))


def dkv_query_tiles(n: int, sq: int, skv: int, causal: bool, block_q: int,
                    block_k: int) -> range:
    """Query tiles the dK/dV kernel's loop visits for key tile `n` when every
    key is valid: from the diagonal's tile when causal, to the last."""
    k0 = n * block_k
    if k0 >= skv:
        return range(0)
    return range(k0 // block_q if causal else 0, _cdiv(sq, block_q))


@functools.lru_cache(maxsize=32)
def work_list(kind: str, b: int, sq: int, skv: int, h: int, causal: bool, block_q: int,
              block_k: int) -> Tuple[Tuple[int, int, int], ...]:
    """The bf16 backward's work items, (batch, query head, tile), one block
    each: `kind` "dq" takes query tiles (its loop runs over `dq_key_tiles`),
    "dkv" key tiles (`dkv_query_tiles`). Longest loop first, so the blocks
    that run longest start first and short ones fill the tail; ties keep
    (tile, batch, head) order. Shapes only: the kernels cut each loop at
    kv_valid_len themselves."""
    if kind == "dq":
        tiles = _cdiv(sq, block_q)
        length = [len(dq_key_tiles(i, sq, skv, causal, block_q, block_k)) for i in range(tiles)]
    elif kind == "dkv":
        tiles = _cdiv(skv, block_k)
        length = [len(dkv_query_tiles(i, sq, skv, causal, block_q, block_k))
                  for i in range(tiles)]
    else:
        raise ValueError(f"work list kind is dq or dkv, not {kind!r}")
    items = [(bi, hi, i) for i in range(tiles) for bi in range(b) for hi in range(h)]
    return tuple(sorted(items, key=lambda item: -length[item[2]]))


_WORK_ITEMS = {}


def _work_items(kind, b, sq, skv, h, causal, d, device, dtype) -> torch.Tensor:
    """`work_list` as an (n, 3) int32 tensor on `device`, made once per shape,
    at the tiles of the `dtype` kernels (`backward_tiles`)."""
    want = backward_tiles(d, dtype)
    block_q, block_k = want[:2] if kind == "dq" else want[2:]
    key = (kind, b, sq, skv, h, causal, block_q, block_k, str(device))
    if key not in _WORK_ITEMS:
        tiles = [ctypes.c_int() for _ in range(4)]
        lib = cuda_lib.load()
        name = "flash_bwd_f32_tiles" if dtype == torch.float32 else "flash_bwd_tiles"
        cuda_lib.check(lib, getattr(lib, name)(d, *map(ctypes.byref, tiles)), name)
        if tuple(x.value for x in tiles) != want:
            raise RuntimeError(f"backward tiles {[x.value for x in tiles]} != {want}")
        items = work_list(kind, b, sq, skv, h, causal, block_q, block_k)
        _WORK_ITEMS[key] = torch.tensor(items, dtype=torch.int32, device=device).reshape(-1, 3)
    return _WORK_ITEMS[key]


def scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale * log2(e), rounded to q's dtype: the operand of the backward
    kernels' score products, made once per backward (one elementwise op)."""
    return q * (scale * LOG2E)


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _map_strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(*map_strides(x))


def _check_qs(q, qs):
    if (qs.shape != q.shape or qs.dtype != q.dtype or qs.device != q.device
            or qs.stride(3) != 1 or any(st % 8 for st in qs.stride()[:3]) or qs.data_ptr() % 16):
        raise ValueError("qs must have q's shape, dtype and device, with 16-byte rows")


def _check_train_args(q, k, v, kv_valid_len, d, *extra):
    _check_kernel_args(q, k, v, kv_valid_len, d)
    if d not in TRAIN_HEAD_DIMS:
        raise ValueError(f"training kernels take head dims {TRAIN_HEAD_DIMS}, got {d}")
    for name, x in extra:
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {q.device}")


def forward_with_lse(q, k, v, kv_valid_len, *, causal: bool, scale: float,
                     kv_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward that also returns lse; see `forward_with_lse_reference`.
    CUDA tensors launch `flash_fwd_lse`: bf16 runs `csrc/flash_fwd_sm90.cu`
    (one block per item of `flash.forward_plan`), fp32 the 3xTF32 kernel of
    `csrc/flash_fwd.cu` with its lse epilogue. Head dim 256 goes to
    `forward_with_lse_d256`."""
    if q.shape[-1] == D256:
        return forward_with_lse_d256(q, k, v, kv_valid_len, causal=causal, scale=scale,
                                     kv_groups=kv_groups)
    return _forward_with_lse(q, k, v, kv_valid_len, causal, scale, kv_groups, forward_with_lse)


def forward_with_lse_d256(q, k, v, kv_valid_len, *, causal: bool, scale: float,
                          kv_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """`forward_with_lse` at head dim 256 (Gemma's LM): bf16 CUDA tensors
    launch the wide kernel of `csrc/flash_fwd_wide_sm90.cu` with its lse
    epilogue (64-key tiles), fp32 the 3xTF32 kernel of `csrc/flash_fwd.cu`
    at 256 with its lse epilogue; counted in
    `forward_with_lse_d256.launches`."""
    if q.shape[-1] != D256:
        raise ValueError(f"forward_with_lse_d256 takes head dim {D256}, got {q.shape[-1]}")
    return _forward_with_lse(q, k, v, kv_valid_len, causal, scale, kv_groups,
                             forward_with_lse_d256)


def _forward_with_lse(q, k, v, kv_valid_len, causal, scale, kv_groups, counter):
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    if q.device.type == "cpu":
        return forward_with_lse_reference(q, k, v, kv_valid_len, causal=causal, scale=scale,
                                          kv_groups=kv_groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_train_args(q, k, v, kv_valid_len, d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out, lse
    lib = cuda_lib.load()
    rows, items = (forward_plan(b, sq, skv, h, d, causal, q.device) if q.dtype == torch.bfloat16
                   else (0, None))
    rc = lib.flash_fwd_lse(
        _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), kv_valid_len.data_ptr(), b, sq, skv, h, kv_groups, int(causal),
        _map_strides(q), _map_strides(k), _map_strides(v), _strides(out), scale, scale * LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream,
        None if items is None else items.data_ptr(), 0 if items is None else items.shape[0],
        rows)
    cuda_lib.check(lib, rc, "flash_fwd_lse")
    counter.launches += 1
    return out, lse


forward_with_lse.launches = 0
forward_with_lse_d256.launches = 0


def _backward_args(q, k, v, dout, lse, delta, kv_groups, causal):
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    if tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"dout must be {tuple(q.shape)}, got {tuple(dout.shape)}")
    if tuple(lse.shape) != (b, h, sq) or tuple(delta.shape) != (b, h, sq):
        raise ValueError(f"lse and delta must be {(b, h, sq)}")
    return b, sq, skv, h, d


def _check_dout(q, dout):
    if dout.dtype != q.dtype or dout.device != q.device or not dout.is_contiguous():
        raise ValueError("dout must be contiguous, with q's dtype and device")


def backward_dq(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool, scale: float,
                kv_groups: int = 1, qs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ; see `backward_dq_reference`. CUDA tensors launch
    `flash_bwd_dq_sm90` (bf16; `qs`, the `scaled_q` of q, is made here unless
    given) or `flash_bwd_dq` (fp32). Head dim 256 goes to
    `backward_dq_d256`."""
    if q.shape[-1] == D256:
        return backward_dq_d256(q, k, v, dout, lse, delta, kv_valid_len, causal=causal,
                                scale=scale, kv_groups=kv_groups, qs=qs)
    return _backward_dq(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                        backward_dq)


def backward_dq_d256(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool, scale: float,
                     kv_groups: int = 1, qs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`backward_dq` at head dim 256: bf16 CUDA tensors launch
    `flash_bwd_dq_sm90` at 256 (128-row items, two warpgroups each holding
    its 64 x 256 accumulator), fp32 the 3xTF32 kernel at 256; counted in
    `backward_dq_d256.launches`."""
    if q.shape[-1] != D256:
        raise ValueError(f"backward_dq_d256 takes head dim {D256}, got {q.shape[-1]}")
    return _backward_dq(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                        backward_dq_d256)


def _backward_dq(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                 counter):
    b, sq, skv, h, d = _backward_args(q, k, v, dout, lse, delta, kv_groups, causal)
    if q.device.type == "cpu":
        return backward_dq_reference(q, k, v, dout, lse, delta, kv_valid_len, causal=causal,
                                     scale=scale, kv_groups=kv_groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_train_args(q, k, v, kv_valid_len, d, ("lse", lse), ("delta", delta))
    _check_dout(q, dout)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or sq == 0:
        return dq
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    items = _work_items("dq", b, sq, skv, h, causal, d, q.device, q.dtype)
    if q.dtype == torch.bfloat16:
        qs = scaled_q(q, scale) if qs is None else qs
        _check_qs(q, qs)
        rc = lib.flash_bwd_dq_sm90(
            d, qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), kv_valid_len.data_ptr(), items.data_ptr(),
            items.shape[0], b, sq, skv, h, kv_groups, int(causal), _map_strides(qs),
            _map_strides(k), _map_strides(v), _map_strides(dout), _strides(dq), scale, stream)
        cuda_lib.check(lib, rc, "flash_bwd_dq_sm90")
    else:
        rc = lib.flash_bwd_dq(
            _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            kv_valid_len.data_ptr(), items.data_ptr(), items.shape[0], b, sq, skv, h, kv_groups,
            int(causal), _map_strides(q), _map_strides(k), _map_strides(v), _map_strides(dout),
            _strides(dq), scale, scale * LOG2E, stream)
        cuda_lib.check(lib, rc, "flash_bwd_dq")
    counter.launches += 1
    return dq


backward_dq.launches = 0
backward_dq_d256.launches = 0


def backward_dkv(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool, scale: float,
                 kv_groups: int = 1, qs: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV; see `backward_dkv_reference`. CUDA tensors launch
    `flash_bwd_dkv_sm90` (bf16) or `flash_bwd_dkv` (fp32), each writing
    per-head fp32 partials into a scratch, then the group sum; one counted
    call. Head dim 256 goes to `backward_dkv_d256`."""
    if q.shape[-1] == D256:
        return backward_dkv_d256(q, k, v, dout, lse, delta, kv_valid_len, causal=causal,
                                 scale=scale, kv_groups=kv_groups, qs=qs)
    return _backward_dkv(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                         backward_dkv)


def backward_dkv_d256(q, k, v, dout, lse, delta, kv_valid_len, *, causal: bool, scale: float,
                      kv_groups: int = 1, qs: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`backward_dkv` at head dim 256: bf16 CUDA tensors launch
    `flash_bwd_dkv_sm90` at 256 (one block per 64-key item, two warpgroups
    each holding one half of the columns, then the group sum), fp32 the
    3xTF32 kernel at 256; counted in `backward_dkv_d256.launches`."""
    if q.shape[-1] != D256:
        raise ValueError(f"backward_dkv_d256 takes head dim {D256}, got {q.shape[-1]}")
    return _backward_dkv(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                         backward_dkv_d256)


def _backward_dkv(q, k, v, dout, lse, delta, kv_valid_len, causal, scale, kv_groups, qs,
                  counter):
    b, sq, skv, h, d = _backward_args(q, k, v, dout, lse, delta, kv_groups, causal)
    if q.device.type == "cpu":
        return backward_dkv_reference(q, k, v, dout, lse, delta, kv_valid_len, causal=causal,
                                      scale=scale, kv_groups=kv_groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_train_args(q, k, v, kv_valid_len, d, ("lse", lse), ("delta", delta))
    _check_dout(q, dout)
    dk = torch.empty((b, skv, h // kv_groups, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if b == 0 or skv == 0:
        return dk, dv
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    items = _work_items("dkv", b, sq, skv, h, causal, d, q.device, q.dtype)
    part = torch.empty((2, b, h, skv, d), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        qs = scaled_q(q, scale) if qs is None else qs
        _check_qs(q, qs)
        rc = lib.flash_bwd_dkv_sm90(
            d, qs.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            dk.data_ptr(), dv.data_ptr(), kv_valid_len.data_ptr(), items.data_ptr(),
            items.shape[0], b, sq, skv, h, kv_groups, int(causal), _map_strides(qs),
            _map_strides(q), _map_strides(k), _map_strides(v), _map_strides(dout), _strides(dk),
            scale, stream)
        cuda_lib.check(lib, rc, "flash_bwd_dkv_sm90")
    else:
        rc = lib.flash_bwd_dkv(
            _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), dk.data_ptr(), dv.data_ptr(), kv_valid_len.data_ptr(),
            items.data_ptr(), items.shape[0], b, sq, skv, h, kv_groups, int(causal),
            _map_strides(q), _map_strides(k), _map_strides(v), _map_strides(dout), _strides(dk),
            scale, scale * LOG2E, stream)
        cuda_lib.check(lib, rc, "flash_bwd_dkv")
    counter.launches += 1
    return dk, dv


backward_dkv.launches = 0
backward_dkv_d256.launches = 0


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, Sq)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def backward(q, k, v, out, lse, dout, kv_valid_len, *, causal: bool, scale: float,
             kv_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) from the saved forward residuals, as `_backward`."""
    dout = dout.contiguous()
    delta = attention_delta(out, dout)
    kw = dict(causal=causal, scale=scale, kv_groups=kv_groups)
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        kw["qs"] = scaled_q(q, scale)  # one pass, read by both kernels
    dq = backward_dq(q, k, v, dout, lse, delta, kv_valid_len, **kw)
    dk, dv = backward_dkv(q, k, v, dout, lse, delta, kv_valid_len, **kw)
    return dq, dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len, causal, scale, kv_groups):
        out, lse = forward_with_lse(q, k, v, kv_valid_len, causal=causal, scale=scale,
                                    kv_groups=kv_groups)
        ctx.save_for_backward(q, k, v, out, lse, kv_valid_len)
        ctx.opts = dict(causal=causal, scale=scale, kv_groups=kv_groups)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse, kv_valid_len = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, grad_out, kv_valid_len, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid_len: Optional[torch.Tensor] = None, *, causal: bool = True,
                          scale: Optional[float] = None, kv_groups: int = 1) -> torch.Tensor:
    """Differentiable flash attention (JAX `flash_attention_train`): q (B, Sq,
    H, D), k/v (B, Skv, H // kv_groups, D), kv_valid_len (B,) int (None =
    every key valid). Forward through `forward_with_lse`, backward through
    `backward_dq` and `backward_dkv`."""
    b, sq, skv, h, d = _shapes(q, k, v, kv_groups, causal)
    scale = d ** -0.5 if scale is None else scale
    if kv_valid_len is None:
        kv_valid_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    kv_valid_len = kv_valid_len.to(device=q.device, dtype=torch.int32)
    return _FlashAttentionTrain.apply(q, k, v, kv_valid_len, causal, scale, kv_groups)
