"""Argument checks shared by the int8 kernel wrappers (`qkv_int8`,
`mlp_int8`, `swiglu_int8`, `pallas_int8`, `flash`'s fused out-projection):
what `csrc/int8_gemm.cuh` takes and nothing else."""

from __future__ import annotations

import torch

# the `dtype` argument of the int8 kernels' C entries
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def check_cuda(x: torch.Tensor, name: str) -> None:
    """A contiguous bf16/fp32 CUDA activation whose rows are 16-byte vectors."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: the int8 kernels run on cpu or cuda")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.shape[-1] % 16:
        raise ValueError(f"{name}'s row length {x.shape[-1]} is not a multiple of 16")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on 16 bytes")


def check_weight(w: torch.Tensor, k: int, n: int, device) -> None:
    """An int8 (K, N) kernel stored column-major (each column's K values
    contiguous, 16-byte aligned), on `device`."""
    if w.dtype != torch.int8:
        raise TypeError(f"int8 kernel expected, got {w.dtype}")
    if tuple(w.shape) != (k, n):
        raise ValueError(f"kernel must be ({k}, {n}), got {tuple(w.shape)}")
    if w.device != device:
        raise ValueError(f"kernel is on {w.device}, activations on {device}")
    if w.stride() != (1, k):
        raise ValueError("int8 kernel must be column-major (quant.column_major)")
    if k % 16 or w.data_ptr() % 16:
        raise ValueError(f"kernel depth {k} must be a multiple of 16, 16-byte aligned")


def f32_vector(t: torch.Tensor, n: int, device, name: str) -> torch.Tensor:
    """An (n,) fp32 contiguous copy (or the tensor itself) on `device`."""
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, activations on {device}")
    return t.to(torch.float32).contiguous()
