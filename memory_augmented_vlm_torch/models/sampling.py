"""HF-parity logits processing for decode (counterpart of
`memory_augmented_vlm_tpu/models/sampling.py`).

The reference routes `generate()` through HF transformers' sampling stack,
whose active processors for the eval recipes are the repetition penalty,
temperature, top-k and top-p, plus `KeywordsStoppingCriteria` for
"until"-style stopping. The same semantics as plain torch functions on
(B, V) fp32 logits, with nothing read back to the host, so a CUDA graph
can capture them:

  - repetition penalty: tokens already emitted get their logit divided by
    `p` when positive, multiplied when negative, over a (B, V) presence
    mask (the prompt is never penalised: the reference passes embeddings);
  - top-k: keep the k highest logits. The k-th value comes from `topk`'s
    values, never its indices: `torch.topk` promises no order among ties
    where `jax.lax.top_k` puts the lower index first, and every logit equal
    to the k-th survives either way;
  - top-p: ascending sort, drop the tail whose cumulative probability is
    <= 1 - top_p, keeping at least one token. The first kept element of the
    sorted row is the threshold, so ties at it survive as they do in JAX;
  - keyword stopping: an (N, L) right-aligned comparison of each stop
    sequence against the last L generated tokens.

Masks use a large-but-finite NEG_INF so an fp32 softmax stays NaN-free.
Divisions by a Python float go through a 0-d tensor: PyTorch may evaluate
`x / 0.7` as a multiply by the reciprocal, JAX divides. `warp` takes the
settings as 0-d tensors, so one captured decode serves every setting.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor over a (B, V) presence mask;
    `penalty` a float or a 0-d fp32 tensor (1 changes nothing either way)."""
    if not isinstance(penalty, torch.Tensor):
        if penalty == 1.0:
            return logits
        penalty = _scalar(penalty, logits)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row (NEG_INF elsewhere)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF TopPLogitsWarper: remove the low-probability tail whose cumulative
    mass is <= 1 - top_p (ascending order), keeping at least one token."""
    if top_p >= 1.0:
        return logits
    asc = torch.sort(logits, dim=-1).values
    probs = torch.softmax(asc.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum > (1.0 - top_p)  # ascending: True once the tail mass is spent
    # threshold = smallest kept logit (argmax gives the first True);
    # everything strictly below it is removed
    first_kept = torch.argmax(keep.to(torch.int32), dim=-1, keepdim=True)
    threshold = torch.gather(asc, -1, first_kept)
    return torch.where(logits < threshold, NEG_INF, logits)


def process_logits(logits: torch.Tensor, presence: Optional[torch.Tensor], *,
                   temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                   repetition_penalty: float = 1.0) -> torch.Tensor:
    """HF processor order: repetition penalty -> temperature -> top-k -> top-p."""
    if repetition_penalty != 1.0 and presence is not None:
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    if temperature not in (0.0, 1.0):
        logits = logits / _scalar(temperature, logits)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def warp(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
         tail: torch.Tensor) -> torch.Tensor:
    """`process_logits`'s temperature, top-k and top-p with the settings as
    0-d tensors on the logits' device: `temperature` fp32 (1 divides
    exactly), `top_k` int64 (<= 0 or >= V keeps every logit), `tail` fp32,
    1 - top_p taken in the host's double and rounded, as JAX rounds it
    (<= 0 keeps every logit). One ascending sort serves both masks: the
    top-k threshold is its (V - k)-th element, and masking the elements
    below it keeps the row sorted, so it is top-p's sort of the masked row."""
    logits = logits / temperature
    v = logits.shape[-1]
    asc = torch.sort(logits, dim=-1).values
    at = (v - top_k.clamp(1, v)).expand(logits.shape[:-1] + (1,))
    kth = torch.gather(asc, -1, at)
    on_k = (top_k > 0) & (top_k < v)
    logits = torch.where(on_k & (logits < kth), NEG_INF, logits)
    asc = torch.where(on_k & (asc < kth), NEG_INF, asc)
    cum = torch.cumsum(torch.softmax(asc, dim=-1), dim=-1)
    first_kept = torch.argmax((cum > tail).to(torch.int32), dim=-1, keepdim=True)
    threshold = torch.gather(asc, -1, first_kept)
    return torch.where((tail > 0) & (logits < threshold), NEG_INF, logits)


def pack_stop_sequences(sequences: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack keyword token-id sequences into a right-aligned (N, L) int32 array
    (padded with -1 on the left) plus per-sequence lengths. Right alignment
    lets the decode loop compare against a single rolling tail buffer."""
    if not sequences:
        return np.zeros((0, 1), np.int32), np.zeros((0,), np.int32)
    lmax = max(len(s) for s in sequences)
    packed = np.full((len(sequences), lmax), -1, np.int32)
    lens = np.zeros((len(sequences),), np.int32)
    for i, s in enumerate(sequences):
        packed[i, lmax - len(s):] = np.asarray(s, np.int32)
        lens[i] = len(s)
    return packed, lens


def stop_sequence_hit(recent: torch.Tensor, stop_seqs: torch.Tensor, stop_lens: torch.Tensor,
                      n_generated: torch.Tensor) -> torch.Tensor:
    """recent: (B, L) rolling buffer of the last L tokens (-1 fill before any
    token exists). Returns (B,) bool: some stop sequence matches the tail.

    A sequence of length l only matches once at least l tokens were
    generated (KeywordsStoppingCriteria checks `output_ids.shape[1] >=
    len(keyword)`)."""
    if stop_seqs.shape[0] == 0:
        return torch.zeros(recent.shape[:1], dtype=torch.bool, device=recent.device)
    lmax = stop_seqs.shape[1]
    pos = torch.arange(lmax, device=recent.device)[None, :]  # (1, L)
    active = pos >= (lmax - stop_lens[:, None])               # (N, L) valid positions
    eq = recent[:, None, :] == stop_seqs[None, :, :]          # (B, N, L)
    match = torch.all(eq | ~active[None], dim=-1)             # (B, N)
    enough = n_generated[:, None] >= stop_lens[None, :]
    return torch.any(match & enough, dim=-1)
