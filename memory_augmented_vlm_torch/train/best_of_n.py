"""Best-of-N sampling (counterpart of
`memory_augmented_vlm_tpu/train/best_of_n.py`, the capability of TRL's
`BestOfNSampler`, trl/extras/best_of_n_sampler.py:10-116): draw
`sample_size` stochastic completions per query in one batched decode, score
the decoded texts with a user callable, and keep the `n_candidates` best.

Semantics mirrored:
  - queries may be a single token list / 1-D array or a batch of them
    (best_of_n_sampler.py:88-99);
  - every candidate decodes the full sequence (query + completion) before
    scoring (best_of_n_sampler.py:103-110);
  - `length_sampler()` resamples `max_new_tokens` per query
    (best_of_n_sampler.py:106);
  - winners are ordered by descending score, ties in sample order (a
    stable sort).

The N samples run as one `(sample_size, S)` batch through
`vlm.generate_batched(do_sample=True)`, the query zero-padded to a multiple
of 128 rows, the decode length rounded up to JAX's 32-token bucket and the
counts trimmed back to the sampled length on the host (rows decode
independently, so the first max_new tokens are the same either way). The
Gumbel draws come from one `torch.Generator` seeded from `seed` on the
params' device, advanced by every call, where JAX splits its key per call.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, vlm


class LengthSampler:
    """Uniform [min, max) completion-length sampler (trl/core.py role)."""

    def __init__(self, min_value: int, max_value: int, seed: int = 0):
        if max_value <= min_value:
            raise ValueError("max_value must exceed min_value")
        self._rng = np.random.default_rng(seed)
        self.min_value, self.max_value = int(min_value), int(max_value)

    def __call__(self) -> int:
        return int(self._rng.integers(self.min_value, self.max_value))


QueryLike = Union[Sequence[int], np.ndarray, Sequence[Sequence[int]]]


class BestOfNSampler:
    def __init__(
        self,
        params,
        cfg: VLMConfig,
        queries_to_scores: Callable[[List[str]], List[float]],
        length_sampler: Callable[[], int],
        *,
        decode: Callable[[Sequence[int]], str],
        sample_size: int = 4,
        seed: Optional[int] = None,
        n_candidates: int = 1,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        eos_token_ids: Sequence[int] = (151645,),
    ) -> None:
        """`decode` plays the tokenizer's `batch_decode` role (one sequence
        of token ids -> text) so the sampler stays tokenizer-agnostic."""
        if sample_size < 1 or n_candidates < 1:
            raise ValueError("sample_size and n_candidates must be >= 1")
        if n_candidates > sample_size:
            raise ValueError("n_candidates cannot exceed sample_size")
        self.params = params
        self.cfg = cfg
        self.queries_to_scores = queries_to_scores
        self.length_sampler = length_sampler
        self.decode = decode
        self.sample_size = int(sample_size)
        self.n_candidates = int(n_candidates)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.eos_token_ids = tuple(int(t) for t in eos_token_ids)
        self._device = params["language_model"]["embed_tokens"].device
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(0 if seed is None else int(seed))

    @staticmethod
    def _as_query_batch(tokenized_query: QueryLike) -> List[np.ndarray]:
        """Normalize the reference's accepted query forms into a list of 1-D
        int32 arrays (best_of_n_sampler.py:88-99)."""
        arr = np.asarray(tokenized_query, dtype=object) \
            if isinstance(tokenized_query, (list, tuple)) else tokenized_query
        if isinstance(arr, np.ndarray) and arr.dtype != object:
            if arr.ndim == 1:
                return [arr.astype(np.int32)]
            if arr.ndim == 2:
                return [row.astype(np.int32) for row in arr]
            raise ValueError("queries must be 1-D or 2-D")
        # list input: either one query of ints or a batch of queries
        seq = list(tokenized_query)
        if not seq:
            raise ValueError("empty query")
        if isinstance(seq[0], (int, np.integer)):
            return [np.asarray(seq, np.int32)]
        return [np.asarray(q, np.int32) for q in seq]

    def generate(self, tokenized_query: QueryLike, **generation_kwargs) -> List[List[str]]:
        """Return, per query, the `n_candidates` highest-scoring decoded
        (query + completion) texts out of `sample_size` samples."""
        temperature = float(generation_kwargs.pop("temperature", self.temperature))
        top_p = float(generation_kwargs.pop("top_p", self.top_p))
        top_k = int(generation_kwargs.pop("top_k", self.top_k))
        if generation_kwargs:
            raise TypeError(f"unsupported generation kwargs: {sorted(generation_kwargs)}")

        lm = self.params["language_model"]
        results: List[List[str]] = []
        for query in self._as_query_batch(tokenized_query):
            max_new = int(self.length_sampler())
            max_new_bucket = max(32, ((max_new + 31) // 32) * 32)  # JAX's decode bucket
            ids = torch.as_tensor(query, dtype=torch.long, device=self._device)
            embeds = qwen2.embed_tokens(lm, ids, self.cfg.lm)
            s = embeds.shape[0]
            smax = ((s + 127) // 128) * 128
            batch = F.pad(embeds, (0, 0, 0, smax - s))[None].expand(
                self.sample_size, smax, embeds.shape[-1])
            out = vlm.generate_batched(
                self.params, self.cfg, batch,
                torch.full((self.sample_size,), s, dtype=torch.int32),
                max_new_tokens=max_new_bucket, eos_token_ids=self.eos_token_ids,
                do_sample=True, temperature=temperature, top_p=top_p, top_k=top_k,
                rng=self._gen)
            tokens = out.tokens.cpu().numpy()
            counts = np.minimum(out.num_tokens.cpu().numpy(), max_new)
            texts = [
                self.decode(list(query) + list(tokens[i, : counts[i]]))
                for i in range(self.sample_size)
            ]
            scores = np.asarray(self.queries_to_scores(texts), np.float64)
            if scores.shape != (self.sample_size,):
                raise ValueError("queries_to_scores must return one score per sample")
            best = np.argsort(-scores, kind="stable")[: self.n_candidates]
            results.append([texts[i] for i in best])
        return results
