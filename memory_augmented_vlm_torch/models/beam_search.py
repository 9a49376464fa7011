"""Beam search decode (counterpart of
`memory_augmented_vlm_tpu/models/beam_search.py`): the HF `GenerationMixin`
beam path of the reference's `generate` surface.

Semantics of HF beam search with early stopping:
  - the prefill's top 2K candidates seed the beams (the first step draws
    from one distribution, scores = log-probs);
  - each step ranks the K*V continuations, takes the top 2K candidates,
    moves eos candidates among the first K ranks into a K-slot finished
    pool (score = sum of log-probs / length ** length_penalty), and keeps
    the best K non-eos candidates as running beams (the 2K split keeps K
    survivors whatever the eos);
  - the search stops when the pool holds K hypotheses, every candidate of
    a step hit a stop sequence, or max_new_tokens is reached; the running
    beams then compete with the pool only if it is not full (HF's
    finalize);
  - stop sequences act as eos, and the best beam is cut on the host after
    the first completed stop sequence.

Beam sampling (`do_sample=True`) warps the per-beam log-probs (temperature,
top-k, top-p) before the running scores are added and draws the 2K
candidates without replacement by Gumbel top-k, in draw order; the
uniforms come from a `torch.Generator` or from the caller (the tests pass
JAX's). Every top-k here is a stable descending sort, so ties go to the
lower index as with `jax.lax.top_k`: on ties that decides which beams
survive, and `torch.topk` promises no order among them.

The loop runs eagerly; the host reads the stopping condition once a step.
The KV cache holds K rows; each step gathers it by parent beam into a
second buffer of the same shape and swaps the two, so no cache is
allocated per step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, sampling

# "no candidate": must rank below any real score. Beam sampling's scores
# compound by 1/temperature a step, so at tiny temperatures real scores
# reach ~-1e33: only -inf is safely below them (not sampling.NEG_INF)
NEG_INF = -float("inf")


def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k on a 1-d tensor: the k largest, descending, the lower
    index first among equal values. (values, int64 indices)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def _length_norm(scores: torch.Tensor, length: int, length_penalty: float) -> torch.Tensor:
    """scores / length ** length_penalty, the power taken in fp32 as JAX does."""
    base = torch.full((), float(length), dtype=torch.float32, device=scores.device)
    return scores / base ** length_penalty


def beam_search(params, cfg: VLMConfig, inputs_embeds: torch.Tensor, *, num_beams: int = 4,
                max_new_tokens: int = 128, eos_token_ids: Sequence[int] = (151645,),
                length_penalty: float = 1.0, repetition_penalty: float = 1.0,
                stop_sequences: Sequence[Sequence[int]] = (), pad_to_multiple: int = 128,
                do_sample: bool = False, temperature: float = 1.0, top_p: float = 1.0,
                top_k: int = 0, rng: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """The best beam's generated ids (no prompt echo) for one spliced
    sequence inputs_embeds (S, H), truncated just after the first stop
    sequence, as numpy int32 (JAX `beam_search.beam_search`).

    The repetition penalty follows HF's beam path: it acts on the
    log-softmaxed scores, over the generated ids only. With `do_sample`, the
    Gumbel top-k draws take `uniforms[step]` (step 0: (V,), later (K*V,)
    fp32 in [1e-20, 1)) when given, else uniforms from `rng` (a
    torch.Generator on the embeddings' device; default seeded 0)."""
    lm = params["language_model"]
    k = num_beams
    dev, act_dtype = inputs_embeds.device, inputs_embeds.dtype
    s = inputs_embeds.shape[0]
    smax = -(-s // pad_to_multiple) * pad_to_multiple
    embeds = torch.nn.functional.pad(inputs_embeds, (0, 0, 0, smax - s))[None]
    track = repetition_penalty != 1.0
    track_kw = len(stop_sequences) > 0
    seqs, lens = sampling.pack_stop_sequences(stop_sequences)
    stop_seqs, stop_lens = torch.from_numpy(seqs).to(dev), torch.from_numpy(lens).to(dev)
    eos = torch.tensor(tuple(eos_token_ids), dtype=torch.int32, device=dev)
    if do_sample and uniforms is None and rng is None:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)

    def uniform(step, n):
        if uniforms is not None:
            return torch.as_tensor(uniforms[step]).to(dev, torch.float32)
        return torch.rand((n,), generator=rng, device=dev).clamp_min_(1e-20)

    def select2k(beam_scores, logp_rows, step):
        """2K candidates from running scores (R,) and processed log-probs
        (R, V): (scores (2K,), flat indices (2K,)), the top 2K of the
        accumulated scores, or 2K Gumbel top-k draws in draw order."""
        if do_sample:
            if temperature not in (0.0, 1.0):
                logp_rows = logp_rows / torch.full((), temperature, device=dev)
            logp_rows = sampling.apply_top_k(logp_rows, top_k)
            logp_rows = sampling.apply_top_p(logp_rows, top_p)
        acc = (beam_scores[:, None] + logp_rows).reshape(-1)
        if not do_sample:
            return _top_k(acc, 2 * k)
        # Gumbel top-k == multinomial without replacement over softmax(acc)
        gumbel = -torch.log(-torch.log(uniform(step, acc.shape[0])))
        _, idx = _top_k(acc + gumbel, 2 * k)
        return acc[idx], idx

    def is_eos(tok):
        return torch.any(tok[..., None] == eos, dim=-1)

    positions = torch.arange(smax, device=dev)[None]
    hidden, cache0 = qwen2.forward(lm, cfg.lm, embeds, positions,
                                   valid_len=torch.tensor([s], dtype=torch.int32, device=dev),
                                   cache_max_len=smax + max_new_tokens)
    logp0 = torch.log_softmax(qwen2.unembed(lm, hidden[:, s - 1:s])[0, 0], dim=-1)   # (V,)
    vocab = logp0.shape[0]

    # seed from the top 2K (or 2K sampled) of the prefill distribution: eos
    # candidates among the first K ranks go to the pool, the best K non-eos
    # candidates become the running beams
    cand_scores0, cand_idx0 = select2k(torch.zeros((1,), device=dev), logp0[None], 0)
    cand_tok0 = cand_idx0.to(torch.int32)
    cand_done0 = is_eos(cand_tok0)
    rank_lt_k = torch.arange(2 * k, device=dev) < k
    recent = None
    if track_kw:
        cand_recent0 = torch.full((2 * k, seqs.shape[1]), -1, dtype=torch.int32, device=dev)
        cand_recent0[:, -1] = cand_tok0
        cand_done0 = cand_done0 | sampling.stop_sequence_hit(
            cand_recent0, stop_seqs, stop_lens, torch.ones((2 * k,), dtype=torch.int32,
                                                             device=dev))
    pool_cand0 = torch.where(cand_done0 & rank_lt_k, _length_norm(cand_scores0, 1,
                                                                  length_penalty), NEG_INF)
    fin_scores, fin_sel0 = _top_k(torch.cat([torch.full((k,), NEG_INF, device=dev),
                                             pool_cand0]), k)
    first_col = torch.zeros((2 * k, max_new_tokens), dtype=torch.int32, device=dev)
    first_col[:, 0] = cand_tok0
    fin_tokens = torch.cat([torch.zeros((k, max_new_tokens), dtype=torch.int32, device=dev),
                            first_col])[fin_sel0]
    scores, run_sel0 = _top_k(torch.where(cand_done0, NEG_INF, cand_scores0), k)
    first_tok = cand_tok0[run_sel0]
    tokens = torch.zeros((k, max_new_tokens), dtype=torch.int32, device=dev)
    tokens[:, 0] = first_tok
    beams = torch.arange(k, device=dev)
    if track:
        presence = torch.zeros((k, vocab), dtype=torch.bool, device=dev)
        presence[beams, first_tok.long()] = True
    if track_kw:
        recent = cand_recent0[run_sel0]
        all_cand_done = cand_done0.all()

    # the cache at K rows, and a second buffer each step gathers into
    cur = qwen2.KVCache(cache0.k.repeat(1, k, 1, 1, 1), cache0.v.repeat(1, k, 1, 1, 1),
                        cache0.length.repeat(k))
    spare = qwen2.KVCache(torch.empty_like(cur.k), torch.empty_like(cur.v), cur.length)
    del cache0
    pen = torch.full((), repetition_penalty, dtype=torch.float32, device=dev)

    def finished() -> bool:
        # early_stopping=True; HF's `valid_continuations` with stop sequences
        done = (fin_scores > NEG_INF).sum() >= k
        if track_kw:
            done = done | all_cand_done
        return bool(done)

    step = 1
    while step < max_new_tokens and not finished():
        emb = qwen2.embed_tokens(lm, tokens[:, step - 1][:, None].long(), cfg.lm).to(act_dtype)
        hidden, stepped = qwen2.decode_step(lm, cfg.lm, emb, cur)
        cur = cur._replace(length=stepped.length)
        logp = torch.log_softmax(qwen2.unembed(lm, hidden)[:, 0], dim=-1)   # (K, V)
        if track:
            logp = torch.where(presence, torch.where(logp < 0, logp * pen, logp / pen), logp)
        cand_scores, cand_idx = select2k(scores, logp, step)
        cand_beam = cand_idx // vocab
        cand_tok = (cand_idx % vocab).to(torch.int32)
        cand_tokens = tokens[cand_beam]
        cand_tokens[:, step] = cand_tok
        cand_done = is_eos(cand_tok)
        if track_kw:
            cand_recent = torch.cat([recent[cand_beam][:, 1:], cand_tok[:, None]], dim=1)
            cand_done = cand_done | sampling.stop_sequence_hit(
                cand_recent, stop_seqs, stop_lens,
                torch.full((2 * k,), step + 1, dtype=torch.int32, device=dev))
        # the finished pool takes eos candidates among the first K ranks,
        # scored at length step + 1
        cand_fin = torch.where(cand_done & rank_lt_k,
                               _length_norm(cand_scores, step + 1, length_penalty), NEG_INF)
        fin_scores, fin_sel = _top_k(torch.cat([fin_scores, cand_fin]), k)
        fin_tokens = torch.cat([fin_tokens, cand_tokens])[fin_sel]
        # running beams: the best K non-eos candidates, in rank order
        scores, run_sel = _top_k(torch.where(cand_done, NEG_INF, cand_scores), k)
        parent = cand_beam[run_sel]
        tokens = cand_tokens[run_sel]
        torch.index_select(cur.k, 1, parent, out=spare.k)
        torch.index_select(cur.v, 1, parent, out=spare.v)
        cur, spare = spare._replace(length=cur.length[parent]), cur
        if track:
            presence = presence[parent]
            presence[beams, cand_tok[run_sel].long()] = True
        if track_kw:
            recent = cand_recent[run_sel]
            all_cand_done = cand_done.all()
        step += 1

    # finalize: the running beams compete only when the pool is not full
    pool_full = (fin_scores > NEG_INF).sum() >= k
    run_fin = torch.where(pool_full, NEG_INF, _length_norm(scores, step, length_penalty))
    all_scores = torch.cat([fin_scores, run_fin])
    best_tokens = torch.cat([fin_tokens, tokens])[torch.argmax(all_scores)]
    eos_hits = is_eos(best_tokens)
    n = int(torch.argmax(eos_hits.to(torch.int32))) + 1 if bool(eos_hits.any()) else step
    out = best_tokens.cpu().numpy()[:n]
    # host-side cut at the earliest completed stop sequence, inclusive (the
    # greedy path's `num` counts the stop tokens too)
    for seq in stop_sequences:
        seq = list(seq)
        for end in range(len(seq) - 1, len(out)):
            if list(out[end - len(seq) + 1: end + 1]) == seq:
                out = out[: end + 1]
                break
    return out
