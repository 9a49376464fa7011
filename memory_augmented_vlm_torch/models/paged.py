"""Paged KV cache for the continuous-batching engine (counterpart of
`memory_augmented_vlm_tpu/models/paged.py`: vLLM-class block tables).

  - one physical page pool per layer axis: `k`/`v` of shape
    (L, P + 1, page_size, Hkv, Dh). Page P (the last) is the trash page:
    writes routed there are garbage by construction (inactive slots,
    right-pad rows), so no write needs a branch on a device value;
  - per-slot block tables (B, max_pages) of physical page ids (unused
    entries point at the trash page), where max_pages * page_size is the
    engine's max_len. A slot's logical position p lives at
    (table[slot, p // page_size], p % page_size);
  - all placement policy (allocation, preemption, prefix sharing and
    copy-on-write) stays on the host in `serve/batch_engine.py`: the
    functions below only read the tables they are given.

Every function writes the pool, the tables and the lengths in place (JAX
returns updated copies; the engine never reads a cache in its old state)
and returns the cache beside its result, as JAX's do.

Decode gathers each slot's pages into a contiguous (B, max_len, Hkv, Dh)
view per layer and runs the plain `decode_attention`, and the chunk prefill
runs `mha_attention` under JAX's mask: both are plain XLA in JAX, not
Pallas kernels. The one-shot prefill goes through `qwen2.forward`, so
through the flash kernel (#1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from memory_augmented_vlm_torch.config import LMConfig, VLMConfig
from memory_augmented_vlm_torch.models import qwen2, vlm
from memory_augmented_vlm_torch.ops.attention import NEG_INF

# JAX's temperature floor: a sampled row divides its logits by max(t, this)
MIN_TEMPERATURE = 1e-4


class PagedKVCache(NamedTuple):
    """Page pool and block tables. `k`/`v`: (L, P + 1, page_size, Hkv, Dh),
    the last page the trash page; `table`: (B, max_pages) int32 physical
    page ids (unused -> trash); `length`: (B,) int32 valid logical
    positions per slot."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def trash(self) -> int:
        return self.k.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]

    @staticmethod
    def zeros(cfg: LMConfig, num_slots: int, max_len: int, *, page_size: int, num_pages: int,
              device, dtype=torch.bfloat16) -> "PagedKVCache":
        if max_len % page_size:
            raise ValueError("max_len must be a multiple of page_size")
        shape = (cfg.num_hidden_layers, num_pages + 1, page_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            table=torch.full((num_slots, max_len // page_size), num_pages, dtype=torch.int32,
                             device=device),
            length=torch.zeros((num_slots,), dtype=torch.int32, device=device))


def sample_tokens(logits: torch.Tensor, active: torch.Tensor, temps: torch.Tensor,
                  top_ps: torch.Tensor, noise: Optional[torch.Tensor],
                  nucleus: bool) -> torch.Tensor:
    """The engine's per-row pick (JAX `batch_engine._decode_step` and
    `paged.decode_step_paged`): the argmax where a row's temperature is 0,
    else the argmax of the warped logits plus `noise` (B, V), standard
    Gumbel draws — what `jax.random.categorical` computes. The warp divides
    by max(t, 1e-4) and, with `nucleus`, applies JAX's top-p: ascending
    sort, keep where the cumulative softmax exceeds 1 - top_p, the top
    token always kept, rows with top_p >= 1 untouched. The caller passes
    `nucleus` from its host copy of the rows' top_p (JAX's `cond` on all
    rows >= 1; either branch gives those rows the same logits) and `noise`
    None when no active row samples (the sampled pick is then unread).
    Inactive rows pick 0. int32 (B,)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if noise is None:
        return torch.where(active, greedy, 0)
    warped = logits / temps.clamp_min(MIN_TEMPERATURE)[:, None]
    if nucleus:
        asc = torch.sort(warped, dim=-1).values
        cum = torch.cumsum(torch.softmax(asc, dim=-1), dim=-1)
        keep = cum > (1.0 - top_ps)[:, None]
        keep[:, -1] = True
        first_kept = torch.argmax(keep.to(torch.int8), dim=-1)
        threshold = torch.gather(asc, 1, first_kept[:, None])
        warped = torch.where((warped < threshold) & (top_ps[:, None] < 1.0), NEG_INF, warped)
    sampled = torch.argmax(warped + noise, dim=-1).to(torch.int32)
    return torch.where(active, torch.where(temps > 0, sampled, greedy), 0)


def _last_logits(lm, hidden: torch.Tensor, row: int) -> torch.Tensor:
    """The fp32 logits (V,) of hidden[0, row]."""
    return qwen2.unembed(lm, hidden[:, row:row + 1])[0, 0]


def prefill_into_pages(params, cfg: VLMConfig, embeds: torch.Tensor, valid_len: torch.Tensor,
                       pages: torch.Tensor, slot: int, pcache: PagedKVCache, *,
                       rope_seq_len: Optional[int] = None):
    """One-shot prefill of a request into its allocated pages.

    embeds (1, Sp, H) right-padded to a page multiple; valid_len (1,) int32;
    pages (Sp / page_size,) int32 physical page ids of the prompt's logical
    pages in order (entries past the valid prompt may be the trash page:
    their rows are pad garbage). Writes the prompt's K/V into the pool,
    installs the slot's table row and sets length[slot]. Returns
    (first-token logits (V,) fp32, cache). `rope_seq_len` has no effect
    (`qwen2.forward_chunk` says why)."""
    del rope_seq_len
    sp = embeds.shape[1]
    ps = pcache.page_size
    logits, pre = vlm._prefill(params["language_model"], cfg, embeds, valid_len)
    n = sp // ps
    pages = pages.long()
    for dst, rows in ((pcache.k, pre.k), (pcache.v, pre.v)):
        dst[:, pages] = rows[:, 0, :sp].reshape(rows.shape[0], n, ps,
                                                *rows.shape[3:]).to(dst.dtype)
    pcache.table[slot] = pcache.trash
    pcache.table[slot, :n] = pages.to(torch.int32)
    pcache.length[slot] = valid_len[0]
    return logits[0], pcache


def _slot_kv(layer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The slots' logical (B, max_pages * page_size, Hkv, Dh) view of one
    layer's pool (P + 1, page_size, Hkv, Dh) through table (B, max_pages)."""
    b, mp = table.shape
    return layer[table].reshape(b, mp * layer.shape[1], *layer.shape[2:])


def chunk_into_pages(params, cfg: VLMConfig, emb_chunk: torch.Tensor, off: int,
                     chunk_valid: int, slot: int, pcache: PagedKVCache, *,
                     rope_seq_len: Optional[int] = None):
    """One chunk of a chunked or suffix prefill against the slot's paged
    prefix: C tokens at global offset `off` attend to logical rows
    [0, off) (gathered from the slot's pages) plus their own causal
    triangle, and their K/V go to the slot's pages. The pages covering
    [off, off + C) must be installed in the slot's table row already (the
    engine takes an admission's pages up front, and caps C at
    max_len - off, so a chunk row never leaves the table). Sets
    length[slot] = off + chunk_valid. Returns (logits (V,) of the last
    valid row, cache). `rope_seq_len` has no effect."""
    del rope_seq_len
    lm = params["language_model"]
    b, c, _ = emb_chunk.shape
    dev = emb_chunk.device
    ps = pcache.page_size
    max_len = pcache.max_pages * ps
    qpos = off + torch.arange(c, device=dev)
    mask = (torch.arange(max_len, device=dev)[None, :] <= qpos[:, None])[None, None]
    table_row = pcache.table[slot].long()
    w_pages = table_row[(qpos // ps).clamp_max(pcache.max_pages - 1)]
    w_offs = qpos % ps

    def write(li, k, v):
        for dst, new in ((pcache.k, k), (pcache.v, v)):
            dst[li, w_pages, w_offs] = new[0].to(dst.dtype)
        return tuple(_slot_kv(layer[li], table_row[None]).to(emb_chunk.dtype)
                     for layer in (pcache.k, pcache.v))

    hidden = qwen2._chunk_layers(lm, cfg.lm, emb_chunk, qpos[None].expand(b, c), mask, write)
    logits = _last_logits(lm, hidden, chunk_valid - 1)
    pcache.length[slot] = off + chunk_valid
    return logits, pcache


def decode_step_paged(params, cfg: VLMConfig, logits: torch.Tensor, pcache: PagedKVCache,
                      active: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                      noise: Optional[torch.Tensor] = None, nucleus: bool = False, *,
                      rope_seq_len: Optional[int] = None):
    """One token for every slot against the paged pool (the paged
    counterpart of `batch_engine._decode_step`, the same pick). Inactive
    slots' K/V go to the trash page and their length stays, so a freed
    slot's pages can serve another request at once. Returns (tokens (B,)
    int32, next logits (B, V) fp32, cache)."""
    del rope_seq_len
    lm = params["language_model"]
    tok = sample_tokens(logits, active, temps, top_ps, noise, nucleus)
    act_dtype = lm["embed_tokens"].dtype
    emb = qwen2.embed_tokens(lm, tok[:, None].long(), cfg.lm).to(act_dtype)
    ps = pcache.page_size
    pos = pcache.length.long()
    table = pcache.table.long()
    # an active slot's position is below max_len (the engine's close
    # invariant); an inactive one's may sit at it, and is clamped before
    # its write goes to the trash page
    w_pages = torch.gather(table, 1, (pos // ps).clamp_max(pcache.max_pages - 1)[:, None])[:, 0]
    w_pages = torch.where(active, w_pages, pcache.trash)
    w_offs = pos % ps

    def write(li, k, v):
        for dst, new in ((pcache.k, k), (pcache.v, v)):
            dst[li, w_pages, w_offs] = new.to(dst.dtype)
        return tuple(_slot_kv(layer[li], table).to(act_dtype) for layer in (pcache.k, pcache.v))

    hidden = qwen2._decode_layers(lm, cfg.lm, emb, pos, pcache.length + 1, write)
    new_logits = qwen2.unembed(lm, hidden)[:, 0]
    pcache.length.copy_(torch.where(active, pcache.length + 1, pcache.length))
    return tok, new_logits, pcache


def decode_multi_step_paged(params, cfg: VLMConfig, logits: torch.Tensor,
                            pcache: PagedKVCache, active: torch.Tensor, temps: torch.Tensor,
                            top_ps: torch.Tensor, noise: Optional[torch.Tensor] = None,
                            nucleus: bool = False, *, steps: int,
                            rope_seq_len: Optional[int] = None):
    """`steps` dependent paged decode steps (multi-step scheduling); the
    engine installs pages covering every active slot's next `steps`
    positions first. `noise` is (steps, B, V) or None. Returns (tokens
    (B, steps), final logits, cache)."""
    toks = []
    for t in range(steps):
        tok, logits, pcache = decode_step_paged(
            params, cfg, logits, pcache, active, temps, top_ps,
            None if noise is None else noise[t], nucleus, rope_seq_len=rope_seq_len)
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, pcache


def write_prefix_pages(prefix_k: torch.Tensor, prefix_v: torch.Tensor, pages: torch.Tensor,
                       pcache: PagedKVCache) -> PagedKVCache:
    """Install a shared prefix's full pages: prefix_k/v (L, n_full *
    page_size, Hkv, Dh) page-aligned rows into pages (n_full,). Table rows
    stay per request (the engine points each prefix admission at these
    shared, read-only pages)."""
    ps = pcache.page_size
    pages = pages.long()
    for dst, rows in ((pcache.k, prefix_k), (pcache.v, prefix_v)):
        dst[:, pages] = rows.reshape(rows.shape[0], pages.shape[0], ps,
                                     *rows.shape[2:]).to(dst.dtype)
    return pcache


def write_partial_page(rows_k: torch.Tensor, rows_v: torch.Tensor, page: int,
                       pcache: PagedKVCache) -> PagedKVCache:
    """Copy-on-write install of a prefix's partial trailing page: rows_k/v
    (L, r, Hkv, Dh), r < page_size, into rows [0, r) of physical page
    `page` (a request's own page; its suffix and decode rows fill the
    rest)."""
    r = rows_k.shape[1]
    pcache.k[:, page, :r] = rows_k.to(pcache.k.dtype)
    pcache.v[:, page, :r] = rows_v.to(pcache.v.dtype)
    return pcache
