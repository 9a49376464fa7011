"""Continuous-batching decode engine (counterpart of
`memory_augmented_vlm_tpu/serve/batch_engine.py`, the reference's
sglang-class worker: llava/serve/sglang_worker.py routes generation to a
runtime whose core is continuous batching).

Design (the device state lives in tensors the engine owns, on the device
of the weights):
  - a fixed pool of B slots over one batched KV cache (L, B, Smax, Hkv, Dh),
    or with `paged_page_size` a paged pool (`models/paged.py`);
  - `_prefill_into_slot`: the B = 1 prefill of a new request (through the
    flash kernel), its K/V written into the slot;
  - `_decode_step`: one token for every slot per call (per-row RoPE
    positions and cache lengths make ragged batches exact);
  - per-slot greedy, temperature and top-p sampling (`paged.sample_tokens`,
    JAX's pick), eos, stop sequences and max-token stopping on the host;
    finished slots take queued requests between ticks.

`submit` is thread-safe and takes numpy arrays; one engine thread owns
every device call and runs under `torch.inference_mode()`. A tick is
admit -> advance one chunk of a pending admission -> one decode call, and
reads the device once (the tokens, or the speculative step's packed
array); the host keeps its own copy of each slot's length, so nothing else
is read inside a tick. The tick runs eagerly.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import paged as paged_kv
from memory_augmented_vlm_torch.models import qwen2, vlm
from memory_augmented_vlm_torch.utils.logging import build_logger

logger = build_logger("batch_engine")

NOISE_SEED = 0  # the engine's sampling generator, as JAX's key(0)


def _act_dtype(lm) -> torch.dtype:
    """The activations' dtype: the embedding table's (an int8 LM keeps it
    float)."""
    return lm["embed_tokens"].dtype


def _prefill_into_slot(params, cfg: VLMConfig, embeds: torch.Tensor, valid_len: torch.Tensor,
                       slot: int, cache: qwen2.KVCache, *, max_len: int):
    """Prefill one request (embeds (1, Sp, H) right-padded) and write its
    K/V into `slot` of the batched cache, in place: all max_len positions,
    zeros past Sp, as JAX writes them. An int8 cache quantizes the rows per
    (position, head) on write. Returns (first logits row (V,), cache)."""
    logits, pre = vlm._prefill(params["language_model"], cfg, embeds, valid_len,
                               cache_max_len=max_len)
    k, v = pre.k[:, 0], pre.v[:, 0]
    if cache.k.dtype == torch.int8:
        (k, k_s), (v, v_s) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
        cache.k_scale[:, slot] = k_s
        cache.v_scale[:, slot] = v_s
    cache.k[:, slot] = k.to(cache.k.dtype)
    cache.v[:, slot] = v.to(cache.v.dtype)
    cache.length[slot] = valid_len[0]
    return logits[0], cache


def _prefill_chunk_into_slot(params, cfg: VLMConfig, emb_chunk: torch.Tensor, off: int,
                             chunk_valid: int, slot: int, cache: qwen2.KVCache, *,
                             max_len: int):
    """One chunk of a chunked (or prefix-cached suffix) prefill: C tokens at
    offset `off` of `slot`, attending to the slot's rows [0, off) and
    causally within the chunk (`qwen2.forward_chunk(row=slot)`, whose write
    window clamps into the cache as JAX's does: the engine caps C at
    max_len - off). emb_chunk (1, C, H) right-padded; `chunk_valid` valid
    rows (C for every chunk but the last). Returns (logits (V,) of the last
    valid row, cache with length[slot] = off + chunk_valid)."""
    del max_len  # JAX's dynamic-NTK basis; the port's RoPE has no scaling
    lm = params["language_model"]
    hidden, cache = qwen2.forward_chunk(lm, cfg.lm, emb_chunk, cache, off, row=slot)
    logits = paged_kv._last_logits(lm, hidden, chunk_valid - 1)
    cache.length[slot] = off + chunk_valid
    return logits, cache


def _spec_verify_step(params, cfg: VLMConfig, logits: torch.Tensor, drafts: torch.Tensor,
                      cache: qwen2.KVCache, active: torch.Tensor, *, max_len: int):
    """Batched speculative verification: one K-token forward for every slot
    (`qwen2.decode_chunk_batched`, per-row starts). Row b's chunk is
    [argmax(logits_b), drafts_b...], its head picked on the device; the
    longest prefix of drafts that the chunk's own greedy predictions match
    is accepted. Inactive rows start at max_len, so they write nothing.
    Unlike JAX's, whose `decode_chunk_batched` leaves out the final norm,
    the verified logits come after it. Returns (packed (B, 1 + K) int32 =
    [accepted count | chunk tokens], one array for one host read; next
    logits (B, V); cache with active lengths advanced by 1 + accepted)."""
    lm = params["language_model"]
    g0 = torch.argmax(logits, dim=-1).to(torch.int32)
    chunk_toks = torch.cat([g0[:, None], drafts.to(torch.int32)], dim=1)
    starts = torch.where(active, cache.length, max_len)
    emb = qwen2.embed_tokens(lm, chunk_toks.long(), cfg.lm).to(_act_dtype(lm))
    hidden, cache = qwen2.decode_chunk_batched(lm, cfg.lm, emb, cache, starts)
    logits_all = qwen2.unembed(lm, hidden)                       # (B, K, V)
    preds = torch.argmax(logits_all, dim=-1).to(torch.int32)
    n_acc = torch.cumprod((preds[:, :-1] == chunk_toks[:, 1:]).to(torch.int32), dim=1).sum(1)
    next_logits = torch.gather(
        logits_all, 1, n_acc.long()[:, None, None].expand(-1, 1, logits_all.shape[-1]))[:, 0]
    length = torch.where(active, cache.length + 1 + n_acc, cache.length).to(torch.int32)
    packed = torch.cat([n_acc[:, None].to(torch.int32), chunk_toks], dim=1)
    return packed, next_logits, cache._replace(length=length)


def _decode_step(params, cfg: VLMConfig, logits: torch.Tensor, cache: qwen2.KVCache,
                 active: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                 noise: Optional[torch.Tensor] = None, nucleus: bool = False):
    """One token for every slot (`paged.sample_tokens`'s pick; `noise`
    (B, V) Gumbel draws or None when no active slot samples). Inactive slots
    decode garbage into their own row at their length, which grows by one
    like every row's (a reused slot re-prefills its row): a row at the
    cache's bound writes nothing (`qwen2.decode_step`). Returns (tokens (B,)
    int32, next logits (B, V), cache)."""
    lm = params["language_model"]
    tok = paged_kv.sample_tokens(logits, active, temps, top_ps, noise, nucleus)
    emb = qwen2.embed_tokens(lm, tok[:, None].long(), cfg.lm).to(_act_dtype(lm))
    hidden, cache = qwen2.decode_step(lm, cfg.lm, emb, cache)
    return tok, qwen2.unembed(lm, hidden)[:, 0], cache


def _decode_multi_step(params, cfg: VLMConfig, logits: torch.Tensor, cache: qwen2.KVCache,
                       active: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                       noise: Optional[torch.Tensor] = None, nucleus: bool = False, *,
                       steps: int):
    """`steps` dependent decode steps in one call (multi-step scheduling):
    one host read per `steps` tokens. Tokens past a slot's close point are
    discarded on the host. `noise` is (steps, B, V) or None. Returns
    (tokens (B, steps), final logits, cache)."""
    toks = []
    for t in range(steps):
        tok, logits, cache = _decode_step(params, cfg, logits, cache, active, temps, top_ps,
                                          None if noise is None else noise[t], nucleus)
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, cache


def _lookup_draft(hist: list, n: int) -> Tuple[np.ndarray, bool]:
    """n proposal tokens for the positions after the next (still on the
    device) greedy token, and a hit flag. Keys on the corpus's last bigram
    (hist[-2], hist[-1]), the HF prompt-lookup scheme: if its last earlier
    match sits at j, the corpus predicts hist[j + 2] for the pending token
    and hist[j + 3:] for the draft positions. hit=False: nothing found, and
    the caller takes a plain tick instead of a verify forward."""
    out = np.zeros((n,), np.int32)
    if len(hist) < 2:
        return out, False
    a, b = hist[-2], hist[-1]
    for j in range(len(hist) - 4, -1, -1):
        if hist[j] == a and hist[j + 1] == b:
            cont = hist[j + 3:j + 3 + n]  # non-empty: j <= len - 4
            out[:len(cont)] = cont
            out[len(cont):] = cont[-1]
            return out, True
    return out, False


@dataclass
class _Request:
    embeds: np.ndarray            # (S, H) spliced sequence (the suffix when
                                  # use_prefix: the shared prefix goes first)
    max_new_tokens: int
    eos_ids: Tuple[int, ...]
    temperature: float
    top_p: float = 1.0
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    use_prefix: bool = False
    draft_ids: Tuple[int, ...] = ()   # prompt ids seeding the lookup corpus
    out: "queue.Queue[Optional[np.ndarray]]" = field(default_factory=queue.Queue)
    slot: int = -1
    emitted: int = 0
    recent: list = field(default_factory=list)     # the stop-sequence tail
    history: list = field(default_factory=list)    # the lookup corpus
    generated: list = field(default_factory=list)  # emitted tokens: what a
                                                   # preempted prompt grows by
    seq: int = -1                     # admission order (preemption takes
                                      # the youngest first)

    def hits_stop(self, tok: int) -> bool:
        if not self.stop_sequences:
            return False
        self.recent.append(tok)
        lmax = max(len(s) for s in self.stop_sequences)
        del self.recent[:-lmax]
        return any(len(self.recent) >= len(s) and tuple(self.recent[-len(s):]) == tuple(s)
                   for s in self.stop_sequences)


class BatchEngine:
    """Continuous-batching generation over a fixed slot pool, on the device
    of the weights. The constructor's arguments are JAX's."""

    def __init__(self, params, cfg: VLMConfig, *, num_slots: int = 4, max_len: int = 2048,
                 pad_to_multiple: int = 128, kv_int8: bool = False, chunk_prefill: int = 0,
                 speculative: int = 0, decode_ticks: int = 1, paged_page_size: int = 0,
                 paged_pages: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.pad = pad_to_multiple
        lm = params["language_model"]
        self._dtype = _act_dtype(lm)
        self.device = lm["embed_tokens"].device
        dev = self.device
        # paged_page_size = ps > 0: the KV cache is a paged pool of
        # `paged_pages` pages of ps positions, shared by the slots through
        # block tables. Below num_slots * max_len / ps pages the pool is
        # oversubscribed: admission waits for pages, and a decode-time
        # shortage preempts the youngest slot (its prompt and generated
        # tokens prefill again later: greedy output is unchanged). A shared
        # prefix installs its whole pages once; a partial last page is
        # copied per request.
        self.paged = int(paged_page_size)
        if self.paged:
            if kv_int8:
                raise ValueError("paged + kv_int8 not supported yet")
            if speculative:
                raise ValueError("paged + speculative not supported yet")
            if max_len % self.paged:
                raise ValueError("max_len must be a multiple of the page size")
            self.max_pages = max_len // self.paged
            npages = num_slots * self.max_pages if paged_pages is None else int(paged_pages)
            if npages < self.max_pages:
                raise ValueError(
                    "page pool smaller than one slot's worst case "
                    f"({npages} < {self.max_pages}): a lone request could exhaust it with "
                    "nothing left to preempt")
            self.num_pages = npages
            self._free: List[int] = list(range(npages))
            self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
            # table entries installed per slot (shared prefix and private):
            # the slot's rows cover _slot_npages[s] * page_size positions
            self._slot_npages: List[int] = [0] * num_slots
            self._admit_seq = 0
            self._requeue: "deque[_Request]" = deque()
            self._prefix_req: Optional[list] = None  # [rows, Event, error]
            self._perm_pages = 0   # pages held for good by shared prefixes
            # (prefix length, shared page ids, the full pages' rows for a
            # reinstall after a failure (L, full * ps, Hkv, D), the partial
            # page's rows (L, r, Hkv, D))
            self._prefix_pg: Optional[Tuple] = None
            self._cache = self._zero_pool()
        else:
            # kv_int8 halves the slot pool's cache (per-row int8,
            # qwen2.quantize_kv_rows)
            self._cache = qwen2.KVCache.zeros(cfg.lm, num_slots, max_len, dev,
                                              torch.int8 if kv_int8 else self._dtype)
        vocab = (lm["unembed_scale"] if "unembed_scale" in lm else lm["embed_tokens"]).shape[0]
        self._logits = torch.zeros((num_slots, vocab), dtype=torch.float32, device=dev)
        self._temps = torch.zeros((num_slots,), dtype=torch.float32, device=dev)
        self._topps = torch.ones((num_slots,), dtype=torch.float32, device=dev)
        # host copies of each slot's sampling settings: which slots sample
        # and whether any takes top-p, without a device read
        self._temp_host = [0.0] * num_slots
        self._topp_host = [1.0] * num_slots
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(NOISE_SEED)
        # decode_ticks = K > 1: multi-step scheduling, K dependent steps per
        # call; admissions and chunks wait at most K tokens
        self.decode_ticks = int(decode_ticks)
        if self.decode_ticks < 1:
            raise ValueError("decode_ticks must be >= 1")
        # speculative = K > 1: greedy ticks verify K tokens per slot in one
        # LM forward (prompt-lookup drafts from each request's history);
        # a tick with a sampled or near-max_len slot takes the plain step
        self.speculative = int(speculative)
        if self.speculative and self.speculative < 2:
            raise ValueError("speculative must be >= 2 tokens")
        # adaptive speculation: consecutive rounds that accept nothing start
        # a cooldown of plain ticks that doubles up to 32 (reset on any
        # acceptance)
        self._spec_zero_rounds = 0
        self._spec_cooldown = 0
        # chunk_prefill > 0: longer prompts prefill one chunk per tick
        self.chunk_prefill = int(chunk_prefill)
        # req, slot, next absolute offset, prompt base offset (prefix length)
        self._pending: Optional[Tuple[_Request, int, int, int]] = None
        # the shared prompt prefix (set_prefix), swapped as one tuple
        self._prefix: Optional[Tuple] = None
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slots: List[Optional[_Request]] = [None] * num_slots
        # the host's copy of each slot's cache length (set at activation,
        # advanced by each tick): no device read before a dispatch
        self._len: List[int] = [0] * num_slots
        # counters (read-only for callers; tokens / decode_forwards is the
        # mean accepted run)
        self.stats = {"decode_forwards": 0, "spec_forwards": 0, "tokens": 0,
                      "preemptions": 0, "decode_rounds": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _zero_pool(self) -> paged_kv.PagedKVCache:
        return paged_kv.PagedKVCache.zeros(self.cfg.lm, self.num_slots, self.max_len,
                                           page_size=self.paged, num_pages=self.num_pages,
                                           device=self.device, dtype=self._dtype)

    # -- public API ----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def set_prefix(self, embeds: np.ndarray):
        """Compute and keep a shared prompt prefix's K/V (e.g. the system
        prompt): one B = 1 prefill at positions 0..P-1 on the caller's
        thread; requests submitted with use_prefix=True take these rows and
        prefill only their suffix (prefix caching)."""
        with torch.inference_mode():
            emb = torch.as_tensor(np.asarray(embeds)).to(self.device, self._dtype)[None]
            p = emb.shape[1]
            if not 0 < p < self.max_len:
                raise ValueError(f"prefix length {p} out of range")
            _, pre = qwen2.forward(self.params["language_model"], self.cfg.lm, emb,
                                   torch.arange(p, device=self.device)[None])
            if self.paged:
                # the engine thread writes the pool in place: hand the rows
                # over and wait, so no write of this thread meets a tick's
                rows = (p, pre.k[:, 0, :p], pre.v[:, 0, :p])
                if self._thread is None or not self._thread.is_alive():
                    self._apply_prefix_pg(rows)
                    return
                handoff = [rows, threading.Event(), None]
                self._prefix_req = handoff
                if not handoff[1].wait(timeout=300):
                    raise TimeoutError("engine thread did not install prefix")
                if handoff[2] is not None:
                    raise handoff[2]
                return
            k, v = pre.k[:, :, :p], pre.v[:, :, :p]   # (L, 1, P, Hkv, Dh)
            ks = vs = None
            if self._cache.k.dtype == torch.int8:
                (k, ks), (v, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
            # one (len, rows...) tuple: _admit reads it in one step, so a
            # registration from another thread never pairs a new length
            # with old rows
            self._prefix = (p, k.to(self._cache.k.dtype), v.to(self._cache.v.dtype), ks, vs)

    # -- paged-pool management (the host's policy; models/paged.py is the
    # -- device side) ---------------------------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages off the free list; None (nothing taken) if short."""
        if n <= 0:
            return []
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _apply_prefix_pg(self, rows):
        """Install a shared prefix into pool pages (on the engine thread once
        it runs). Its whole pages are held for good and aliased by every
        prefix request's table (never freed, also on re-registration: an
        older request may still read them); the partial last page's rows
        are kept and copied into a fresh page per request."""
        p, k_rows, v_rows = rows
        ps = self.paged
        full, r = divmod(p, ps)
        if self.num_pages - (self._perm_pages + full) < self.max_pages:
            # a lone request without the prefix must still reach max_len
            # with the prefixes' pages held
            raise ValueError(
                "prefix would leave the pool unable to serve one worst-case "
                "request — raise paged_pages to >= max_pages + prefix pages")
        pages = self._alloc(full)
        if pages is None:
            raise ValueError("page pool too small for the prefix")
        self._perm_pages += full
        k_full = k_rows[:, :full * ps].to(self._cache.k.dtype)
        v_full = v_rows[:, :full * ps].to(self._cache.v.dtype)
        k_part = v_part = None
        if full:
            self._cache = paged_kv.write_prefix_pages(
                k_full, v_full, torch.tensor(pages, dtype=torch.int32, device=self.device),
                self._cache)
        if r:
            k_part = k_rows[:, full * ps:].to(self._cache.k.dtype)
            v_part = v_rows[:, full * ps:].to(self._cache.v.dtype)
        # the full pages' rows stay for the reinstall after a failure
        self._prefix_pg = (p, pages, k_full if full else None, v_full if full else None,
                           k_part, v_part)

    def _release_pages(self, slot: int):
        self._free.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_npages[slot] = 0

    def _preempt_one(self) -> Optional[int]:
        """Free pages by evicting work, youngest admission first (recompute
        preemption): the victim's prompt grows by its generated tokens and
        it goes to the front of the queue, so greedy output is what an
        uninterrupted run gives; sampled requests draw their remaining
        tokens again. Aborts the in-flight chunked admission when it holds
        the only pages. Returns the freed slot, or None."""
        victim = None
        for s, r in enumerate(self._slots):
            if r is None or (self._pending and r is self._pending[0]):
                continue
            if victim is None or r.seq > self._slots[victim].seq:
                victim = s
        if victim is None and self._pending is not None:
            req, slot, _off, _base = self._pending
            self._pending = None
            self._requeue.appendleft(req)
            self._slots[slot] = None
            req.slot = -1
            self._release_pages(slot)
            self.stats["preemptions"] += 1
            return slot
        if victim is None:
            return None
        req = self._slots[victim]
        if req.generated:
            ids = torch.tensor(req.generated, dtype=torch.long, device=self.device)
            gen = qwen2.embed_tokens(self.params["language_model"], ids, self.cfg.lm)
            req.embeds = np.concatenate(
                [req.embeds, gen.float().cpu().numpy().astype(req.embeds.dtype)])
            req.generated = []
        self._slots[victim] = None
        req.slot = -1
        self._requeue.appendleft(req)
        self._release_pages(victim)
        self.stats["preemptions"] += 1
        return victim

    def _install_pages(self, slot: int, pages: List[int]):
        """Append freshly taken pages to a slot's table row."""
        base = self._slot_npages[slot]
        self._cache.table[slot, base:base + len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self._slot_pages[slot].extend(pages)
        self._slot_npages[slot] += len(pages)

    def _ensure_headroom_pg(self, k: int) -> None:
        """Make every active slot's table cover its next k decode positions,
        preempting (youngest first, possibly the slot being grown, which
        then goes back to the queue) when the free list runs dry."""
        for slot in range(self.num_slots):
            req = self._slots[slot]
            if req is None or (self._pending and req is self._pending[0]):
                continue
            while self._slots[slot] is req and req.slot == slot:
                need = min(-(-(self._len[slot] + k) // self.paged), self.max_pages)
                short = need - self._slot_npages[slot]
                if short <= 0:
                    break
                pages = self._alloc(short)
                if pages is not None:
                    self._install_pages(slot, pages)
                    break
                if self._preempt_one() is None:
                    # unreachable given the pool-size invariant: fail loud
                    raise RuntimeError("page pool exhausted with nothing left to preempt")

    def submit(self, embeds: np.ndarray, *, max_new_tokens: int = 128,
               eos_token_ids: Tuple[int, ...] = (151645,), temperature: float = 0.0,
               top_p: float = 1.0, stop_sequences: Tuple[Tuple[int, ...], ...] = (),
               use_prefix: bool = False, draft_ids: Tuple[int, ...] = (),
               ) -> "queue.Queue[Optional[np.ndarray]]":
        """Queue a spliced sequence (S, H); returns a queue that yields
        int32 numpy token chunks and then None. top_p applies per row in the
        batched pick; stop sequences match on the host per token.
        use_prefix=True: `embeds` is the suffix after the prefix of
        set_prefix(). draft_ids: the prompt's token ids, the corpus of
        speculation's lookups (speculative=K)."""
        req = _Request(np.asarray(embeds), max_new_tokens, tuple(eos_token_ids),
                       float(temperature), float(top_p),
                       tuple(tuple(int(t) for t in s) for s in stop_sequences),
                       use_prefix=use_prefix, draft_ids=tuple(int(t) for t in draft_ids))
        req.history = list(req.draft_ids)
        self._queue.put(req)
        return req.out

    def generate(self, embeds, **kw) -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        out = self.submit(embeds, **kw)
        toks: List[np.ndarray] = []
        while True:
            item = out.get()
            if item is None:
                break
            toks.append(item)
        return np.concatenate(toks) if toks else np.zeros((0,), np.int32)

    # -- engine loop ----------------------------------------------------------
    def _activate(self, slot: int, req: _Request, logits_row: torch.Tensor, length: int):
        """Make a prefilled slot decode: its first logits and settings on the
        device, their host copies, its length."""
        self._logits[slot] = logits_row
        self._temps[slot] = req.temperature
        self._topps[slot] = req.top_p
        self._temp_host[slot] = req.temperature
        self._topp_host[slot] = req.top_p
        self._len[slot] = length

    def _set_table_row(self, slot: int, pages: List[int], total_pages: int, row=None):
        """Point a slot's table row at `row` (page ids; trash past them)."""
        if row is None:
            row = np.full((self.max_pages,), self.num_pages, np.int32)
            row[:total_pages] = pages
        self._cache.table[slot] = torch.from_numpy(row)
        self._slot_pages[slot] = pages
        self._slot_npages[slot] = total_pages

    def _admit_paged(self, req: _Request, slot: int) -> str:
        """Admission against the page pool. Takes all of the prompt's pages
        up front (a chunked admission then never allocates mid-flight);
        decode growth comes page by page in _ensure_headroom_pg. Returns
        "done" (slot active), "pending" (chunked or suffix prefill holds
        the slot), "stall" (too few free pages: retry after completions) or
        "rejected"."""
        prefix = self._prefix_pg if req.use_prefix else None
        base = prefix[0] if (req.use_prefix and prefix) else 0
        s = base + req.embeds.shape[0]
        if (req.embeds.ndim != 2 or req.embeds.shape[0] == 0 or s >= self.max_len
                or (req.use_prefix and prefix is None)):
            req.out.put(None)
            return "rejected"
        if req.seq < 0:
            req.seq = self._admit_seq
            self._admit_seq += 1
        ps = self.paged
        total_pages = -(-s // ps)
        if req.use_prefix:
            full = prefix[0] // ps
            pages = self._alloc(total_pages - full)
            if pages is None:
                return "stall"
            row = np.full((self.max_pages,), self.num_pages, np.int32)
            row[:full] = prefix[1]
            row[full:total_pages] = pages
            self._set_table_row(slot, pages, total_pages, row)
            if prefix[0] % ps:
                # copy-on-write: the prefix's partial last page goes into
                # this request's first own page; its suffix fills the rest
                self._cache = paged_kv.write_partial_page(prefix[4], prefix[5], pages[0],
                                                          self._cache)
            req.slot = slot
            self._slots[slot] = req
            self._pending = (req, slot, base, base)
            return "pending"
        pages = self._alloc(total_pages)
        if pages is None:
            return "stall"
        if self.chunk_prefill and s > self.chunk_prefill:
            self._set_table_row(slot, pages, total_pages)
            req.slot = slot
            self._slots[slot] = req
            self._pending = (req, slot, 0, 0)
            return "pending"
        # one-shot: pad the prompt to a (bucket, page) multiple; the pad
        # pages past the prompt's point at the trash page
        unit = math.lcm(self.pad, ps)
        sp = min(-(-s // unit) * unit, self.max_len)
        pages_arr = np.full((sp // ps,), self.num_pages, np.int32)
        pages_arr[:total_pages] = pages
        # claim the slot before the device call: if it raises, the loop's
        # reset releases this caller instead of stranding it
        self._slot_pages[slot] = pages
        self._slot_npages[slot] = total_pages
        req.slot = slot
        self._slots[slot] = req
        emb = F.pad(torch.as_tensor(req.embeds).to(self.device, self._dtype),
                    (0, 0, 0, sp - s))[None]
        logits_row, self._cache = paged_kv.prefill_into_pages(
            self.params, self.cfg, emb, torch.tensor([s], dtype=torch.int32, device=self.device),
            torch.from_numpy(pages_arr).to(self.device), slot, self._cache)
        self._activate(slot, req, logits_row, s)
        return "done"

    def _admit(self):
        if self._pending is not None:
            return  # finish the in-flight chunked admission first
        for slot in range(self.num_slots):
            if self._slots[slot] is not None:
                continue
            if self.paged and self._requeue:
                req = self._requeue.popleft()   # preempted work goes first
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
            if self.paged:
                state = self._admit_paged(req, slot)
                if state == "stall":
                    # too few free pages: keep the order and retry next tick
                    self._requeue.appendleft(req)
                    return
                if state == "pending":
                    return
                continue   # "done" or "rejected": try the next free slot
            try:
                # one read of the (len, rows) tuple: set_prefix may swap it
                prefix = self._prefix if req.use_prefix else None
                base = prefix[0] if req.use_prefix and prefix else 0
                s = base + req.embeds.shape[0]
                if (req.embeds.ndim != 2 or req.embeds.shape[0] == 0 or s >= self.max_len
                        or (req.use_prefix and prefix is None)):
                    # reject malformed, empty or oversized prompts (the
                    # caller gets the sentinel): s == max_len leaves no row
                    # for the first decode write, and an empty suffix no row
                    # to take the first logits from
                    req.out.put(None)
                    continue
                if req.use_prefix:
                    # install the prefix's rows; the suffix prefills as
                    # pending chunks from offset P
                    p, pk, pv, pks, pvs = prefix
                    c = self._cache
                    c.k[:, slot, :p] = pk[:, 0]
                    c.v[:, slot, :p] = pv[:, 0]
                    if pks is not None:
                        c.k_scale[:, slot, :p] = pks[:, 0]
                        c.v_scale[:, slot, :p] = pvs[:, 0]
                    c.length[slot] = base
                    req.slot = slot
                    self._slots[slot] = req
                    self._pending = (req, slot, base, base)
                    return
                if self.chunk_prefill and s > self.chunk_prefill:
                    # claim the slot; its chunks come one per tick between
                    # the other slots' decode steps
                    req.slot = slot
                    self._slots[slot] = req
                    self._pending = (req, slot, 0, 0)
                    return
                sp = min(-(-s // self.pad) * self.pad, self.max_len)
                emb = F.pad(torch.as_tensor(req.embeds).to(self.device, self._dtype),
                            (0, 0, 0, sp - s))[None]
                logits_row, self._cache = _prefill_into_slot(
                    self.params, self.cfg, emb,
                    torch.tensor([s], dtype=torch.int32, device=self.device), slot,
                    self._cache, max_len=self.max_len)
            except Exception:  # noqa: BLE001 — release this caller, keep serving
                logger.exception("batch-engine admit failed; request dropped")
                req.out.put(None)
                continue
            req.slot = slot
            self._slots[slot] = req
            self._activate(slot, req, logits_row, s)

    def _loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    self._tick()
                except Exception:  # noqa: BLE001 — never strand blocked callers
                    logger.exception("batch-engine step failed; resetting slots")
                    self._pending = None
                    for slot, req in enumerate(self._slots):
                        if req is not None:
                            req.out.put(None)
                            self._slots[slot] = None
                    if self.paged:
                        self._reset_paged()

    def _reset_paged(self):
        """Rebuild the page pool after a failed tick, whose writes may have
        left it in any state. Shared prefix pages are written again from
        their kept rows into their own page ids."""
        for r in self._requeue:
            r.out.put(None)
        self._requeue.clear()
        self._slot_pages = [[] for _ in range(self.num_slots)]
        self._slot_npages = [0] * self.num_slots
        held = set(self._prefix_pg[1]) if self._prefix_pg else set()
        self._free = [p for p in range(self.num_pages) if p not in held]
        self._perm_pages = len(held)  # leaked re-registrations come back here
        self._cache = self._zero_pool()
        if self._prefix_pg and self._prefix_pg[2] is not None:
            _p, pages, k_full, v_full, _kp, _vp = self._prefix_pg
            self._cache = paged_kv.write_prefix_pages(
                k_full, v_full, torch.tensor(pages, dtype=torch.int32, device=self.device),
                self._cache)

    def _advance_chunk(self):
        """Advance an in-flight chunked admission by one chunk. The slot's
        garbage decode row (an inactive slot still decodes into its row)
        lands at the next chunk's first position, which the chunk writes
        over; the chunk call sets length[slot] again."""
        if self._pending is None:
            return
        req, slot, off, base = self._pending
        try:
            s = base + req.embeds.shape[0]
            # the configured chunk, or (a prefix request with chunking off)
            # the whole suffix padded to the bucket; capped at max_len - off,
            # or the last padded chunk's write window would clamp backwards
            # over valid rows
            c = self.chunk_prefill or -(-(s - base) // self.pad) * self.pad
            c = min(c, self.max_len - off)
            chunk = req.embeds[off - base:off - base + c]
            cv = chunk.shape[0]
            emb = F.pad(torch.as_tensor(chunk).to(self.device, self._dtype),
                        (0, 0, 0, c - cv))[None]
            fn = paged_kv.chunk_into_pages if self.paged else _prefill_chunk_into_slot
            logits_row, self._cache = fn(self.params, self.cfg, emb, off, cv, slot, self._cache,
                                         **({} if self.paged else {"max_len": self.max_len}))
        except Exception:  # noqa: BLE001 — release this caller, keep serving
            logger.exception("batch-engine chunk prefill failed; dropped")
            req.out.put(None)
            self._slots[slot] = None
            self._pending = None
            if self.paged:
                self._release_pages(slot)
            return
        if off + cv >= s:
            # the last chunk: the slot decodes from the next tick
            self._pending = None
            self._activate(slot, req, logits_row, off + cv)
        else:
            self._pending = (req, slot, off + cv, base)

    def _emit_token(self, slot, req, t: int, length: int) -> bool:
        """Emit one token to the caller; True when the slot closed. eos is
        emitted and counted, as in vlm.generate's result."""
        done = t in req.eos_ids or req.hits_stop(t)
        req.out.put(np.asarray([t], np.int32))
        req.emitted += 1
        req.generated.append(t)
        self.stats["tokens"] += 1
        if done or req.emitted >= req.max_new_tokens or length >= self.max_len:
            req.out.put(None)
            self._slots[slot] = None
            if self.paged:
                # the retired slot's table row still names the freed pages,
                # but it is inactive (its writes go to the trash page) until
                # a prefill installs a new row
                self._release_pages(slot)
            return True
        return False

    def _pick_args(self, actives, steps: int):
        """(active mask, noise or None, nucleus) of a decode call: Gumbel
        draws (steps, B, V) from the engine's generator only when an active
        slot samples, and the top-p branch from the host copies."""
        active = torch.tensor(actives, device=self.device)
        samples = any(a and t > 0 for a, t in zip(actives, self._temp_host))
        noise = vlm.gumbel((steps, *self._logits.shape), self._gen) if samples else None
        return active, noise, not all(p >= 1.0 for p in self._topp_host)

    def _tick(self):
        if self.paged and self._prefix_req is not None:
            # the prefix install runs here, between ticks
            handoff = self._prefix_req
            self._prefix_req = None
            try:
                self._apply_prefix_pg(handoff[0])
            except Exception as e:  # noqa: BLE001 — raised again in set_prefix
                handoff[2] = e
            finally:
                handoff[1].set()
        self._admit()
        self._advance_chunk()
        pending_req = self._pending[0] if self._pending else None
        if all(r is None or r is pending_req for r in self._slots):
            if pending_req is None:
                self._stop.wait(0.01)  # idle: nothing admitted this round
            return
        actives = [r is not None and r is not pending_req for r in self._slots]
        if self.speculative and self._can_speculate(actives):
            if self._spec_cooldown > 0:
                self._spec_cooldown -= 1
            elif self._spec_tick(actives):
                return
            # no lookup hit on any slot (or cooling down): a plain tick
        want_multi = self._can_multi_tick(actives, pending_req)
        if self.paged:
            # grow the tables before the call; preemption may shrink the
            # active set (never grow it), so derive it again
            self._ensure_headroom_pg(self.decode_ticks if want_multi else 1)
            pending_req = self._pending[0] if self._pending else None
            actives = [r is not None and r is not pending_req for r in self._slots]
            if not any(actives):
                return
            want_multi = want_multi and self._can_multi_tick(actives, pending_req)
        k = self.decode_ticks if want_multi else 1
        active, noise, nucleus = self._pick_args(actives, k)
        self.stats["decode_forwards"] += k
        self.stats["decode_rounds"] += 1
        args = (self.params, self.cfg, self._logits, self._cache, active, self._temps,
                self._topps)
        if want_multi:
            fn = paged_kv.decode_multi_step_paged if self.paged else _decode_multi_step
            toks, self._logits, self._cache = fn(*args, noise, nucleus, steps=k)
        else:
            fn = paged_kv.decode_step_paged if self.paged else _decode_step
            tok, self._logits, self._cache = fn(*args, None if noise is None else noise[0],
                                                nucleus)
            toks = tok[:, None]
        toks = toks.cpu().numpy()  # (B, k): the tick's one read
        for slot, req in enumerate(self._slots):
            if req is None or req is pending_req:
                continue
            for t in toks[slot].tolist():
                req.history.append(int(t))
                self._len[slot] += 1
                if self._emit_token(slot, req, int(t), self._len[slot]):
                    break  # tokens past the close point are discarded

    def _can_multi_tick(self, actives, pending_req) -> bool:
        """Multi-step ticks need K rows of cache headroom on every active
        slot and must not starve an in-flight chunked admission (its chunks
        advance once per tick)."""
        if self.decode_ticks < 2 or pending_req is not None:
            return False
        return all(not actives[slot] or self._len[slot] + self.decode_ticks <= self.max_len
                   for slot in range(self.num_slots))

    def _can_speculate(self, actives) -> bool:
        """Speculative ticks are greedy only and need K rows of headroom per
        active slot (from the host's lengths: no device read)."""
        for slot, req in enumerate(self._slots):
            if not actives[slot]:
                continue
            if req.temperature > 0 or self._len[slot] + self.speculative > self.max_len:
                return False
        return True

    def _spec_tick(self, actives) -> bool:
        """One speculative round: K tokens verified per active slot in one
        batched forward, the drafts from each request's history. False
        (take a plain tick) when no slot's lookup hits."""
        k = self.speculative
        drafts = np.zeros((self.num_slots, k - 1), np.int32)
        any_hit = False
        for slot, req in enumerate(self._slots):
            if actives[slot]:
                drafts[slot], hit = _lookup_draft(req.history, k - 1)
                any_hit = any_hit or hit
        if not any_hit:
            return False
        self.stats["decode_forwards"] += 1
        self.stats["spec_forwards"] += 1
        self.stats["decode_rounds"] += 1
        packed, self._logits, self._cache = _spec_verify_step(
            self.params, self.cfg, self._logits, torch.from_numpy(drafts).to(self.device),
            self._cache, torch.tensor(actives, device=self.device), max_len=self.max_len)
        packed = packed.cpu().numpy()  # the round's one read: [n_acc | chunk tokens]
        n_acc, chunks = packed[:, 0], packed[:, 1:]
        total_accepted = 0
        for slot, req in enumerate(self._slots):
            if not actives[slot]:
                continue
            emitted = 1 + int(n_acc[slot])
            total_accepted += int(n_acc[slot])
            base_len = self._len[slot]
            self._len[slot] += emitted
            for i, t in enumerate(chunks[slot][:emitted].tolist()):
                req.history.append(int(t))
                # per-token length: the max_len close point of the plain tick
                if self._emit_token(slot, req, int(t), base_len + i + 1):
                    break
        if total_accepted == 0:
            self._spec_zero_rounds += 1
            if self._spec_zero_rounds >= 2:
                self._spec_cooldown = min(32, 2 ** (self._spec_zero_rounds - 1))
        else:
            self._spec_zero_rounds = 0
        return True
