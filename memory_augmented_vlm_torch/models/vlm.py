"""Video assembly of the full model (counterpart of the video path of
`memory_augmented_vlm_tpu/models/vlm.py`).

SigLIP tower -> mlp2x_gelu projector -> 2x2 bilinear pool -> temporal PE ->
recurrent memory -> memory fuser -> token-type embeds -> `one_token` merge
with the image newline -> prompt splice. Token accounting matches the
reference: 10 memory-prompt + nseg*8*196 memory + 1 newline + 9 frame-prompt
+ nfine*196 fine + 1 newline visual tokens; without the memory
(`add_token_per_frame`), 197 per frame.

The generation surface (JAX `vlm.py:240-727`) sits on top: `generate`,
`generate_batched`, `generate_stream`, `generate_speculative` and
`score_continuation`, with `video_qa_embeds` as the host entry from a
clip's frames to the spliced sequence they all take. See "Generation"
below for how decode runs on the card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import memory as memory_mod
from memory_augmented_vlm_torch.models import position_encoding
from memory_augmented_vlm_torch.models import projector as projector_mod
from memory_augmented_vlm_torch.models import qwen2, sampling, siglip
from memory_augmented_vlm_torch.ops.pooling import spatial_pool_2x2
from memory_augmented_vlm_torch.ops.preprocess import preprocess_frames


def sample_video_frames(num_frames: int) -> np.ndarray:
    """Frame re-sampling at fusion time (JAX `vlm.sample_video_frames`): under
    32 frames keep all; otherwise (F // 32) * 32, floored at 64, at
    `linspace(0, F - 1, n)` truncated to integers (`.long()`, not rounding)."""
    if num_frames < 32:
        return np.arange(num_frames, dtype=np.int64)
    n = max((num_frames // 32) * 32, 64)
    return np.linspace(0, num_frames - 1, n).astype(np.int64)


def fine_frame_indices(num_frames: int, num_samples: int = 32) -> np.ndarray:
    """Rounding linspace over the sampled frames, clamped."""
    n = min(num_samples, num_frames)
    idx = np.round(np.linspace(0, num_frames - 1, n))
    return np.clip(idx, 0, num_frames - 1).astype(np.int64)


def pad_frames_to_segment_multiple(f: int, segment: int = 32) -> int:
    return ((f + segment - 1) // segment) * segment


def init_params(cfg: VLMConfig, seed: int, device, dtype=torch.float32):
    """Seeded random init of the whole model at the configured widths, with
    the JAX init's shapes and distributions. Draws happen on `device` with a
    `torch.Generator` seeded from `seed`, in fp32, then cast to `dtype`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h = cfg.lm.hidden_size

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def lin(d_in, d_out):
        return {"kernel": normal(d_in, d_out, scale=0.02),
                "bias": torch.zeros(d_out, device=device, dtype=dtype)}

    return {
        "vision_tower": siglip.init_params(cfg.vision, gen, device, dtype),
        "mm_projector": projector_mod.init_params(cfg.vision.hidden_size, h, gen, device,
                                                  dtype),
        "language_model": qwen2.init_params(cfg.lm, gen, device, dtype),
        "memory": {
            "recurrent_memory_transformer": memory_mod.init_params(
                cfg.memory, gen, device, dtype),
            "memory_fuser": {"fc1": lin(h, 4 * h), "fc2": lin(4 * h, h)},
            "token_type_embedding": normal(2, h, scale=0.02),
            "image_newline": normal(h, scale=1.0 / np.sqrt(h)),
        },
        "positional_encoding": position_encoding.init_params(
            cfg.memory.max_temporal_frames, h, device, dtype),
    }


def encode_frames(params, cfg: VLMConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(F, 384, 384, 3) NHWC pixels -> (F, 196, H) pooled projected features.

    The tower and projector run under `torch.no_grad()`, so the features
    come back detached: JAX's `stop_gradient` after the projector (the
    reference detaches vision features in training too), and the frozen
    tower keeps no activations for a backward."""
    with torch.no_grad():
        feats = siglip.forward(params["vision_tower"], cfg.vision, pixels,
                               int8=cfg.pipeline.tower_int8)
        feats = projector_mod.forward(params["mm_projector"], feats)
        return spatial_pool_2x2(feats, cfg.vision.num_patches_per_side,
                                stride=cfg.pipeline.mm_spatial_pool_stride)


def _merge_frames(feature: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """`one_token` merge of a `spatial_unpad` model: flatten the (N, P, H)
    stream and append one image-newline row."""
    h = feature.shape[-1]
    return torch.cat([feature.reshape(-1, h), newline.reshape(1, h)], dim=0)


def _embed_ids(lm_params, ids, device) -> torch.Tensor:
    return qwen2.embed_tokens(lm_params, torch.as_tensor(ids, dtype=torch.long, device=device))


def build_video_embeds(params, cfg: VLMConfig, feats: torch.Tensor,
                       frame_indices: torch.Tensor, frame_valid: torch.Tensor,
                       fine_idx: torch.Tensor, nseg: int, *,
                       drop_fine_frames: bool = False) -> torch.Tensor:
    """Memory + fine-frame visual stream with prompts, newlines and
    token-type embeds: (10 + nseg*8*196 + 1 [+ 9 + nfine*196 + 1 unless
    drop_fine_frames], H). The prompt ids, the newline and the token-type
    embeds stay in the autograd graph, as they do in JAX.

    feats (Fmax, 196, H) pooled and padded; frame_indices (Fmax,) original
    frame indices for the temporal PE; frame_valid (Fmax,) host bool;
    fine_idx (nfine,) indices into the Fmax axis; nseg <= cache cap."""
    mcfg = cfg.memory
    dev = feats.device
    feats = position_encoding.add_temporal_pe(params["positional_encoding"], feats,
                                              frame_indices)
    state = memory_mod.run_video(params["memory"]["recurrent_memory_transformer"], mcfg,
                                 feats, frame_valid)
    fused, _ = memory_mod.fuse_memory_bank(params["memory"]["memory_fuser"], state)
    mem_tokens = fused[: nseg * mcfg.num_memory_tokens]
    tte = params["memory"]["token_type_embedding"]
    mem_tokens = mem_tokens + tte[0]
    newline = params["memory"]["image_newline"].to(mem_tokens.dtype)
    lm = params["language_model"]
    mem_prompt = _embed_ids(lm, constants.MEMORY_PROMPT_IDS, dev).to(mem_tokens.dtype)
    mem_stream = [mem_prompt, _merge_frames(mem_tokens, newline)]
    if drop_fine_frames:
        return torch.cat(mem_stream, dim=0)
    fine = feats[fine_idx.to(dev)] + tte[1]
    frame_prompt = _embed_ids(lm, constants.FRAME_PROMPT_IDS, dev).to(mem_tokens.dtype)
    return torch.cat([*mem_stream, frame_prompt, _merge_frames(fine, newline)], dim=0)


def add_token_per_frame(feature: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """The plain video branch without the memory (`bench.py --no_memory`;
    `mm_newline_position="frame"`): the image newline after every frame's
    pooled tokens. (N, P, H) -> (N*(P+1), H)."""
    n, _, h = feature.shape
    nl = newline.reshape(1, 1, h).to(feature.dtype).expand(n, 1, h)
    return torch.cat([feature, nl], dim=1).reshape(-1, h)


def splice_image_embeds(params, text_ids_before: torch.Tensor, visual: torch.Tensor,
                        text_ids_after: torch.Tensor) -> torch.Tensor:
    """Replace the single <image> sentinel with the visual stream (batch 1)."""
    lm = params["language_model"]
    before = qwen2.embed_tokens(lm, text_ids_before.to(visual.device)).to(visual.dtype)
    after = qwen2.embed_tokens(lm, text_ids_after.to(visual.device)).to(visual.dtype)
    return torch.cat([before, visual, after], dim=0)


def clip_embeds(params, cfg: VLMConfig, frames: torch.Tensor, text_ids_before: torch.Tensor,
                text_ids_after: torch.Tensor, *, frame_indices: Optional[torch.Tensor] = None,
                no_memory: bool = False, drop_fine_frames: bool = False) -> torch.Tensor:
    """A clip's spliced sequence (S, H): `encode_frames` over its F frames
    (F, H, W, 3), then the features padded to whole segments with the first
    F valid, `fine_frame_indices` and `build_video_embeds` (temporal
    positions `frame_indices` (Fmax,), by default 0..Fmax-1) or, with
    `no_memory`, `add_token_per_frame`; then the splice between the prompt's
    ids. The tower runs the real frames only; the memory reads no padded
    frame."""
    dev = frames.device
    mcfg = cfg.memory
    f = frames.shape[0]
    feats = encode_frames(params, cfg, frames)  # (F, 196, H)
    if no_memory:
        visual = add_token_per_frame(feats, params["memory"]["image_newline"])
    else:
        fmax = pad_frames_to_segment_multiple(f, mcfg.segment_frames)
        nseg = min(fmax // mcfg.segment_frames, mcfg.cache_cap)
        if fmax != f:
            feats = F.pad(feats, (0, 0, 0, 0, 0, fmax - f))
        positions = torch.arange(fmax) if frame_indices is None else frame_indices
        visual = build_video_embeds(params, cfg, feats, positions.to(dev), torch.arange(fmax) < f,
                                    torch.from_numpy(fine_frame_indices(f, mcfg.num_fine_frames)),
                                    nseg, drop_fine_frames=drop_fine_frames)
    return splice_image_embeds(params, text_ids_before, visual, text_ids_after)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------
#
# Decode is JAX's transition (`_decode_body`): pick -> a row already done
# emits 0 -> ring-write `tokens[:, step % width]` -> roll the `recent` tail
# -> eos or stop-sequence hit -> `num` -> embed, `qwen2.decode_step`,
# `unembed` -> `presence` under a repetition penalty. Every piece of the
# state, and every setting of the decode (budget, eos ids, stop sequences,
# temperature, top-k, top-p, penalty), lives in a persistent buffer of a
# `_Decoder` that the transition reads or updates in place and never reads
# back to the host. On the card a chunk of `chunk` transitions (JAX's
# streaming scan) is captured once per decoder as a CUDA graph and replayed
# until every row is done or the budget is spent; the host reads `done` once
# per chunk, and not at all when nothing can stop a row early. Past `done`
# or the budget a transition changes nothing that is returned (each write
# is gated on `step < budget`), so the result equals JAX's `while_loop`.
# The cache holds `smax + ceil(max_new / chunk) * chunk` positions, as JAX's
# stream sizes it: `decode_attention` masks by length and the port has no
# dynamic-NTK RoPE, so the extra positions change nothing. On the CPU the
# same transitions run eagerly. Sampling adds Gumbel noise drawn per chunk
# into a persistent buffer from an explicit `torch.Generator` (or takes the
# draws a caller passes, e.g. JAX's); JAX's `jax.random.categorical` is the
# argmax of the warped logits plus standard Gumbel noise.
#
# A decoder is keyed by the weights and its `_Layout` (shapes, dtypes and
# which processors run), never by a setting's value, and is held by one
# call at a time (`_decoder`).

DECODE_CHUNK = 8      # transitions per captured graph and per host check
MAX_DECODERS = 8      # captured decoders kept for reuse on the card
NOISE_SEED = 0        # the sampling generator's default seed
EOS_SLOTS = 4         # a decoder's eos ids at least; more widen the layout
STOP_SLOTS = (4, 8)   # its stop sequences and their length at least


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # (max_new,) or (B, max_new) int32, 0 after a stop
    num_tokens: torch.Tensor  # () or (B,) int32, stop keyword tokens included


@dataclasses.dataclass(frozen=True)
class _Settings:
    """What one decode does, beside the weights and the shapes."""

    max_new_tokens: int
    eos: Tuple[int, ...]
    stop: Tuple[Tuple[int, ...], ...]
    temperature: float
    top_p: float
    top_k: int
    repetition_penalty: float
    sampled: bool


def _settings(max_new_tokens, eos_token_ids, stop_sequences, do_sample, temperature, top_p,
              top_k, repetition_penalty) -> _Settings:
    return _Settings(int(max_new_tokens), tuple(int(t) for t in eos_token_ids),
                     tuple(tuple(int(t) for t in seq) for seq in stop_sequences),
                     float(temperature), float(top_p), int(top_k), float(repetition_penalty),
                     bool(do_sample) and temperature > 0.0)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """What a decoder's buffers and captured work depend on: its key."""

    batch: int
    smax: int
    width: int             # token slots: the budget rounded up to whole chunks
    chunk: int
    act_dtype: torch.dtype
    kv_dtype: torch.dtype  # int8: the prefill's cache is quantized into it
    eos_slots: int
    stop_shape: Tuple[int, int]
    sampled: bool          # the warp and the noise run
    penalized: bool        # `presence` is kept and the penalty runs
    keep_logits: bool


def _layout(embeds: torch.Tensor, st: _Settings, chunk: int, kv_int8: bool,
            keep_logits: bool) -> _Layout:
    b, smax, _ = embeds.shape
    lstop = max((len(seq) for seq in st.stop), default=1)
    return _Layout(b, smax, -(-st.max_new_tokens // chunk) * chunk, chunk, embeds.dtype,
                   torch.int8 if kv_int8 else embeds.dtype, max(EOS_SLOTS, len(st.eos)),
                   (max(STOP_SLOTS[0], len(st.stop)), max(STOP_SLOTS[1], lstop)), st.sampled,
                   st.repetition_penalty != 1.0, keep_logits)


def _vocab(lm) -> int:
    return (lm["unembed_scale"] if "unembed_scale" in lm else lm["embed_tokens"]).shape[0]


def _prefill(lm, cfg: VLMConfig, embeds: torch.Tensor, valid_len: torch.Tensor,
             cache: Optional[qwen2.KVCache] = None, cache_max_len: Optional[int] = None):
    """qwen2.forward over right-padded rows (B, Smax, H) with per-row valid
    lengths, into `cache` if given: (the logits at each row's last valid
    position (B, V) fp32, the cache)."""
    b, smax, h = embeds.shape
    positions = torch.arange(smax, device=embeds.device)[None]
    hidden, cache = qwen2.forward(lm, cfg.lm, embeds, positions, valid_len=valid_len,
                                  cache_max_len=cache_max_len, cache=cache)
    last = torch.gather(hidden, 1, (valid_len.long() - 1)[:, None, None].expand(b, 1, h))
    return qwen2.unembed(lm, last)[:, 0], cache


class _Decoder:
    """The persistent state of a batch's decode: the KV cache (which the
    prefill fills), the settings, the step, per-row `done`, `num`, the
    current logits, the token buffer, the `recent` tail, `presence`, the
    noise of a chunk and, with `keep_logits`, the logits each token was
    picked from. On the card the chunk of transitions is captured as a CUDA
    graph at construction, before any request writes the state: the warm-up
    that precedes a capture runs the chunk once on the zeroed buffers."""

    def __init__(self, lm, cfg: VLMConfig, lay: _Layout, device, capture: bool):
        self.lm, self.cfg, self.lay, self.chunk = lm, cfg, lay, lay.chunk
        dev = torch.device(device)
        b, vocab = lay.batch, _vocab(lm)
        i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
        self.cache = qwen2.KVCache.zeros(cfg.lm, b, lay.smax + lay.width, dev, lay.kv_dtype)
        self.budget = torch.zeros((), dtype=torch.long, device=dev)
        self.eos = torch.full((lay.eos_slots,), -1, **i32)
        self.stop_seqs = torch.full(lay.stop_shape, -1, **i32)
        self.stop_lens = torch.ones(lay.stop_shape[:1], **i32)
        self.temperature = torch.ones((), **f32)
        self.top_k = torch.zeros((), dtype=torch.long, device=dev)
        self.tail = torch.zeros((), **f32)
        self.penalty = torch.ones((), **f32)
        self.state = dict(
            step=torch.zeros((), dtype=torch.long, device=dev),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
            num=torch.zeros((b,), **i32),
            logits=torch.zeros((b, vocab), **f32),
            tokens=torch.zeros((b, lay.width), **i32),
            recent=torch.full((b, lay.stop_shape[1]), -1, **i32))
        if lay.penalized:
            self.state["presence"] = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
        if lay.keep_logits:
            self.state["rows"] = torch.zeros((lay.width, b, vocab), **f32)
        self.noise = torch.zeros((lay.chunk, b, vocab), **f32) if lay.sampled else None
        self.busy = False  # a call holds it
        self.graph = None
        if capture:
            self._capture()

    def _pick(self, noise) -> torch.Tensor:
        """JAX's `pick`: the processed logits' argmax, or with sampling the
        argmax of the warped logits plus this step's Gumbel noise. int32."""
        logits = self.state["logits"]
        if "presence" in self.state:
            logits = sampling.apply_repetition_penalty(logits, self.state["presence"],
                                                       self.penalty)
        if noise is not None:
            logits = noise + sampling.warp(logits, self.temperature, self.top_k, self.tail)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _transition(self, noise):
        s = self.state
        step, done, num = s["step"], s["done"], s["num"]
        active = step < self.budget
        tok = self._pick(noise)
        tok = torch.where(done, 0, tok)  # rows already done emit pad without extending
        width = s["tokens"].shape[1]
        col = (torch.arange(width, device=tok.device) == step % width) & active
        s["tokens"].copy_(torch.where(col, tok[:, None], s["tokens"]))
        recent = torch.cat([s["recent"][:, 1:], tok[:, None]], dim=1)
        hit_eos = torch.any(tok[:, None] == self.eos[None, :], dim=-1)
        hit_kw = sampling.stop_sequence_hit(recent, self.stop_seqs, self.stop_lens, num + 1)
        newly_done = ~done & (hit_eos | hit_kw) & active
        s["recent"].copy_(torch.where(active, recent, s["recent"]))
        num.copy_(torch.where(done | ~active, num, num + 1))
        if "rows" in s:
            at = step.clamp(max=width - 1).reshape(1)
            kept = torch.where(active, s["logits"], s["rows"].index_select(0, at)[0])
            s["rows"].index_copy_(0, at, kept[None])
        if "presence" in s:
            seen = torch.gather(s["presence"], 1, tok[:, None].long()) | active
            s["presence"].scatter_(1, tok[:, None].long(), seen)
        done.copy_(done | newly_done)
        emb = qwen2.embed_tokens(self.lm, tok[:, None].long()).to(self.lay.act_dtype)
        hidden, cache = qwen2.decode_step(self.lm, self.cfg.lm, emb, self.cache)
        s["logits"].copy_(qwen2.unembed(self.lm, hidden)[:, 0])
        self.cache.length.copy_(cache.length)
        step.add_(1)

    def _run_chunk(self):
        for t in range(self.chunk):
            self._transition(None if self.noise is None else self.noise[t])

    def _capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._run_chunk()  # cuBLAS's workspaces, before the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._run_chunk()
        self.graph = graph

    def start(self, embeds: torch.Tensor, valid: torch.Tensor, st: _Settings):
        """Prefill right-padded rows (B, smax, H) with per-row valid lengths
        into the cache (an int8 cache takes the prefill's quantized) and set
        the decode's settings and state from them."""
        lm, cfg = self.lm, self.cfg
        if self.lay.kv_dtype == torch.int8:
            logits, cache = _prefill(lm, cfg, embeds, valid, cache_max_len=self.cache.k.shape[2])
            qwen2.quantize_cache(cache, out=self.cache)
        else:
            logits, _ = _prefill(lm, cfg, embeds, valid, cache=self.cache)
        self.reset(logits, st)

    def reset(self, logits: torch.Tensor, st: _Settings):
        """Start a decode with settings `st` from the prefill's logits (B, V);
        the prefill has written the cache and its lengths."""
        n_stop, l_stop = self.lay.stop_shape
        seqs = np.full((n_stop, l_stop), -1, np.int32)
        seqs[:, -1] = -2  # an unused slot: one token no tail holds
        lens = np.ones((n_stop,), np.int32)
        packed, plens = sampling.pack_stop_sequences(st.stop)
        seqs[:len(plens), l_stop - packed.shape[1]:] = packed[:len(plens)]
        lens[:len(plens)] = plens
        self.stop_seqs.copy_(torch.from_numpy(seqs))
        self.stop_lens.copy_(torch.from_numpy(lens))
        self.eos.fill_(-1)
        self.eos[:len(st.eos)] = torch.tensor(st.eos, dtype=torch.int32)
        self.budget.fill_(st.max_new_tokens)
        self.temperature.fill_(st.temperature)
        self.top_k.fill_(st.top_k)
        self.tail.fill_(1.0 - st.top_p)
        self.penalty.fill_(st.repetition_penalty)
        s = self.state
        for key, value in (("step", 0), ("done", 0), ("num", 0), ("tokens", 0),
                           ("recent", -1), ("presence", 0), ("rows", 0)):
            if key in s:
                s[key].fill_(value)
        s["logits"].copy_(logits)

    def run_chunk(self, noise: Optional[torch.Tensor] = None):
        """`chunk` transitions: the graph's replay on the card, the same
        transitions eagerly elsewhere. `noise` (chunk, B, V) fills the noise
        buffer first when sampling."""
        if self.noise is not None:
            self.noise.copy_(noise)
        if self.graph is not None:
            self.graph.replay()
        else:
            self._run_chunk()

    def all_done(self) -> bool:
        return bool(self.state["done"].all())


_decoders: "collections.OrderedDict[tuple, _Decoder]" = collections.OrderedDict()
_decoders_lock = threading.Lock()


def clear_decoders():
    """Drop the captured decoders (their graphs, pools and caches, and the
    references that keep their weights alive)."""
    with _decoders_lock:
        _decoders.clear()


@contextlib.contextmanager
def _decoder(lm, cfg: VLMConfig, lay: _Layout, device, graph: bool = True):
    """Holds a decoder for these weights and layout for the duration of a
    call: on the card the captured one kept from an earlier call (up to
    MAX_DECODERS, oldest dropped first) unless another call holds it, then
    a new captured one; elsewhere, or with `graph=False` (the eager loop a
    graph is held against), a new one that runs eagerly."""
    dev = torch.device(device)
    if dev.type != "cuda" or not graph:
        yield _Decoder(lm, cfg, lay, dev, False)
        return
    key = (id(lm), lay, str(dev))
    with _decoders_lock:
        dec = _decoders.get(key)
        if dec is not None and not dec.busy:
            _decoders.move_to_end(key)
            dec.busy = True
        else:
            dec = None
    if dec is None:
        dec = _Decoder(lm, cfg, lay, dev, True)
        dec.busy = True
        with _decoders_lock:
            if key not in _decoders:
                _decoders[key] = dec
                while len(_decoders) > MAX_DECODERS:
                    _decoders.popitem(last=False)
    try:
        yield dec
    finally:
        dec.busy = False


def gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, fp32 on the generator's device: -log of unit
    exponentials."""
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return out.exponential_(generator=gen).log_().neg_()


def _generator(rng: Optional[torch.Generator], device) -> torch.Generator:
    if rng is not None:
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(NOISE_SEED)
    return gen


def _chunk_noise(dec: _Decoder, noise: Optional[torch.Tensor], gen, i: int):
    """Chunk i's Gumbel noise (chunk, B, V): the caller's draws for its steps
    (zeros past the budget, where no transition reads them) or fresh draws
    from `gen`."""
    if dec.noise is None:
        return None
    c = dec.chunk
    if noise is not None:
        part = noise[i * c:(i + 1) * c].to(dec.noise.device, torch.float32)
        return F.pad(part, (0, 0, 0, 0, 0, c - part.shape[0]))
    return gumbel(dec.noise.shape, gen)


def _pad_rows(inputs_embeds: torch.Tensor, pad_to_multiple: int) -> Tuple[torch.Tensor, int]:
    """(S, H) -> ((1, Smax, H) zero-padded to the multiple, S)."""
    s = inputs_embeds.shape[0]
    smax = -(-s // pad_to_multiple) * pad_to_multiple
    return F.pad(inputs_embeds, (0, 0, 0, smax - s))[None], s


def generate_batched(params, cfg: VLMConfig, inputs_embeds: torch.Tensor,
                     valid_len: torch.Tensor, *, max_new_tokens: int = 128,
                     eos_token_ids: Sequence[int] = (151645,), do_sample: bool = False,
                     temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                     repetition_penalty: float = 1.0,
                     stop_sequences: Sequence[Sequence[int]] = (),
                     rng: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, return_logits: bool = False,
                     kv_int8: bool = False, cuda_graph: bool = True):
    """HF-semantics decode over right-padded spliced sequences (JAX
    `vlm.generate_batched`): inputs_embeds (B, Smax, H), valid_len (B,) int.
    Greedy, or with `do_sample` and temperature > 0 sampled after the
    repetition penalty, temperature, top-k and top-p; per-row eos and stop
    sequences. Returns GenerateResult (tokens (B, max_new) int32, 0 after a
    stop; num_tokens (B,) int32, max_new for a row that never stopped).

    Sampling draws Gumbel noise per chunk from `rng` (a torch.Generator on
    the embeddings' device; default seeded NOISE_SEED), or takes `noise`
    (max_new, B, V) fp32, standard Gumbel draws per step (the tests pass
    JAX's). `return_logits` also returns the fp32 logits each token was
    picked from, (max_new, B, V). `kv_int8` decodes from the prefill's cache
    quantized to int8 (`bench.py`'s serving cache; JAX's generate keeps the
    activations' dtype). On the card decode replays a captured chunk;
    `cuda_graph=False` runs the same transitions eagerly there (what the
    graph is held against)."""
    dev = inputs_embeds.device
    lm = params["language_model"]
    st = _settings(max_new_tokens, eos_token_ids, stop_sequences, do_sample, temperature,
                   top_p, top_k, repetition_penalty)
    lay = _layout(inputs_embeds, st, DECODE_CHUNK, kv_int8, return_logits)
    with _decoder(lm, cfg, lay, dev, graph=cuda_graph) as dec:
        dec.start(inputs_embeds, torch.as_tensor(valid_len, dtype=torch.int32).to(dev), st)
        gen = _generator(rng, dev) if st.sampled and noise is None else None
        chunks = -(-st.max_new_tokens // dec.chunk)
        can_stop = bool(st.eos or st.stop)
        for i in range(chunks):
            dec.run_chunk(_chunk_noise(dec, noise, gen, i))
            if can_stop and i + 1 < chunks and dec.all_done():
                break
        s, n = dec.state, st.max_new_tokens
        out = GenerateResult(s["tokens"][:, :n].clone(), torch.where(s["done"], s["num"], n))
        return (out, s["rows"][:n].clone()) if return_logits else out


def generate(params, cfg: VLMConfig, inputs_embeds: torch.Tensor, *,
             max_new_tokens: int = 128, eos_token_ids: Sequence[int] = (151645,),
             do_sample: bool = False, temperature: float = 0.0, top_p: float = 1.0,
             top_k: int = 0, repetition_penalty: float = 1.0,
             stop_sequences: Sequence[Sequence[int]] = (), pad_to_multiple: int = 128,
             rng: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
             return_logits: bool = False, kv_int8: bool = False, cuda_graph: bool = True):
    """Greedy or sampled decode of one spliced sequence (S, H) (JAX
    `vlm.generate`; temperature > 0 means sampling, as for its older
    callers): `generate_batched` at B = 1 over the sequence zero-padded to
    `pad_to_multiple` rows. Returns GenerateResult (tokens (max_new,),
    num_tokens ()); `noise` is (max_new, 1, V), the logits (max_new, V)."""
    if temperature > 0.0:
        do_sample = True
    embeds, s = _pad_rows(inputs_embeds, pad_to_multiple)
    out = generate_batched(
        params, cfg, embeds, torch.tensor([s], dtype=torch.int32),
        max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids, do_sample=do_sample,
        temperature=temperature, top_p=top_p, top_k=top_k,
        repetition_penalty=repetition_penalty, stop_sequences=stop_sequences, rng=rng,
        noise=noise, return_logits=return_logits, kv_int8=kv_int8, cuda_graph=cuda_graph)
    result, rows = out if return_logits else (out, None)
    single = GenerateResult(result.tokens[0], result.num_tokens[0])
    return (single, rows[:, 0]) if return_logits else single


def generate_stream(params, cfg: VLMConfig, inputs_embeds: torch.Tensor, *,
                    max_new_tokens: int = 256, eos_token_ids: Sequence[int] = (151645,),
                    do_sample: bool = False, temperature: float = 0.0, top_p: float = 1.0,
                    top_k: int = 0, repetition_penalty: float = 1.0,
                    stop_sequences: Sequence[Sequence[int]] = (), chunk_size: int = 8,
                    pad_to_multiple: int = 128, rng: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> Iterator[np.ndarray]:
    """Yield the decoded token ids chunk by chunk (int32 numpy arrays; JAX
    `vlm.generate_stream`, the serving equivalent of the reference's
    TextIteratorStreamer): each chunk of `chunk_size` transitions is the
    same captured chunk `generate` replays, so the chunks put together are
    `generate`'s tokens. The host reads `num` and the fresh tokens once per
    chunk. The stream holds its decoder while it is live."""
    if temperature > 0.0:
        do_sample = True
    embeds, s = _pad_rows(inputs_embeds, pad_to_multiple)
    dev = embeds.device
    st = _settings(max_new_tokens, eos_token_ids, stop_sequences, do_sample, temperature,
                   top_p, top_k, repetition_penalty)
    lay = _layout(embeds, st, chunk_size, False, False)
    with _decoder(params["language_model"], cfg, lay, dev) as dec:
        dec.start(embeds, torch.tensor([s], dtype=torch.int32, device=dev), st)
        gen = _generator(rng, dev) if st.sampled and noise is None else None
        prev_num = 0
        for i in range(-(-st.max_new_tokens // chunk_size)):
            dec.run_chunk(_chunk_noise(dec, noise, gen, i))
            num = int(dec.state["num"][0])  # never past the budget: the writes are gated
            fresh = dec.state["tokens"][0, prev_num:num].cpu().numpy()
            if fresh.size:
                yield fresh
            prev_num = num
            if bool(dec.state["done"][0]):
                break


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decoding
# ---------------------------------------------------------------------------

def generate_speculative(params, cfg: VLMConfig, inputs_embeds: torch.Tensor, *,
                         draft_ids=None, max_new_tokens: int = 128,
                         eos_token_ids: Sequence[int] = (151645,), spec_k: int = 4,
                         pad_to_multiple: int = 128) -> Tuple[GenerateResult, Dict[str, int]]:
    """Greedy decode with prompt-lookup speculation (JAX
    `vlm.generate_speculative`): the exact plain-greedy tokens, ~(accepted
    + 1) tokens per LM forward. Per iteration the next greedy token g0 is
    certain; the last occurrence of the bigram (previous token, g0) in the
    corpus (`draft_ids`, the prompt's text ids, then every emitted token)
    proposes the spec_k - 1 tokens after it; one `qwen2.forward_chunk`
    verifies all spec_k positions, and the longest prefix whose greedy
    predictions match the proposal is emitted, cut to the budget and after
    the first eos. Returns (GenerateResult, {"iterations": n}).

    The iteration runs on the device; the host reads the loop condition
    (budget left, no eos) once per iteration, which stalls the queue: the
    card idles while the host enqueues the next iteration. The cache takes
    spec_k extra positions from the start (JAX pads them on after the
    prefill) for the window's writes past the budget."""
    if spec_k < 2:
        raise ValueError("spec_k must be >= 2 (1 certain + >=1 proposed)")
    lm = params["language_model"]
    embeds, s = _pad_rows(inputs_embeds, pad_to_multiple)
    dev, act_dtype = embeds.device, embeds.dtype
    n_draft = 0 if draft_ids is None else len(draft_ids)
    hist_cap = -(-(n_draft + max_new_tokens + spec_k) // 128) * 128
    hist = torch.zeros((hist_cap,), dtype=torch.int32, device=dev)
    if n_draft:
        hist[:n_draft] = torch.as_tensor(np.asarray(draft_ids, np.int32)).to(dev)
    valid = torch.tensor([s], dtype=torch.int32, device=dev)
    logits, cache = _prefill(lm, cfg, embeds, valid,
                             cache_max_len=embeds.shape[1] + max_new_tokens + spec_k)
    logits = logits[0]
    eos = torch.tensor(tuple(eos_token_ids), dtype=torch.int32, device=dev)
    width = max_new_tokens + spec_k
    window = torch.arange(spec_k, device=dev)
    ahead = torch.arange(spec_k - 1, device=dev)
    corpus = torch.arange(hist_cap - 1, device=dev)

    def lookup(t_prev, g0, hist_n):
        # the last occurrence of (t_prev, g0) in the corpus; the tokens after
        # it are the proposal; no match (or a continuation past the corpus's
        # end) proposes g0 (any draft is correctness-neutral)
        m = ((hist[:-1] == t_prev) & (hist[1:] == g0) & (corpus + 1 < hist_n) & (t_prev >= 0))
        j = torch.where(m, corpus, -1).max()
        start = (j + 2).clamp(0, hist_cap - (spec_k - 1))
        cont = torch.where(start + ahead < hist_n, hist[start + ahead], g0)
        return torch.where(j >= 0, cont, g0.expand(spec_k - 1))

    def at(x, i):
        return torch.index_select(x, 0, i.reshape(1))[0]

    num = torch.zeros((), dtype=torch.long, device=dev)
    cur_len = valid[0].long()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    tokens = torch.zeros((width,), dtype=torch.int32, device=dev)
    hist_n = torch.full((), n_draft, dtype=torch.long, device=dev)
    iters = 0
    while bool((num < max_new_tokens) & ~done):
        g0 = torch.argmax(logits).to(torch.int32)
        t_prev = torch.where(hist_n > 0, at(hist, (hist_n - 1).clamp_min(0)), -1)
        chunk = torch.cat([g0[None], lookup(t_prev, g0, hist_n)])            # (K,)
        emb = qwen2.embed_tokens(lm, chunk[None].long()).to(act_dtype)
        hidden, cache = qwen2.forward_chunk(lm, cfg.lm, emb, cache, cur_len)
        logits_all = qwen2.unembed(lm, hidden)[0]                           # (K, V)
        preds = torch.argmax(logits_all, dim=-1).to(torch.int32)
        n_acc = torch.cumprod((preds[:-1] == chunk[1:]).long(), dim=0).sum()
        logits = at(logits_all, n_acc)
        emitted = torch.minimum(1 + n_acc, max_new_tokens - num)
        hit = torch.any(chunk[:, None] == eos[None, :], dim=-1) & (window < emitted)
        any_hit = hit.any()
        emitted = torch.where(any_hit, torch.argmax(hit.to(torch.int32)) + 1, emitted)
        tokens.index_copy_(0, num.clamp(0, width - spec_k) + window, chunk)
        hist.index_copy_(0, hist_n.clamp(0, hist_cap - spec_k) + window, chunk)
        num, cur_len, hist_n = num + emitted, cur_len + emitted, hist_n + emitted
        done = done | any_hit
        iters += 1
    tokens = torch.where(torch.arange(width, device=dev) < num, tokens, 0)
    return (GenerateResult(tokens[:max_new_tokens], num.to(torch.int32)),
            {"iterations": iters})


# ---------------------------------------------------------------------------
# Log-likelihood scoring (lmms-eval `loglikelihood` protocol)
# ---------------------------------------------------------------------------

def score_continuation(params, cfg: VLMConfig, inputs_embeds: torch.Tensor, cont_ids, *,
                       pad_to_multiple: int = 128) -> Tuple[float, bool]:
    """(sum log p(continuation | prefix), all-greedy flag) from one prefill
    with fp32 logits (JAX `vlm.score_continuation`): inputs_embeds (S, H) is
    the whole spliced sequence, whose last T positions embed `cont_ids`
    (T,); continuation token j's predictive logits sit one position before
    it. Only those T rows are unembedded (JAX unembeds every row and
    gathers them)."""
    lm = params["language_model"]
    embeds, s = _pad_rows(inputs_embeds, pad_to_multiple)
    dev = embeds.device
    cont = torch.from_numpy(np.array(cont_ids, dtype=np.int64)).to(dev)
    t = cont.shape[0]
    positions = torch.arange(embeds.shape[1], device=dev)[None]
    hidden, _ = qwen2.forward(lm, cfg.lm, embeds, positions,
                              valid_len=torch.tensor([s], dtype=torch.int32, device=dev),
                              need_cache=False)
    idx = (s - t + torch.arange(t, device=dev) - 1).clamp(0, embeds.shape[1] - 1)
    logp = torch.log_softmax(qwen2.unembed(lm, hidden[0, idx]), dim=-1)   # (T, V)
    total = torch.gather(logp, 1, cont[:, None])[:, 0].sum()
    greedy = torch.all(torch.argmax(logp, dim=-1) == cont)
    return float(total), bool(greedy)


# ---------------------------------------------------------------------------
# High-level video QA entry (host orchestration)
# ---------------------------------------------------------------------------

def video_qa_embeds(params, cfg: VLMConfig, pixels, input_ids, *,
                    training_drop_frames: bool = False) -> torch.Tensor:
    """Frames + token ids -> the spliced embedding sequence (S, H) that
    `generate` and the others take (JAX `vlm.video_qa_embeds`): the frames
    re-sampled (`sample_video_frames`), then `clip_embeds` with their
    original indices for the temporal PE and the splice around the single
    IMAGE_TOKEN_INDEX of `input_ids` (S,).

    pixels (F0, H, W, 3), numpy or a tensor: preprocessed float frames, or
    raw uint8 frames (JAX's device preprocess): the sampled frames cross to
    the weights' device as uint8 and `ops/preprocess.preprocess_frames`
    resizes and normalizes them there at `cfg.vision.image_size`. Runs on
    the weights' device in their dtype. (JAX pads the uint8 frames before
    its preprocess; the port pads the features after the tower, and the
    memory reads no padded frame, so the two agree.)"""
    emb = params["language_model"]["embed_tokens"]
    sample_idx = sample_video_frames(pixels.shape[0])
    if isinstance(pixels, torch.Tensor):
        frames = pixels[torch.from_numpy(sample_idx).to(pixels.device)]
    else:
        frames = torch.from_numpy(np.ascontiguousarray(pixels[sample_idx]))
    if frames.dtype == torch.uint8:
        s = cfg.vision.image_size
        frames = preprocess_frames(frames.to(emb.device), size=(s, s), dtype=emb.dtype)
    f1 = len(sample_idx)
    fmax = pad_frames_to_segment_multiple(f1, cfg.memory.segment_frames)
    frame_indices = torch.from_numpy(np.concatenate([sample_idx, np.zeros(fmax - f1, np.int64)]))
    ids = np.asarray(input_ids)
    image_pos = int(np.where(ids == constants.IMAGE_TOKEN_INDEX)[0][0])
    before = torch.as_tensor(ids[:image_pos], dtype=torch.long)
    after = torch.as_tensor(ids[image_pos + 1:], dtype=torch.long)
    return clip_embeds(params, cfg, frames.to(emb.device, emb.dtype), before, after,
                       frame_indices=frame_indices, drop_fine_frames=training_drop_frames)
