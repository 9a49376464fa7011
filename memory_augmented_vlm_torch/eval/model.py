"""Object-oriented shell over the port's functional core (counterpart of
`memory_augmented_vlm_tpu/eval/model.py`): the public inference surface the
reference exposes as `LlavaQwenForCausalLM`
(llava/model/language_model/llava_qwen.py:116-136) and that the lmms-eval
`llava_onevision` adapter consumes.

The shell holds (params, VLMConfig) and routes `.generate()` through the
port's generation entries (`models/vlm.py`, `models/beam_search.py`) on the
device the params lie on. It takes numpy or torch ids and images (lmms-eval
passes torch CPU tensors): raw uint8 video frames go through the host
processor (`data/preprocessing.SigLipImageProcessor`, which needs Pillow),
float frames must be tower-sized tiles, already normalized. The image path
(anyres tiles, `modalities` other than "video") is ROADMAP §1 item 5.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import beam_search, qwen2, vlm

DEFAULT_EOS = 151645  # <|im_end|>


def _ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _frames(x):
    """Frames as a tensor or a numpy array, as given; one frame made a clip
    of one, channel-first (F, 3, H, W) made channel-last."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim == 3:
        x = x[None]
    if x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1) if isinstance(x, torch.Tensor) else x.transpose(0, 2, 3, 1)
    return x


def _eos(eos_token_id) -> tuple:
    if eos_token_id is None:
        return (DEFAULT_EOS,)
    if isinstance(eos_token_id, int):
        return (eos_token_id,)
    return tuple(eos_token_id)


class MavlmConfig:
    """Duck-typed stand-in for the HF config object callers poke at."""

    def __init__(self, cfg: VLMConfig, raw: Optional[dict] = None):
        self._cfg = cfg
        self.hidden_size = cfg.lm.hidden_size
        self.vocab_size = cfg.lm.vocab_size
        self.max_position_embeddings = cfg.lm.max_position_embeddings
        # the only values the port runs (`builder.config_from_json` refuses others)
        self.mm_newline_position = "one_token"
        self.mm_spatial_pool_mode = "bilinear"
        self.mm_patch_merge_type = cfg.pipeline.mm_patch_merge_type
        self.image_aspect_ratio = cfg.pipeline.image_aspect_ratio
        self.tokenizer_model_max_length = cfg.pipeline.tokenizer_model_max_length
        self.tokenizer_padding_side = cfg.pipeline.tokenizer_padding_side
        for k, v in (raw or {}).items():
            if not hasattr(self, k):
                setattr(self, k, v)


class MavlmForCausalLM:
    """Flagship VLM with the reference's `.generate` signature."""

    def __init__(self, params, cfg: VLMConfig, raw_config: Optional[dict] = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.params = params
        self.cfg = cfg
        self.config = MavlmConfig(cfg, raw_config)
        self.dtype = dtype
        self.device = params["language_model"]["embed_tokens"].device

    # HF-style no-ops: the params stay where the loader put them
    def eval(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def half(self):
        return self

    def tie_weights(self):
        return self

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def generate(
        self,
        input_ids,
        images=None,
        modalities: Union[str, Sequence[str]] = "image",
        image_sizes=None,
        attention_mask=None,
        do_sample: bool = False,
        temperature: float = 0.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        repetition_penalty: float = 1.0,
        num_beams: int = 1,
        max_new_tokens: int = 128,
        eos_token_id: Optional[Union[int, Sequence[int]]] = None,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
        rng_seed: int = 0,
        **kwargs,
    ) -> np.ndarray:
        """Multimodal generate with HF sampling semantics. Returns (B,
        n_new) int64 generated ids (no prompt echo, as the reference model's
        `generate`, which receives inputs_embeds; llava_qwen.py:116-136).

        B > 1: each row of `input_ids` (less its `attention_mask` zeros) is
        spliced with its own entry of `images` / `modalities`, and the rows
        are right-padded to one multiple of 128 for `generate_batched`.
        `num_beams > 1` runs `beam_search` per row; `prompt_lookup_num_tokens`
        (a kwarg, HF's) runs greedy `generate_speculative` drafted from the
        prompt's text ids. `stop_sequences` carries "until"-style keyword
        token ids. Sampling draws its Gumbel noise from a torch.Generator
        seeded `rng_seed` (beam rows: `rng_seed + row`), or takes `noise`
        (a kwarg: (max_new, B, V) standard Gumbel draws, as
        `vlm.generate_batched` takes them)."""
        ids_arr = _ids(input_ids)
        if ids_arr.ndim == 1:
            ids_arr = ids_arr[None]
        batch = ids_arr.shape[0]
        if isinstance(modalities, str):
            modalities = [modalities] * batch
        eos = _eos(eos_token_id)
        rows = []
        for b in range(batch):
            row = ids_arr[b]
            if attention_mask is not None:
                row = row[_ids(attention_mask)[b].astype(bool)]
            rows.append(row)
        embeds_rows = [
            self._row_embeds(
                rows[b],
                None if images is None else (
                    images[b] if isinstance(images, (list, tuple)) else images),
                modalities[b] if b < len(modalities) else modalities[-1])
            for b in range(batch)
        ]
        sampled = bool(do_sample)
        kn = dict(
            max_new_tokens=max_new_tokens,
            eos_token_ids=eos,
            do_sample=sampled,
            temperature=float(temperature) if sampled else 0.0,
            top_p=float(top_p) if (sampled and top_p is not None) else 1.0,
            top_k=int(top_k) if (sampled and top_k) else 0,
            repetition_penalty=float(repetition_penalty),
            stop_sequences=tuple(tuple(int(t) for t in s) for s in (stop_sequences or ())),
        )
        if num_beams > 1:
            rows_out = [
                beam_search.beam_search(
                    self.params, self.cfg, e, num_beams=num_beams,
                    max_new_tokens=max_new_tokens, eos_token_ids=eos,
                    length_penalty=float(kwargs.get("length_penalty", 1.0)),
                    repetition_penalty=kn["repetition_penalty"],
                    stop_sequences=kn["stop_sequences"], do_sample=sampled,
                    temperature=kn["temperature"], top_p=kn["top_p"], top_k=kn["top_k"],
                    rng=self._generator(rng_seed + b) if sampled else None)
                for b, e in enumerate(embeds_rows)
            ]
            width = max(1, max(len(r) for r in rows_out))
            result = np.zeros((batch, width), np.int64)
            for b, r in enumerate(rows_out):
                result[b, :len(r)] = r
            return result

        plk = int(kwargs.get("prompt_lookup_num_tokens") or 0)
        if (plk > 1 and batch == 1 and not sampled and repetition_penalty == 1.0
                and not kn["stop_sequences"]):
            text_ids = rows[0][rows[0] >= 0]  # drop IMAGE_TOKEN_INDEX (-200)
            out, _ = vlm.generate_speculative(
                self.params, self.cfg, embeds_rows[0], draft_ids=text_ids,
                max_new_tokens=max_new_tokens, eos_token_ids=eos, spec_k=plk)
            n = int(out.num_tokens)
            return out.tokens[:n].cpu().numpy().astype(np.int64)[None]

        kn["rng"] = self._generator(rng_seed) if sampled else None
        kn["noise"] = kwargs.get("noise")
        if batch == 1:
            out = vlm.generate(self.params, self.cfg, embeds_rows[0], **kn)
            n = int(out.num_tokens)
            return out.tokens[:n].cpu().numpy().astype(np.int64)[None]

        lens = [int(e.shape[0]) for e in embeds_rows]
        smax = -(-max(lens) // 128) * 128
        stacked = torch.stack([F.pad(e, (0, 0, 0, smax - e.shape[0])) for e in embeds_rows])
        out = vlm.generate_batched(self.params, self.cfg, stacked,
                                   torch.tensor(lens, dtype=torch.int32), **kn)
        nums = out.num_tokens.cpu().numpy()
        toks = out.tokens.cpu().numpy()
        result = np.zeros((batch, max(1, int(nums.max()))), np.int64)
        for b in range(batch):
            result[b, :nums[b]] = toks[b, :nums[b]]
        return result

    def generate_stream(
        self,
        input_ids,
        images=None,
        modalities: Union[str, Sequence[str]] = "image",
        image_sizes=None,
        do_sample: bool = False,
        temperature: float = 0.0,
        top_p: Optional[float] = None,
        repetition_penalty: float = 1.0,
        max_new_tokens: int = 256,
        eos_token_id: Optional[Union[int, Sequence[int]]] = None,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
        chunk_size: int = 8,
        rng_seed: int = 0,
        **kwargs,
    ):
        """Yield int32 numpy token-id chunks incrementally (one sample): the
        worker's TextIteratorStreamer replacement. `noise` as `generate`."""
        ids = _ids(input_ids)
        if ids.ndim == 2:
            ids = ids[0]
        if isinstance(modalities, str):
            modalities = [modalities]
        embeds = self._row_embeds(
            ids, images[0] if isinstance(images, (list, tuple)) else images, modalities[0])
        sampled = bool(do_sample)
        yield from vlm.generate_stream(
            self.params, self.cfg, embeds,
            max_new_tokens=max_new_tokens,
            eos_token_ids=_eos(eos_token_id),
            do_sample=sampled,
            temperature=float(temperature) if sampled else 0.0,
            top_p=float(top_p) if (sampled and top_p is not None) else 1.0,
            repetition_penalty=float(repetition_penalty),
            stop_sequences=tuple(tuple(int(t) for t in s) for s in (stop_sequences or ())),
            chunk_size=chunk_size,
            rng=self._generator(rng_seed) if sampled else None,
            noise=kwargs.get("noise"),
        )

    def _row_embeds(self, ids: np.ndarray, images, modality: str) -> torch.Tensor:
        """Splice one sample's text ids with its visual stream -> (S, H).
        (`image_sizes`, which `generate` takes, belongs to the image path.)"""
        if images is None or constants.IMAGE_TOKEN_INDEX not in ids:
            tokens = torch.as_tensor(ids, dtype=torch.long, device=self.device)
            return qwen2.embed_tokens(self.params["language_model"], tokens).to(self.dtype)
        if modality != "video":
            raise NotImplementedError(
                f"modality {modality!r}: the image path (anyres tiles) is not ported "
                "(ROADMAP §1 item 5); the port runs modalities=['video']")
        img = images[0] if isinstance(images, (list, tuple)) else images
        pixels = _frames(img)
        s = self.cfg.vision.image_size
        if pixels.dtype in (np.uint8, torch.uint8):
            from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor

            if isinstance(pixels, torch.Tensor):
                pixels = pixels.cpu().numpy()
            pixels = SigLipImageProcessor(size=(s, s)).preprocess(pixels)
        elif pixels.shape[1] != s or pixels.shape[2] != s:
            raise ValueError(
                f"pre-normalized inputs must be {s}x{s} tower tiles, got "
                f"{tuple(pixels.shape)}; pass raw uint8 frames to let generate() run "
                "the processor (resize and normalize)")
        return vlm.video_qa_embeds(self.params, self.cfg, pixels, ids)
