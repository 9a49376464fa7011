"""lmms-eval model adapter of the port (counterpart of
`memory_augmented_vlm_tpu/eval/lmms_adapter.py`).

The reference is scored through the lmms-eval harness with its
`llava_onevision` model class (README.md:41-49), which consumes
`load_pretrained_model` and `generate`. This adapter gives the port the
same surface, so `--model mavlm_torch --model_args pretrained=...,
max_frames_num=...` runs the task suite unchanged (longvideobench_val_v,
videomme, mlvu_dev, nextqa_mc_test, egoschema).

lmms-eval is not bundled; where it is importable the class registers with
it, else with the API subset vendored under `third_party/lmms_eval`, else
it works standalone. It registers as `mavlm_torch`, beside the JAX
package's `mavlm_tpu`, in one registry. The weights load on the card
(`device`, lmms-eval's argument) unless `device="cpu"`.
"""

from __future__ import annotations

import pathlib
import sys
from typing import List, Optional, Tuple

import numpy as np

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.conversation import conv_templates
from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model
from memory_augmented_vlm_torch.models import vlm as vlm_mod


def _import_lmms():
    try:
        from lmms_eval.api.model import lmms as base  # type: ignore
        from lmms_eval.api.registry import register_model as reg  # type: ignore

        return base, reg
    except ImportError:
        return None


_found = _import_lmms()
if _found is None:
    # the vendored API subset (third_party/lmms_eval)
    _vendored = pathlib.Path(__file__).resolve().parents[2] / "third_party"
    if (_vendored / "lmms_eval").is_dir() and str(_vendored) not in sys.path:
        sys.path.append(str(_vendored))
        _found = _import_lmms()

if _found is not None:
    _LmmsBase, register_model = _found
    _HAVE_LMMS = True
else:  # standalone
    _LmmsBase = object

    def register_model(*names):
        def deco(cls):
            return cls

        return deco

    _HAVE_LMMS = False


@register_model("mavlm_torch")
class MavlmTorch(_LmmsBase):
    """Generate-until and log-likelihood adapter over the port."""

    def __init__(self, pretrained: str, max_frames_num: int = 64,
                 conv_template: str = "qwen_1_5", device: str = "cuda", batch_size: int = 1,
                 attn_implementation: str = "flash", overwrite_config: Optional[dict] = None,
                 **kwargs):
        if _HAVE_LMMS:
            super().__init__()
        self.max_frames_num = int(max_frames_num)
        self.conv_template = conv_template
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(
            pretrained, None, "llava_qwen", attn_implementation=attn_implementation,
            device_map=device, overwrite_config=overwrite_config)

    # -- shared request plumbing -------------------------------------------
    def _prep_pixels(self, visuals, modality: str):
        """Subsample a video to max_frames_num and run the host processor
        (one s x s view per image or frame)."""
        if visuals is None:
            return None
        frames = np.asarray(visuals)
        if modality == "video" and frames.shape[0] > self.max_frames_num:
            idx = np.linspace(0, frames.shape[0] - 1, self.max_frames_num).astype(int)
            frames = frames[idx]
        return self.image_processor.preprocess(frames)

    @staticmethod
    def _normalize_until(until) -> list:
        """gen_kwargs['until'] may be None, a bare string, or a list."""
        if until is None:
            return []
        if isinstance(until, str):
            return [until]
        return list(until)

    def _encode_stops(self, until: list) -> tuple:
        """Stop strings -> token-id sequences for in-loop keyword stopping
        (KeywordsStoppingCriteria, llava/mm_utils.py:372); truncating the
        text stays as the backstop for mid-stream retokenization."""
        seqs = []
        for stop in until:
            tok = self.tokenizer.encode(stop, add_special_tokens=False)
            if tok:
                seqs.append(tuple(tok))
        return tuple(seqs)

    @staticmethod
    def _truncate_at_stops(text: str, until: list) -> str:
        for stop in until:
            if stop and stop in text:
                text = text.split(stop)[0]
        return text.strip()

    def _doc_visuals(self, doc_to_visual, task: str, split: str, doc_id):
        """doc_to_visual's output (PIL images or arrays) -> (array, modality,
        doc): one PIL image is an image, several are a video's frames."""
        doc = (self.task_dict[task][split][doc_id]
               if getattr(self, "task_dict", {}).get(task) else None)
        visuals = doc_to_visual(doc) if (doc is not None and callable(doc_to_visual)) else None
        if not visuals:
            return None, "video", doc
        first = visuals[0]
        if hasattr(first, "convert"):  # PIL image(s)
            vis = np.stack([np.asarray(v.convert("RGB")) for v in visuals])
            return vis, ("image" if len(visuals) == 1 else "video"), doc
        return np.asarray(first), "video", doc

    def _generate(self, prompt: str, pixels, modality: str, max_new_tokens: int,
                  temperature: float, until: list) -> str:
        ids = tokenizer_image_token(prompt, self.tokenizer)
        out = self.model.generate(
            ids[None], images=[pixels] if pixels is not None else None, modalities=[modality],
            do_sample=temperature > 0, temperature=temperature, max_new_tokens=max_new_tokens,
            eos_token_id=self.tokenizer.convert_tokens_to_ids("<|im_end|>"),
            stop_sequences=self._encode_stops(until))
        text = self.tokenizer.decode(out[0], skip_special_tokens=True).strip()
        return self._truncate_at_stops(text, until)

    # -- core answer function (shared by lmms-eval and standalone use) -----
    def answer(self, question: str, visuals=None, modality: str = "video",
               max_new_tokens: int = 128, temperature: float = 0.0, until=None) -> str:
        until = self._normalize_until(until)
        pixels = self._prep_pixels(visuals, modality)
        if pixels is not None and constants.DEFAULT_IMAGE_TOKEN not in question:
            question = constants.DEFAULT_IMAGE_TOKEN + "\n" + question
        conv = conv_templates[self.conv_template].copy()
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        return self._generate(conv.get_prompt(), pixels, modality, max_new_tokens,
                              temperature, until)

    # -- lmms-eval API ------------------------------------------------------
    def generate_until(self, requests) -> List[str]:
        results = []
        for req in requests:
            contexts, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
            vis, modality, _ = self._doc_visuals(doc_to_visual, task, split, doc_id)
            results.append(self.answer(
                contexts, visuals=vis, modality=modality,
                max_new_tokens=gen_kwargs.get("max_new_tokens", 128),
                temperature=gen_kwargs.get("temperature", 0.0), until=gen_kwargs.get("until")))
        return results

    def score(self, context: str, continuation: str, visuals=None,
              modality: str = "video") -> Tuple[float, bool]:
        """(sum log p(continuation | context, visuals), is_greedy): the
        lmms-eval `loglikelihood` contract for one request."""
        pixels = self._prep_pixels(visuals, modality)
        if pixels is not None and constants.DEFAULT_IMAGE_TOKEN not in context:
            context = constants.DEFAULT_IMAGE_TOKEN + "\n" + context
        conv = conv_templates[self.conv_template].copy()
        conv.append_message(conv.roles[0], context)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids_ctx = tokenizer_image_token(prompt, self.tokenizer)
        ids_full = tokenizer_image_token(prompt + continuation, self.tokenizer)
        cont_ids = np.asarray(ids_full[len(ids_ctx):], np.int64)
        if cont_ids.size == 0:
            return 0.0, True
        embeds = self.model._row_embeds(np.asarray(ids_full, np.int64), pixels, modality)
        return vlm_mod.score_continuation(self.model.params, self.model.cfg, embeds, cont_ids)

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """lmms-eval protocol: requests carry
        (contexts, doc_to_target, doc_to_visual, doc_id, task, split)."""
        results = []
        for req in requests:
            contexts, doc_to_target, doc_to_visual, doc_id, task, split = req.args
            vis, modality, doc = self._doc_visuals(doc_to_visual, task, split, doc_id)
            continuation = (doc_to_target(doc) if callable(doc_to_target)
                            else str(doc_to_target))
            results.append(self.score(contexts, continuation, visuals=vis, modality=modality))
        return results

    def answer_multi_round(self, turns, visuals=None, modality: str = "video",
                           max_new_tokens: int = 128, temperature: float = 0.0,
                           until=None) -> List[str]:
        """Multi-round chat over one visual context: each user turn answered
        with the whole history in the conversation template (the protocol
        newer lmms-eval tasks use)."""
        until = self._normalize_until(until)
        pixels = self._prep_pixels(visuals, modality)
        conv = conv_templates[self.conv_template].copy()
        answers = []
        for round_idx, question in enumerate(turns):
            if (round_idx == 0 and pixels is not None
                    and constants.DEFAULT_IMAGE_TOKEN not in question):
                question = constants.DEFAULT_IMAGE_TOKEN + "\n" + question
            conv.append_message(conv.roles[0], question)
            conv.append_message(conv.roles[1], None)
            text = self._generate(conv.get_prompt(), pixels, modality, max_new_tokens,
                                  temperature, until)
            conv.messages[-1][1] = text  # the answered turn joins the history
            answers.append(text)
        return answers

    def generate_until_multi_round(self, requests) -> List[List[str]]:
        """Per request: a list of per-round responses."""
        results = []
        for req in requests:
            contexts, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
            turns = list(contexts) if isinstance(contexts, (list, tuple)) else [contexts]
            vis, modality, _ = self._doc_visuals(doc_to_visual, task, split, doc_id)
            results.append(self.answer_multi_round(
                turns, visuals=vis, modality=modality,
                max_new_tokens=gen_kwargs.get("max_new_tokens", 128),
                temperature=gen_kwargs.get("temperature", 0.0), until=gen_kwargs.get("until")))
        return results
