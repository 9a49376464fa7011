"""Cog/Replicate-style predictor of the port (counterpart of the root
`predict.py`, which serves the JAX package; reference: predict.py).

A `Predictor` with `setup()`/`predict()` for container serving platforms,
over the same `load_pretrained_model` and `generate` as the other entries.
The weights load on the card unless `setup(..., device_map="cpu")`.
"""

from __future__ import annotations

import os
from typing import Optional

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.conversation import conv_templates
from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model


class Predictor:
    def setup(self, weights: Optional[str] = None, device_map: str = "auto"):
        """Load the checkpoint directory `weights` (default $MAVLM_WEIGHTS,
        else ./weights)."""
        path = weights or os.environ.get("MAVLM_WEIGHTS", "./weights")
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(path, None, "llava_qwen",
                                                   device_map=device_map)

    def predict(self, prompt: str, video: Optional[str] = None, image: Optional[str] = None,
                max_new_tokens: int = 256, temperature: float = 0.0) -> str:
        pixels, modality = None, "text"
        if video:
            from memory_augmented_vlm_torch.data.video import load_video

            frames, *_ = load_video(video)
            pixels = self.image_processor.preprocess(frames)
            modality = "video"
        elif image:
            from PIL import Image

            pixels = self.image_processor.preprocess(Image.open(image))
            modality = "image"
        if pixels is not None and constants.DEFAULT_IMAGE_TOKEN not in prompt:
            prompt = constants.DEFAULT_IMAGE_TOKEN + "\n" + prompt
        conv = conv_templates["qwen_1_5"].copy()
        conv.append_message(conv.roles[0], prompt)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        out = self.model.generate(
            ids[None], images=[pixels] if pixels is not None else None,
            modalities=[modality], do_sample=temperature > 0, temperature=temperature,
            max_new_tokens=max_new_tokens,
            eos_token_id=self.tokenizer.convert_tokens_to_ids("<|im_end|>"))
        return self.tokenizer.decode(out[0], skip_special_tokens=True)
