"""Constants the port reads, copied from `memory_augmented_vlm_tpu/constants.py`
so that the port imports nothing of the JAX package.

The natural-language prompts spliced around the two visual streams, with
their Qwen2 tokenizer ids (reference: llava/model/llava_arch.py:708-716),
the label of a position that takes no loss, and the prompt sentinels and
vision special tokens of the tokenizer glue.
"""

IGNORE_INDEX = -100

MEMORY_PROMPT_TEXT = "This is a high-level summary of the video:"
MEMORY_PROMPT_IDS = (1986, 374, 264, 1550, 11591, 12126, 315, 279, 2766, 25)
FRAME_PROMPT_TEXT = "These are sampled visual frames from the video:"
FRAME_PROMPT_IDS = (9485, 525, 48876, 9124, 14087, 504, 279, 2766, 25)

# the single <image> sentinel in a prompt's token ids, which the visual
# stream replaces
IMAGE_TOKEN_INDEX = -200

# prompt text and vision special tokens (reference: llava/constants.py:7-12)
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
