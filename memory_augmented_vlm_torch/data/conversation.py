"""Conversation / prompt templates (a copy of
`memory_augmented_vlm_tpu/data/conversation.py`, which imports nothing of
JAX; tests/test_torch_data.py holds every template to it).

Byte-exact parity with llava/conversation.py: the `Conversation` dataclass,
every separator style's rendering (SINGLE/TWO/CHATML/MPT/GEMMA/LLAMA_2/
LLAMA_3/PLAIN), the image-tuple preamble incl. the mmtag rewrite
(conversation.py:48-62), and all 21 registered templates
(conversation.py:313-585). The active video recipe uses `qwen_1_5` (ChatML,
conversation.py:443-452,578-579); the rest cover the alternative LM
backbones (L11 of SURVEY.md §1). Template strings are rendered-format
compatibility specs pinned by tests/test_conversation.py goldens.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    CHATML = enum.auto()
    LLAMA_2 = enum.auto()
    LLAMA_3 = enum.auto()
    GEMMA = enum.auto()
    QWEN = enum.auto()


def _msg_text(message) -> str:
    """Messages may be (text, images, process_mode) tuples on the image turn."""
    if type(message) is tuple:
        return message[0]
    return message


def _msg_images(message) -> list:
    if type(message) is tuple and len(message) > 1:
        imgs = message[1]
        return list(imgs) if isinstance(imgs, (list, tuple)) else [imgs]
    return []


@dataclasses.dataclass
class Conversation:
    """A conversation with history; `get_prompt` renders the LM input string."""

    system: str
    roles: Tuple[str, str]
    messages: List[List]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    tokenizer_id: str = ""
    tokenizer: Any = None
    stop_str: Optional[str] = None
    stop_token_ids: Optional[List[int]] = None

    def get_prompt(self) -> str:
        messages = self.messages
        if len(messages) > 0 and type(messages[0][1]) is tuple:
            # image-turn preamble (conversation.py:48-62)
            messages = self.messages.copy()
            init_role, init_msg_t = messages[0]
            init_msg = init_msg_t[0]
            if "mmtag" in self.version:
                init_msg = init_msg.replace("<image>", "").strip()
                messages[0] = (init_role, init_msg)
                messages.insert(0, (self.roles[0], "<Image><image></Image>"))
                messages.insert(1, (self.roles[1], "Received."))
            elif not init_msg.startswith("<image>"):
                init_msg = init_msg.replace("<image>", "").strip()
                messages[0] = (init_role, "<image>\n" + init_msg)
            else:
                messages[0] = (init_role, init_msg)

        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + _msg_text(message) + self.sep
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + _msg_text(message) + seps[i % 2]
                else:
                    ret += role + ":"
            return ret

        if self.sep_style in (SeparatorStyle.CHATML, SeparatorStyle.QWEN):
            # ChatML: <|im_start|>role\ncontent<|im_end|>\n; image tuples get
            # one <image> sentinel per attached image (conversation.py:85-95)
            ret = "" if self.system == "" else self.system + self.sep + "\n"
            for role, message in messages:
                if message:
                    text = _msg_text(message)
                    imgs = _msg_images(message)
                    if imgs:
                        text = "<image>" * len(imgs) + text
                    ret += role + "\n" + text + self.sep + "\n"
                else:
                    ret += role + "\n"
            return ret

        if self.sep_style == SeparatorStyle.MPT:
            # roles already carry a trailing newline
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + _msg_text(message) + self.sep
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2 or self.sep]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += _msg_text(message) + seps[i % 2]
            return ret

        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if len(msg) > 0 else msg

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    message = _msg_text(message)
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + (self.sep2 or "")
            return ret.lstrip(self.sep) if self.sep else ret

        if self.sep_style == SeparatorStyle.LLAMA_3:
            # the reference defers to the HF llama-3 chat template
            # (conversation.py:97-109); when a tokenizer is attached use it,
            # otherwise render the identical format explicitly
            if self.tokenizer is not None:
                chat = [{"role": "system", "content": self.system}]
                for role, message in messages:
                    if message:
                        text = _msg_text(message)
                        imgs = _msg_images(message)
                        if imgs:
                            text = "<image>" * len(imgs) + text
                        chat.append({"role": role, "content": text})
                return self.tokenizer.apply_chat_template(
                    chat, tokenize=False, add_generation_prompt=True)
            ret = (
                f"<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
                f"{self.system}<|eot_id|>"
            )
            for role, message in messages:
                if message:
                    text = _msg_text(message)
                    imgs = _msg_images(message)
                    if imgs:
                        text = "<image>" * len(imgs) + text
                    ret += (f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                            f"{text}<|eot_id|>")
                else:
                    ret += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
            return ret

        if self.sep_style == SeparatorStyle.GEMMA:
            ret = ""
            for i, (role, message) in enumerate(messages):
                assert role == self.roles[i % 2], \
                    "Conversation should alternate user/assistant/..."
                if message:
                    ret += role + _msg_text(message) + self.sep
                else:
                    ret += role
            return ret

        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[x, y] for x, y in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
            tokenizer_id=self.tokenizer_id,
            tokenizer=self.tokenizer,
            stop_str=self.stop_str,
            stop_token_ids=self.stop_token_ids,
        )


# ---------------------------------------------------------------------------
# Template definitions (conversation.py:313-553) — strings are compat specs
# ---------------------------------------------------------------------------

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        [
            "Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n",
        ],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_3 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("user", "assistant"),
    version="llama_v3",
    messages=[],
    sep="<|eot_id|>",
    sep_style=SeparatorStyle.LLAMA_3,
    tokenizer_id="meta-llama/Meta-Llama-3-8B-Instruct",
    stop_token_ids=[128009],
)

conv_mistral_instruct = Conversation(
    system="",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
)

conv_llava_llama_2_simple = Conversation(
    system="Answer the questions about the visual content that the user provides.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2_mmtag = Conversation(
    system=(
        "Answer the questions about the visual content that the user provides."
        "The visual content will be provided with the following format: <Image>visual content</Image>."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2_mmtag",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    version="qwen",
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
)

conv_gemma_instruct = Conversation(
    system="",
    roles=("<start_of_turn>user\n", "<start_of_turn>model\n"),
    version="gemma",
    messages=[],
    sep_style=SeparatorStyle.GEMMA,
    sep="<end_of_turn>\n",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    version="plain",
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
        "The visual content will be provided with the following format: <Image>visual content</Image>."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
        "The visual content will be provided with the following format: <Image>visual content</Image>."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_mistral_orca = Conversation(
    system=(
        "<|im_start|>system\n"
        "You are MistralOrca, a large language model trained by Alignment Lab AI. Write out your reasoning step-by-step to be sure you get the right answers!"
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_mistral_zephyr = Conversation(
    system="<|system|>\nYou are a helpful AI assistant.",
    roles=("<|user|>\n", "<|assistant|>\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="</s>",
)

conv_mistral_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_chatml_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

# Registry: all 25 names over 21 templates (conversation.py:555-585)
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "mistral_orca": conv_mistral_orca,
    "mistral_zephyr": conv_mistral_zephyr,
    "mistral_direct": conv_mistral_direct,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_plain": conv_llava_plain,
    "chatml_direct": conv_chatml_direct,
    "llava_v0": conv_llava_v0,
    "llava_v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "llava_v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "llava_llama_3": conv_llava_llama_3,
    "llava_llama_2_simple": conv_llava_llama_2_simple,
    "llava_llama_2_mmtag": conv_llava_llama_2_mmtag,
    "llava_mistral_instruct": conv_mistral_instruct,
    "mpt": conv_mpt,
    "qwen_1_5": conv_qwen,
    "qwen_2": conv_qwen,
    "gemma_instruct": conv_gemma_instruct,
}

default_conversation = conv_qwen
