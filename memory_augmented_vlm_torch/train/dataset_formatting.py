"""Dataset auto-formatting for the SFT path — the capability of the
reference's vendored TRL `trl/extras/dataset_formatting.py:16-89`: inspect a
dataset's schema and return a formatting callable that renders each example
to a chat-templated string, or None when the schema is not recognized.

Schemas recognized (dataset_formatting.py:10-13 FORMAT_MAPPING):
  - ChatML: a "messages" or "conversations" column of
    [{"role": str, "content": str}, ...]
  - instruction: {"prompt": str, "completion": str} columns

Instead of `tokenizer.apply_chat_template`, rendering goes through this
framework's conversation registry (`data/conversation.py`, byte-exact vs the
reference templates; the port's copy of it) — default `qwen_1_5` ChatML, the flagship recipe's
template. Works on plain lists of dicts (no `datasets` dependency); an HF
`datasets.Dataset` also works since it exposes `column_names` and mapping
rows.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from memory_augmented_vlm_torch.data.conversation import conv_templates

_ROLE_KEYS = ("role", "from")
_TEXT_KEYS = ("content", "value")


def _get(msg: dict, keys) -> Optional[str]:
    for k in keys:
        if k in msg:
            return msg[k]
    return None


def _render_chat(messages: Sequence[dict], template: str) -> str:
    """Render [{"role", "content"}] through a conversation template (the
    apply_chat_template role, dataset_formatting.py:25-29)."""
    conv = conv_templates[template].copy()
    role_map = {"user": conv.roles[0], "human": conv.roles[0],
                "assistant": conv.roles[1], "gpt": conv.roles[1]}
    for msg in messages:
        role = _get(msg, _ROLE_KEYS)
        text = _get(msg, _TEXT_KEYS)
        if role is None or text is None:
            raise ValueError(f"malformed chat message: {msg!r}")
        if role == "system":
            # the template's system string embeds its role header (e.g.
            # "<|im_start|>system\n..."); keep the header, swap the text
            head, nl, _ = conv.system.partition("\n")
            conv.system = head + nl + text if nl else text
            continue
        mapped = role_map.get(role.lower())
        if mapped is None:
            # an unmapped role would render a malformed template (e.g.
            # ChatML body with no '<|im_start|>' header) — fail loudly
            raise ValueError(
                f"unknown chat role {role!r}; expected one of "
                f"{sorted(role_map)} or 'system'")
        conv.append_message(mapped, text)
    return conv.get_prompt()


def conversations_formatting_function(
        messages_field: str, template: str = "qwen_1_5") -> Callable:
    """Formatting fn for ChatML-style datasets
    (dataset_formatting.py:16-31). Accepts one example or a batch (a list
    under `messages_field`, or a list of such lists)."""

    def format_dataset(examples) -> Union[str, List[str]]:
        field = examples[messages_field]
        if field and isinstance(field[0], list):
            return [_render_chat(m, template) for m in field]
        return _render_chat(field, template)

    return format_dataset


def instructions_formatting_function(template: str = "qwen_1_5") -> Callable:
    """Formatting fn for {"prompt", "completion"} datasets
    (dataset_formatting.py:34-57)."""

    def format_dataset(examples) -> Union[str, List[str]]:
        prompt = examples["prompt"]
        if isinstance(prompt, list):
            return [
                _render_chat([{"role": "user", "content": p},
                              {"role": "assistant", "content": c}], template)
                for p, c in zip(prompt, examples["completion"])
            ]
        return _render_chat(
            [{"role": "user", "content": prompt},
             {"role": "assistant", "content": examples["completion"]}],
            template)

    return format_dataset


def _columns(dataset) -> Optional[Sequence[str]]:
    cols = getattr(dataset, "column_names", None)
    if cols is not None:
        return cols
    if isinstance(dataset, Sequence) and dataset and isinstance(dataset[0], dict):
        return list(dataset[0].keys())
    return None


def get_formatting_func_from_dataset(
        dataset, template: str = "qwen_1_5") -> Optional[Callable]:
    """Schema sniffing (dataset_formatting.py:60-89): returns the matching
    formatting function, or None for unrecognized schemas."""
    cols = _columns(dataset)
    if cols is None:
        return None
    for field in ("messages", "conversations"):
        if field in cols:
            return conversations_formatting_function(field, template)
    if "prompt" in cols and "completion" in cols:
        return instructions_formatting_function(template)
    return None
