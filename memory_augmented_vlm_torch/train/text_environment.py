"""Tool-augmented rollout environment (counterpart of
`memory_augmented_vlm_tpu/train/text_environment.py`, the capability of
TRL's `TextEnvironment`, trl/environment/base_environment.py:59-463): the
LM interacts with a set of tools over multiple turns using the
`<request><ToolName>query<call>` protocol, tool outputs are spliced back as
system segments, and the episode ends on `<submit>`, EOS, malformed turns,
`max_turns`, or `max_length` truncation. `run()` returns the PPO-ready
(query, response, mask, reward) split: system-segment tokens are masked out
of the response so only model-generated tokens are optimized
(base_environment.py:133-143,288-290).

Reference semantics mirrored:
  - prompt is prepended to every task (run, :272);
  - a model turn that contains neither a complete request/call pair nor
    `<submit>` ends the episode (task_end_check, :394-399);
  - tool responses truncate to `max_tool_response - 3` chars + "..."
    (step, :316-317) and append as `response + "<response>"` system text;
  - malformed calls yield "Unknown tool call: ...", unknown tool names yield
    "Unknown tool ...", tool exceptions yield "Tool error: ..." (step,
    :306-314; the reference's unknown-tool branch is overwritten by a
    KeyError from its unconditional try block: JAX, and this port, keep the
    intended message);
  - reward is computed once per episode on the last text segment
    (compute_reward, :355-361).

Each model turn decodes all active histories as one batch through
`vlm.generate_batched`, each row stopping on its own `<call>`/`<submit>`
token suffix; a turn whose decoded text runs past a marker (markers that
are not atomic tokens of the user's tokenizer) is trimmed there and
re-encoded. The host bookkeeping is Python and numpy, as in JAX.
`generate_fn` is pluggable for scripted tests and custom decode stacks.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, vlm

REQUEST_TOKEN = "<request>"
CALL_TOKEN = "<call>"
RESPONSE_TOKEN = "<response>"
SUBMIT_TOKEN = "<submit>"


class TextHistory:
    """One episode: text/token segments with system-vs-model provenance
    (base_environment.py:59-143)."""

    def __init__(self, text: str, tokens: Sequence[int], system: bool = True):
        self.text = ""
        self.tokens: List[int] = []
        self.text_spans: List[Tuple[int, int]] = []
        self.token_spans: List[Tuple[int, int]] = []
        self.system_spans: List[bool] = []
        self.token_masks: List[int] = []
        self.completed = False
        self.truncated = False
        self.reward = 0.0
        self.append_segment(text, tokens, system=system)

    def append_segment(self, text: str, tokens: Sequence[int], system: bool = True):
        if len(text) == 0 or len(tokens) == 0:
            raise ValueError("Can't append empty text or token list to history.")
        self.text_spans.append((len(self.text), len(self.text) + len(text)))
        self.text += text
        self.token_spans.append((len(self.tokens), len(self.tokens) + len(tokens)))
        self.tokens.extend(int(t) for t in tokens)
        self.token_masks.extend([0 if system else 1] * len(tokens))
        self.system_spans.append(system)

    def complete(self, truncated: bool = False):
        self.completed = True
        self.truncated = truncated

    @property
    def last_text_segment(self) -> str:
        start, end = self.text_spans[-1]
        return self.text[start:end]

    def split_query_response_tokens(self):
        """(query tokens, response tokens, response mask): mask 1 on
        model-generated tokens only (base_environment.py:133-143)."""
        split = self.token_spans[0][1]
        return (np.asarray(self.tokens[:split], np.int32),
                np.asarray(self.tokens[split:], np.int32),
                np.asarray(self.token_masks[split:], np.int32))


class TextEnvironment:
    def __init__(
        self,
        params=None,
        cfg: Optional[VLMConfig] = None,
        *,
        encode: Callable[[str], List[int]],
        decode: Callable[[Sequence[int]], str],
        tools: Union[Dict[str, Callable[[str], str]], Sequence[Callable]],
        reward_fn: Callable[..., List[float]],
        prompt: str = "",
        eos_text: str = "<|im_end|>",
        eos_token_ids: Sequence[int] = (151645,),
        max_turns: int = 4,
        max_tool_response: int = 100,
        max_length: Optional[int] = None,
        max_new_tokens: int = 64,
        generate_fn: Optional[Callable] = None,
        generation_kwargs: Optional[dict] = None,
    ):
        """`encode`/`decode` play the tokenizer role (tokenizer-agnostic).
        `generate_fn(token_rows: List[List[int]]) -> List[List[int]]`
        overrides the default batched decode (scripted tests, custom
        stacks); `generation_kwargs` go to `vlm.generate_batched`."""
        self.params, self.cfg = params, cfg
        self.encode, self.decode = encode, decode
        if isinstance(tools, dict):
            self.tools = dict(tools)
        else:
            self.tools = {t.__class__.__name__: t for t in tools}
        self.reward_fn = reward_fn
        self.prompt = prompt
        self.eos_text = eos_text
        self.eos_token_ids = tuple(int(t) for t in eos_token_ids)
        self.max_turns = int(max_turns)
        self.max_tool_response = int(max_tool_response)
        self.max_length = max_length
        self.max_new_tokens = int(max_new_tokens)
        self.generation_kwargs = dict(generation_kwargs or {})
        self._generate_fn = generate_fn
        if generate_fn is None and (params is None or cfg is None):
            raise ValueError("params+cfg required without a custom generate_fn")

    # -- rollout loop (base_environment.py:263-292) --------------------------

    def run(self, queries: Sequence[str], **reward_kwargs):
        texts = [self.prompt + task for task in queries]
        histories = [TextHistory(t, self.encode(t), system=True) for t in texts]
        turns = 0
        while any(not h.completed for h in histories) and turns < self.max_turns:
            histories = self._generate(histories)
            self.tasks_end_check(histories)
            for i in range(len(histories)):
                histories[i] = self.step(histories[i])
            self.tasks_end_check(histories, model_turn=False)
            turns += 1
        self.compute_reward(histories, **reward_kwargs)
        queries_t, responses_t, masks_t = map(
            list, zip(*[h.split_query_response_tokens() for h in histories]))
        rewards = [h.reward for h in histories]
        return queries_t, responses_t, masks_t, rewards, histories

    def step(self, history: TextHistory) -> TextHistory:
        truncated, ended = self.task_end_check(history)
        if ended:
            history.complete(truncated=truncated)
        if history.completed:
            return history
        tool, query = self.parse_tool_call(history.last_text_segment)
        if tool is None or query is None:
            response = f"Unknown tool call: {history.last_text_segment}"
        elif tool not in self.tools:
            response = f"Unknown tool {tool}."
        else:
            try:
                response = self.tools[tool](query)
            except Exception as error:  # noqa: BLE001 (tool errors feed back)
                response = f"Tool error: {str(error)}"
        if len(response) > self.max_tool_response:
            response = response[: self.max_tool_response - 3] + "..."
        text = response + RESPONSE_TOKEN
        history.append_segment(text, self.encode(text), system=True)
        return history

    @staticmethod
    def _trim_at_stop(text: str) -> str:
        """Cut a decoded model turn just after the earliest stop marker."""
        cuts = [text.index(m) + len(m)
                for m in (CALL_TOKEN, SUBMIT_TOKEN) if m in text]
        return text[: min(cuts)] if cuts else text

    @staticmethod
    def parse_tool_call(text: str):
        """`<request><ToolName>query<call>` -> (tool, query)
        (base_environment.py:329-352)."""
        result = re.search(f"(?<={REQUEST_TOKEN}).*?(?={CALL_TOKEN})", text, re.DOTALL)
        if result is None:
            return None, None
        extracted = result.group()
        name = re.search(r"<(.*?)>", extracted)
        if name is None:
            return None, None
        return name.group(1), ">".join(extracted.split(">")[1:])

    def compute_reward(self, histories, **reward_kwargs):
        rewards = self.reward_fn(
            [h.last_text_segment for h in histories], **reward_kwargs)
        for h, r in zip(histories, rewards):
            h.reward = float(r)
        return histories

    # -- end checks (base_environment.py:376-400) ----------------------------

    def tasks_end_check(self, histories, model_turn: bool = True):
        for h in histories:
            if not h.completed:
                truncated, ended = self.task_end_check(h, model_turn=model_turn)
                if ended:
                    h.complete(truncated=truncated)
        return histories

    def task_end_check(self, history: TextHistory, model_turn: bool = True):
        if history.completed:
            return False, False
        if self.max_length is not None and len(history.tokens) > self.max_length:
            return True, True
        if self.eos_text in history.text:
            return False, True
        last = history.last_text_segment
        if model_turn and not (
                (REQUEST_TOKEN in last and CALL_TOKEN in last)
                or SUBMIT_TOKEN in last):
            return False, True
        if SUBMIT_TOKEN in last:
            return False, True
        return False, False

    # -- model turn ----------------------------------------------------------

    def _generate(self, histories):
        active = [i for i, h in enumerate(histories) if not h.completed]
        if not active:
            return histories
        rows = [histories[i].tokens for i in active]
        outs = (self._generate_fn(rows) if self._generate_fn is not None
                else self._generate_batched(rows))
        for i, out in zip(active, outs):
            out = [int(t) for t in out]
            if out:
                text = self.decode(out)
                trimmed = self._trim_at_stop(text)
                if trimmed != text:
                    # the reference's StringStoppingCriteria on the host: when
                    # the markers are not atomic tokens of the user's
                    # tokenizer the token-suffix stop never fires, so cut the
                    # decoded text at the first marker and re-encode it, which
                    # keeps the history's text and tokens consistent
                    text = trimmed
                    out = [int(t) for t in self.encode(text)]
                histories[i].append_segment(text, out, system=False)
            else:
                # an empty turn holds no request: the episode ends here, as
                # the reference's no-request rule ends it
                histories[i].complete()
        return histories

    def _generate_batched(self, token_rows: List[List[int]]) -> List[List[int]]:
        """One batched decode over all active histories (right-padded to a
        multiple of 128 rows), each row stopping on its own
        `<call>`/`<submit>` suffix."""
        stop_seqs = tuple(
            tuple(self.encode(s)) for s in (CALL_TOKEN, SUBMIT_TOKEN))
        lens = [len(r) for r in token_rows]
        smax = ((max(lens) + 127) // 128) * 128
        lm = self.params["language_model"]
        dev = lm["embed_tokens"].device
        embeds = torch.stack([
            F.pad(qwen2.embed_tokens(lm, torch.as_tensor(r, dtype=torch.long, device=dev),
                                     self.cfg.lm), (0, 0, 0, smax - len(r)))
            for r in token_rows])
        out = vlm.generate_batched(
            self.params, self.cfg, embeds, torch.as_tensor(lens, dtype=torch.int32),
            max_new_tokens=self.max_new_tokens, eos_token_ids=self.eos_token_ids,
            stop_sequences=stop_seqs, **self.generation_kwargs)
        tokens = out.tokens.cpu().numpy()
        counts = out.num_tokens.cpu().numpy()
        return [list(tokens[i, : counts[i]]) for i in range(len(token_rows))]
