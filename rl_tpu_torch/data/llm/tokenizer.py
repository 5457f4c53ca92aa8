"""Self-contained word+char tokenizer for fixture-based RLHF recipes.

The reference's LLM stack assumes a HuggingFace ``transformers`` tokenizer
(reference: torchrl/envs/llm/chat.py tokenizer= plumbing, sota grpo recipes
load one from the hub). This image has no hub access, so recipes need a
local trainable tokenizer with the same surface (``encode``/``decode``/
``vocab_size``/special ids). Word-level with character fallback: every
corpus word gets an id, unknown strings degrade to per-character ids, so
round-trip ``decode(encode(s)) == s`` holds for any input over the trained
charset.
"""

from __future__ import annotations

import re
from typing import Iterable

__all__ = ["SimpleTokenizer"]

_SPLIT = re.compile(r"\w+|[^\w\s]|\s")


class SimpleTokenizer:
    """Trainable word+char tokenizer.

    ids: 0=pad, 1=bos, 2=eos, 3=unk, then single characters, then words.
    """

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, corpus: Iterable[str] = (), max_vocab: int = 4096):
        chars: set[str] = set()
        words: dict[str, int] = {}
        for text in corpus:
            chars.update(text)
            for w in _SPLIT.findall(text):
                if len(w) > 1:
                    words[w] = words.get(w, 0) + 1
        self._itos: list[str] = ["<pad>", "<bos>", "<eos>", "<unk>"]
        self._itos += sorted(chars)
        for w, _ in sorted(words.items(), key=lambda kv: (-kv[1], kv[0])):
            if len(self._itos) >= max_vocab:
                break
            self._itos.append(w)
        self._stoi = {s: i for i, s in enumerate(self._itos)}

    @property
    def vocab_size(self) -> int:
        return len(self._itos)

    @property
    def eos_token_id(self) -> int:
        return self.EOS

    @property
    def pad_token_id(self) -> int:
        return self.PAD

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for piece in _SPLIT.findall(text):
            tid = self._stoi.get(piece)
            if tid is not None:
                out.append(tid)
            else:  # character fallback (then UNK for untrained chars)
                out.extend(self._stoi.get(c, self.UNK) for c in piece)
        return out

    def decode(self, ids: Iterable[int]) -> str:
        return "".join(
            self._itos[i]
            for i in ids
            if 0 <= int(i) < len(self._itos) and int(i) not in (self.PAD, self.BOS, self.EOS)
        )
