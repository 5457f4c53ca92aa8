"""Reward scorers for chat envs: a copy of the part of
:mod:`rl_tpu.envs.llm.reward` the GRPO slice uses.

Redesign of the reference's LLM reward layer (reference:
torchrl/envs/llm/reward/gsm8k.py ``GSM8KRewardParser`` — parse the assistant
turn, compare to gold, shaped partial credit; ifeval/ scorers). Scorers are
plain callables ``(history, response_tokens) -> float`` plugged into
ChatEnv's ``reward_fn``.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

__all__ = ["ExactMatchScorer", "SumScorer", "combine_scorers"]


def _last_user(history) -> str:
    for m in reversed(history.messages):
        if m.role == "user":
            return m.content
    return ""


def _assistant_text(history) -> str:
    m = history.last
    return m.content if m is not None and m.role == "assistant" else ""


class ExactMatchScorer:
    """1.0 if the stripped assistant turn equals the gold answer for the
    question, else optional partial credit when the gold appears anywhere
    (the reference parser's shaped scoring)."""

    def __init__(self, answers: dict[str, str], partial: float = 0.2):
        self.answers = answers
        self.partial = partial

    def __call__(self, history, response_tokens) -> float:
        gold = self.answers.get(_last_user(history))
        if gold is None:
            return 0.0
        text = _assistant_text(history).strip()
        if text == gold.strip():
            return 1.0
        return self.partial if gold.strip() and gold.strip() in text else 0.0


class SumScorer:
    """Dense arithmetic credit: 1 / (1 + |predicted - gold|) over the first
    integer in the response (smooth learning signal vs exact match)."""

    def __init__(self, answers: dict[str, str]):
        self.answers = answers

    def __call__(self, history, response_tokens) -> float:
        gold = self.answers.get(_last_user(history))
        if gold is None:
            return 0.0
        gm = re.search(r"-?\d+", gold)
        m = re.search(r"-?\d+", _assistant_text(history))
        if not m or not gm:
            return 0.0
        return 1.0 / (1.0 + abs(int(m.group()) - int(gm.group())))


def combine_scorers(*scorers: Callable, weights: Sequence[float] | None = None):
    ws = list(weights) if weights is not None else [1.0] * len(scorers)

    def scorer(history, response_tokens) -> float:
        return float(sum(w * s(history, response_tokens) for w, s in zip(ws, scorers)))

    return scorer
