"""Conversation environments for RLHF: a copy of
:mod:`rl_tpu.envs.llm.chat` (host-side, framework-free).

Redesign of the reference's LLM env layer (reference: torchrl/envs/llm/
chat.py:60 ``ChatEnv`` — conversation-state env over ``History``;
``DatasetChatEnv``:542; reward scorers under envs/llm/reward/).

These are **host-side** envs (strings and tokenizers never enter XLA): reset
serves tokenized prompts, step receives generated response tokens, decodes,
appends to the history, scores. The device side (generation, loss) consumes
the produced arrays; the :class:`rl_tpu.collectors.LLMCollector` owns the
handoff.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from ...data.llm.history import History

__all__ = ["ChatEnv", "DatasetChatEnv"]


class ChatEnv:
    """Single/multi-turn chat env over History.

    Args:
        tokenizer: object with ``encode(str)->list[int]`` and optionally
            ``decode(list[int])->str`` (identity fallback for token-level
            rewards).
        reward_fn: ``(history, response_tokens) -> float`` scored at each
            step (rule-based scorers, reward models, format checks).
        max_turns: episode ends after this many assistant turns.
    """

    def __init__(
        self,
        tokenizer: Any,
        reward_fn: Callable[[History, np.ndarray], float],
        max_prompt_len: int = 256,
        max_turns: int = 1,
    ):
        self.tokenizer = tokenizer
        self.reward_fn = reward_fn
        self.max_prompt_len = max_prompt_len
        self.max_turns = max_turns

    # -- protocol -------------------------------------------------------------

    def reset(self, histories: Sequence[History]) -> dict:
        """Tokenize prompt histories (left-padded, generation prompt added)."""
        batch = History.batch_tokenize(
            list(histories),
            self.tokenizer,
            max_len=self.max_prompt_len,
            add_generation_prompt=True,
        )
        return {
            "histories": list(histories),
            "turns": np.zeros(len(histories), np.int32),
            **batch,
        }

    def _score_one(self, history: History, tokens_row: np.ndarray, mask_row: np.ndarray) -> tuple[History, float]:
        toks = tokens_row[mask_row.astype(bool)]
        text = (
            self.tokenizer.decode(toks.tolist())
            if hasattr(self.tokenizer, "decode")
            else " ".join(map(str, toks.tolist()))
        )
        h2 = history.append("assistant", text)
        return h2, self.reward_fn(h2, toks)

    def score_rows(
        self,
        state: dict,
        response_tokens: np.ndarray,
        response_mask: np.ndarray,
        rows: Sequence[int],
    ) -> np.ndarray:
        """Score a SUBSET of the batch (first-come group harvesting: the
        collector scores each prompt group as its last response completes,
        overlapping host reward work with the remaining decode). Row
        arrays are indexed by the FULL batch position; returns rewards
        aligned with ``rows``. State histories are not advanced — this is
        the scoring half of :meth:`step` only."""
        rewards = np.zeros(len(rows), np.float32)
        for j, i in enumerate(rows):
            _, rewards[j] = self._score_one(
                state["histories"][i], response_tokens[i], response_mask[i]
            )
        return rewards

    def step(self, state: dict, response_tokens: np.ndarray, response_mask: np.ndarray) -> tuple[dict, np.ndarray, np.ndarray]:
        """Append responses, score, report done. Returns (state, reward, done)."""
        histories = []
        rewards = np.zeros(len(state["histories"]), np.float32)
        for i, h in enumerate(state["histories"]):
            h2, rewards[i] = self._score_one(h, response_tokens[i], response_mask[i])
            histories.append(h2)
        turns = state["turns"] + 1
        done = turns >= self.max_turns
        new_state = dict(state)
        new_state.update(histories=histories, turns=turns)
        return new_state, rewards, done


class DatasetChatEnv(ChatEnv):
    """ChatEnv over a prompt dataset (reference DatasetChatEnv:542): each
    reset draws a batch of prompts (optionally repeated ``group_repeats``
    times for GRPO prompt groups)."""

    def __init__(
        self,
        prompts: Sequence[History],
        tokenizer: Any,
        reward_fn: Callable,
        group_repeats: int = 1,
        seed: int = 0,
        **kw,
    ):
        super().__init__(tokenizer, reward_fn, **kw)
        self.prompts = list(prompts)
        self.group_repeats = group_repeats
        self._rng = np.random.default_rng(seed)

    def sample_batch(self, num_prompts: int) -> tuple[dict, np.ndarray]:
        """Draw prompts and repeat each ``group_repeats`` times.
        Returns (reset state, group_ids [num_prompts*repeats])."""
        idx = self._rng.integers(0, len(self.prompts), num_prompts)
        hs = []
        gids = []
        for g, i in enumerate(idx):
            for _ in range(self.group_repeats):
                hs.append(self.prompts[int(i)])
                gids.append(g)
        return self.reset(hs), np.asarray(gids, np.int32)
