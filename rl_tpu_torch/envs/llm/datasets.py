"""Task datasets for RLHF recipes, generated locally: a copy of the part of
:mod:`rl_tpu.envs.llm.datasets` the GRPO slice uses (``QADataset``,
``arithmetic_dataset``).

Redesign of the reference's LLM task-dataset layer (reference:
torchrl/envs/llm/datasets/ — ``GSM8KEnv`` gsm8k.py, ``IFEvalEnv`` ifeval.py
load HF datasets and wrap them in DatasetChatEnv with a task scorer). The
zero-egress analog: deterministic generators produce (prompt History, answer)
pairs with the same QA shape, so the full tokenizer→env→GRPO recipe runs
against a verifiable ground truth.
"""

from __future__ import annotations

import numpy as np

from ...data.llm.history import History

__all__ = ["arithmetic_dataset", "QADataset"]


class QADataset:
    """(prompt, answer) pairs + the corpus to train a tokenizer on."""

    def __init__(self, items: list[tuple[str, str]], system: str | None = None):
        self.items = items
        self.system = system

    @property
    def prompts(self) -> list[History]:
        pre = [{"role": "system", "content": self.system}] if self.system else []
        return History.from_chats(
            [pre + [{"role": "user", "content": q}] for q, _ in self.items]
        )

    @property
    def answers(self) -> dict[str, str]:
        """question -> gold answer (scorers key on the question text)."""
        return {q: a for q, a in self.items}

    def corpus(self) -> list[str]:
        return [q for q, _ in self.items] + [a for _, a in self.items]


def arithmetic_dataset(
    n: int = 256, max_operand: int = 9, seed: int = 0, ops: str = "+"
) -> QADataset:
    """GSM8K-shaped single-step arithmetic: "3+5=" -> "8"."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        a, b = rng.integers(0, max_operand + 1, 2)
        op = ops[rng.integers(0, len(ops))]
        val = {"+": a + b, "-": a - b, "*": a * b}[op]
        items.append((f"{a}{op}{b}=", str(val)))
    return QADataset(items)
