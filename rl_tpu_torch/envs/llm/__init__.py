"""Conversation environments, task datasets, reward scorers and reward
transforms for RLHF (copies of the GRPO slice's part of
:mod:`rl_tpu.envs.llm`)."""

from .chat import ChatEnv, DatasetChatEnv
from .datasets import QADataset, arithmetic_dataset
from .reward import ExactMatchScorer, SumScorer, combine_scorers
from .transforms import KLRewardTransform, PolicyVersion

__all__ = [
    "ChatEnv",
    "DatasetChatEnv",
    "ExactMatchScorer",
    "KLRewardTransform",
    "PolicyVersion",
    "QADataset",
    "SumScorer",
    "arithmetic_dataset",
    "combine_scorers",
]
