"""Env transforms (counterpart of :mod:`rl_tpu.envs.transforms`; the
transform core, ``RewardSum`` and ``StepCounter`` are ported)."""

from .base import Compose, Transform, TransformedEnv
from .common import RewardSum, StepCounter

__all__ = ["Compose", "RewardSum", "StepCounter", "Transform", "TransformedEnv"]
