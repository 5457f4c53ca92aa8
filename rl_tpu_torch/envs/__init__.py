"""Environments (counterpart of :mod:`rl_tpu.envs`; the LLM chat envs,
the env core with ``rollout``, ``VmapEnv``, CartPole, Pendulum and the
transform core with ``RewardSum`` and ``StepCounter`` are ported)."""

from .base import EnvBase, VmapEnv, rollout, step_mdp, where_done
from .classic import CartPoleEnv, PendulumEnv
from .transforms import Compose, RewardSum, StepCounter, Transform, TransformedEnv
from .utils import ExplorationType, exploration_type, set_exploration_type

__all__ = ["CartPoleEnv", "Compose", "EnvBase", "ExplorationType", "PendulumEnv", "RewardSum",
           "StepCounter", "Transform", "TransformedEnv", "VmapEnv", "exploration_type",
           "rollout", "set_exploration_type", "step_mdp", "where_done"]
