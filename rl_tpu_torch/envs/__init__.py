"""Environments (counterpart of :mod:`rl_tpu.envs`; the LLM chat envs,
the env core, ``VmapEnv`` and Pendulum are ported)."""

from .base import EnvBase, VmapEnv, step_mdp, where_done
from .classic import PendulumEnv
from .utils import ExplorationType, exploration_type, set_exploration_type

__all__ = ["EnvBase", "ExplorationType", "PendulumEnv", "VmapEnv", "exploration_type",
           "set_exploration_type", "step_mdp", "where_done"]
