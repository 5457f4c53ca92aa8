"""Classic-control envs (counterpart of :mod:`rl_tpu.envs.classic`;
Pendulum is ported)."""

from .pendulum import PendulumEnv

__all__ = ["PendulumEnv"]
