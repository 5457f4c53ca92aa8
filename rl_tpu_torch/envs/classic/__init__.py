"""Classic-control envs (counterpart of :mod:`rl_tpu.envs.classic`;
CartPole and Pendulum are ported)."""

from .cartpole import CartPoleEnv
from .pendulum import PendulumEnv

__all__ = ["CartPoleEnv", "PendulumEnv"]
