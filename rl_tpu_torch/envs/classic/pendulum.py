"""Pendulum swing-up (counterpart of :mod:`rl_tpu.envs.classic.pendulum`):
the same dynamics, reward, torque clip and 200-step truncation, written
on batched tensors.

State (theta, theta_dot, step_count); action torque in [-2, 2]; reward
-(normalized theta^2 + 0.1 theta_dot^2 + 0.001 u^2).
"""

from __future__ import annotations

import math

import torch

from ...data.arraydict import ArrayDict
from ...data.specs import Bounded, Composite, Unbounded
from ..base import EnvBase

__all__ = ["PendulumEnv"]


def _angle_normalize(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class PendulumEnv(EnvBase):
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps

    @property
    def observation_spec(self) -> Composite:
        return Composite(observation=Bounded(
            shape=(3,), low=[-1.0, -1.0, -self.max_speed], high=[1.0, 1.0, self.max_speed]))

    @property
    def action_spec(self) -> Bounded:
        return Bounded(shape=(1,), low=-self.max_torque, high=self.max_torque)

    @property
    def state_spec(self) -> Composite:
        return Composite(theta=Unbounded(shape=()), theta_dot=Unbounded(shape=()),
                         step_count=Unbounded(shape=(), dtype=torch.int32))

    def _obs(self, theta, theta_dot) -> ArrayDict:
        return ArrayDict(observation=torch.stack(
            [torch.cos(theta), torch.sin(theta), theta_dot], dim=-1))

    def _reset(self, generator, batch_shape):
        dev = generator.device
        theta = torch.rand(batch_shape, generator=generator, device=dev) * (2 * math.pi) - math.pi
        theta_dot = torch.rand(batch_shape, generator=generator, device=dev) * 2.0 - 1.0
        state = ArrayDict(theta=theta, theta_dot=theta_dot,
                          step_count=torch.zeros(batch_shape, dtype=torch.int32, device=dev))
        return state, self._obs(theta, theta_dot)

    def _step(self, state, action):
        th, thdot = state["theta"], state["theta_dot"]
        u = torch.clamp(action.squeeze(-1), -self.max_torque, self.max_torque)
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3.0 * self.g / (2.0 * self.length) * torch.sin(th)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        count = state["step_count"] + 1
        new_state = ArrayDict(theta=newth, theta_dot=newthdot, step_count=count)
        truncated = count >= self.max_episode_steps
        terminated = torch.zeros_like(truncated)
        return new_state, self._obs(newth, newthdot), -cost, terminated, truncated
