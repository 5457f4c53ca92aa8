"""CartPole balance (counterpart of :mod:`rl_tpu.envs.classic.cartpole`):
classic Gym CartPole-v1 dynamics written on batched tensors, with the
reference's Euler integration, 500-step truncation and termination at
|x| > 2.4 or |theta| > 12 degrees.

State ``physics = (x, x_dot, theta, theta_dot)`` and ``step_count``
(int32); action 0 (push left) or 1 (push right); reward 1.0 a step.
"""

from __future__ import annotations

import math

import torch

from ...data.arraydict import ArrayDict
from ...data.specs import Bounded, Categorical, Composite, Unbounded
from ..base import EnvBase

__all__ = ["CartPoleEnv"]


class CartPoleEnv(EnvBase):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5  # half pole length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, max_episode_steps: int = 500):
        self.max_episode_steps = max_episode_steps

    @property
    def observation_spec(self) -> Composite:
        high = torch.tensor([self.x_threshold * 2, 1e5, self.theta_threshold * 2, 1e5],
                            dtype=torch.float32)
        return Composite(observation=Bounded(shape=(4,), low=-high, high=high))

    @property
    def action_spec(self) -> Categorical:
        return Categorical(n=2)

    @property
    def state_spec(self) -> Composite:
        return Composite(physics=Unbounded(shape=(4,)),
                         step_count=Unbounded(shape=(), dtype=torch.int32))

    def _reset(self, generator, batch_shape):
        dev = generator.device
        u = torch.rand(tuple(batch_shape) + (4,), generator=generator, device=dev)
        physics = u * 0.1 - 0.05  # U(-0.05, 0.05)
        state = ArrayDict(physics=physics,
                          step_count=torch.zeros(batch_shape, dtype=torch.int32, device=dev))
        return state, ArrayDict(observation=physics)

    def _step(self, state, action):
        x, x_dot, theta, theta_dot = state["physics"].unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)

        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)

        count = state["step_count"] + 1
        terminated = (torch.abs(x) > self.x_threshold) | (torch.abs(theta) > self.theta_threshold)
        truncated = count >= self.max_episode_steps
        reward = torch.ones(count.shape, dtype=torch.float32, device=physics.device)
        new_state = ArrayDict(physics=physics, step_count=count)
        return new_state, ArrayDict(observation=physics), reward, terminated, truncated
