"""Environment core (counterpart of :mod:`rl_tpu.envs.base`; ``EnvBase``,
``where_done``, ``step_mdp``, ``rollout`` and ``VmapEnv`` are ported).

As in the reference, an env is a function of an explicit state:

- ``reset(generator) -> (state, td)``
- ``step(state, td_with_action) -> (state, td)``, the returned ``td``
  holding the pre-step content plus ``"next"`` (observations, reward,
  done, terminated, truncated);
- ``step_and_reset(state, td, generator)`` steps, then resets wherever the
  episode ended, with a masked ``torch.where`` over the whole batch.

Randomness comes from the ``torch.Generator`` the caller passes, one for
the whole batch of envs (the reference carries a PRNG key per env in the
state; ROADMAP queue C). ``_step`` and ``_reset`` are written on tensors of
any leading batch shape, so :class:`VmapEnv` is a batch dimension, not a
``vmap``.
"""

from __future__ import annotations

import torch

from typing import Callable

from ..data.arraydict import ArrayDict
from ..data.specs import Binary, Composite, Spec, Unbounded

__all__ = ["EnvBase", "VmapEnv", "EnvState", "rollout", "step_mdp", "where_done"]

EnvState = ArrayDict


class EnvBase:
    """Functional environment.

    Subclasses implement ``_reset(generator, batch_shape) -> (state,
    obs_td)`` and ``_step(state, action) -> (state, obs_td, reward,
    terminated, truncated)`` on tensors with leading ``batch_shape``, and
    the spec properties.
    """

    @property
    def observation_spec(self) -> Composite:
        raise NotImplementedError

    @property
    def action_spec(self) -> Spec:
        raise NotImplementedError

    @property
    def reward_spec(self) -> Spec:
        return Unbounded(shape=(), dtype=torch.float32)

    @property
    def done_spec(self) -> Composite:
        return Composite(done=Binary(shape=()), terminated=Binary(shape=()),
                         truncated=Binary(shape=()))

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return ()

    def _reset(self, generator: torch.Generator, batch_shape: tuple[int, ...]):
        raise NotImplementedError

    def _step(self, state: ArrayDict, action: torch.Tensor):
        raise NotImplementedError

    def reset(self, generator: torch.Generator) -> tuple[EnvState, ArrayDict]:
        """Start episodes on the generator's device: ``(state, td)`` with
        the observations and all-false done flags."""
        state, obs = self._reset(generator, self.batch_shape)
        zero = torch.zeros(self.batch_shape, dtype=torch.bool, device=generator.device)
        return state, obs.update(ArrayDict(done=zero, terminated=zero, truncated=zero))

    def step(self, state: EnvState, td: ArrayDict) -> tuple[EnvState, ArrayDict]:
        new_state, obs, reward, terminated, truncated = self._step(state, td["action"])
        next_td = obs.update(ArrayDict(
            reward=reward.to(torch.float32), terminated=terminated.to(torch.bool),
            truncated=truncated.to(torch.bool)))
        next_td = next_td.set("done", next_td["terminated"] | next_td["truncated"])
        return new_state, td.set("next", next_td)

    def step_and_reset(self, state: EnvState, td: ArrayDict, generator: torch.Generator
                       ) -> tuple[EnvState, ArrayDict, ArrayDict]:
        """Step, then reset wherever the episode ended. Returns
        ``(carry_state, full_td, carry_td)``: ``full_td`` is the transition
        (its "next" holds the terminal observation), ``carry_td`` the
        observation to act on next. Every step draws a reset for the whole
        batch and keeps it where done, so the draws do not depend on the
        data."""
        new_state, full_td = self.step(state, td)
        reset_state, reset_td = self.reset(generator)
        done = full_td["next", "done"]
        carry_td = where_done(done, reset_td, step_mdp(full_td))
        carry_state = where_done(done, reset_state, new_state)
        return carry_state, full_td, carry_td

    def rand_action(self, td: ArrayDict, generator: torch.Generator) -> ArrayDict:
        return td.set("action", self.action_spec.rand(self.batch_shape, generator))

    def rollout(self, generator: torch.Generator, policy: Callable | None = None,
                max_steps: int = 100, auto_reset: bool = True,
                break_when_any_done: bool = False) -> ArrayDict:
        return rollout(self, generator, policy, max_steps=max_steps, auto_reset=auto_reset,
                       break_when_any_done=break_when_any_done)


def where_done(done: torch.Tensor, on_done: ArrayDict, on_not_done: ArrayDict) -> ArrayDict:
    """Leaf-wise ``where`` with ``done`` broadcast over trailing feature
    dims; a leaf with fewer dims than ``done`` keeps ``on_not_done``."""

    def pick(path, b):
        a = on_done[path]
        if a.dim() < done.dim():
            return b
        d = done.reshape(done.shape + (1,) * (a.dim() - done.dim()))
        return torch.where(d, a, b)

    return on_not_done.named_apply(pick)


def step_mdp(td: ArrayDict) -> ArrayDict:
    """The "next" content moved to the root for the following step
    (reward dropped)."""
    return td["next"].exclude("reward")


class VmapEnv(EnvBase):
    """``num_envs`` copies of a scalar env as one batch (the reference's
    ``jax.vmap`` of the scalar env)."""

    def __init__(self, env: EnvBase, num_envs: int):
        if env.batch_shape != ():
            raise ValueError("VmapEnv wraps scalar (unbatched) envs")
        self.env = env
        self.num_envs = num_envs

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return (self.num_envs,)

    @property
    def observation_spec(self) -> Composite:
        return self.env.observation_spec

    @property
    def action_spec(self) -> Spec:
        return self.env.action_spec

    @property
    def reward_spec(self) -> Spec:
        return self.env.reward_spec

    @property
    def done_spec(self) -> Composite:
        return self.env.done_spec

    def _reset(self, generator, batch_shape):
        return self.env._reset(generator, batch_shape)

    def _step(self, state, action):
        return self.env._step(state, action)


@torch.no_grad()
def rollout(env: EnvBase, generator: torch.Generator, policy: Callable | None = None,
            max_steps: int = 100, auto_reset: bool = True, break_when_any_done: bool = False,
            init: tuple[EnvState, ArrayDict] | None = None,
            policy_state: ArrayDict | None = None) -> ArrayDict:
    """``max_steps`` steps of ``policy`` and the env, time-major:
    ``out.batch_shape == (max_steps, *env.batch_shape)`` in the
    ``{..., "next": ...}`` layout. ``policy`` is ``(td, generator) -> td``
    writing "action"; ``None`` takes random actions.

    ``policy_state`` seeds a stateful policy's carry under
    ``td["exploration"]``: carried from step to step and left out of the
    recorded batch. With ``break_when_any_done`` the run keeps its length
    and a ``"mask"`` leaf marks the steps up to and including the first on
    which any env is done (the reference's static-length form of stopping
    early)."""
    if policy is None:
        policy = env.rand_action
    state, td = init if init is not None else env.reset(generator)
    if policy_state is not None:
        td = td.set("exploration", policy_state)
    alive = torch.ones((), dtype=torch.bool, device=generator.device)
    steps = []
    for _ in range(max_steps):
        td = policy(td, generator)
        td_env = td.exclude("exploration")
        if auto_reset:
            state, full_td, carry_td = env.step_and_reset(state, td_env, generator)
        else:
            state, full_td = env.step(state, td_env)
            carry_td = step_mdp(full_td)
        if "exploration" in td:
            carry_td = carry_td.set("exploration", td["exploration"])
        if break_when_any_done:
            full_td = full_td.set("mask", alive)
            alive = alive & ~torch.any(full_td["next", "done"])
        steps.append(full_td)
        td = carry_td
    return ArrayDict.stack(steps, 0)
