"""Composable env transforms (counterpart of
:mod:`rl_tpu.envs.transforms.base`; ``Transform``, ``Compose`` and
``TransformedEnv`` are ported).

A transform is an object whose mutable state (running sums, counters)
is an explicit ArrayDict carried in the env state under
``"transforms"``, as in the reference:

- ``reset(tstate, td) -> (tstate, td)`` on a reset's output;
- ``step(tstate, next_td) -> (tstate, next_td)`` on a step's "next";
- ``inv(td) -> td`` on the input before the base env steps;
- ``on_done`` merges a fresh state into the carried one where an episode
  ended, and ``on_done_reset_td`` re-derives the reset output from the
  merged state.

:meth:`TransformedEnv.step_and_reset` follows the port's convention
(:mod:`rl_tpu_torch.envs.base`): one generator, and a reset drawn for
the whole batch on every step, kept where done.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...data.arraydict import ArrayDict
from ...data.specs import Composite, Spec
from ..base import EnvBase, EnvState, step_mdp, where_done

__all__ = ["Transform", "TransformedEnv", "Compose"]


class Transform:
    """Base transform: the identity everywhere."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def init(self, reset_td: ArrayDict) -> ArrayDict:
        """The initial carried state, shaped from a reset's output."""
        return ArrayDict()

    def reset(self, tstate: ArrayDict, td: ArrayDict) -> tuple[ArrayDict, ArrayDict]:
        return tstate, td

    def step(self, tstate: ArrayDict, next_td: ArrayDict) -> tuple[ArrayDict, ArrayDict]:
        return tstate, next_td

    def inv(self, td: ArrayDict) -> ArrayDict:
        return td

    def on_done(self, reset_tstate: ArrayDict, tstate: ArrayDict, done) -> ArrayDict:
        """Episodic state restarts where done (per-env masking); a transform
        with global state overrides this to keep the carried value."""
        return where_done(done, reset_tstate, tstate)

    def on_done_reset_td(self, tstate: ArrayDict, reset_td: ArrayDict) -> ArrayDict:
        return reset_td

    def transform_observation_spec(self, spec: Composite) -> Composite:
        return spec

    def transform_action_spec(self, spec: Spec) -> Spec:
        return spec

    def transform_reward_spec(self, spec: Spec) -> Spec:
        return spec

    def transform_done_spec(self, spec: Composite) -> Composite:
        return spec

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class Compose(Transform):
    """Transforms applied in order; their states under ``"t{i}"``."""

    def __init__(self, *transforms: Transform):
        self.transforms = list(transforms)

    def init(self, reset_td):
        out, td = ArrayDict(), reset_td
        for i, t in enumerate(self.transforms):
            ts, td = t.reset(t.init(td), td)
            out = out.set(f"t{i}", ts)
        return out

    def reset(self, tstate, td):
        out = ArrayDict()
        for i, t in enumerate(self.transforms):
            ts, td = t.reset(tstate[f"t{i}"], td)
            out = out.set(f"t{i}", ts)
        return out, td

    def step(self, tstate, next_td):
        out = ArrayDict()
        for i, t in enumerate(self.transforms):
            ts, next_td = t.step(tstate[f"t{i}"], next_td)
            out = out.set(f"t{i}", ts)
        return out, next_td

    def inv(self, td):
        for t in reversed(self.transforms):
            td = t.inv(td)
        return td

    def on_done(self, reset_tstate, tstate, done):
        out = ArrayDict()
        for i, t in enumerate(self.transforms):
            out = out.set(f"t{i}", t.on_done(reset_tstate[f"t{i}"], tstate[f"t{i}"], done))
        return out

    def on_done_reset_td(self, tstate, reset_td):
        for i, t in enumerate(self.transforms):
            reset_td = t.on_done_reset_td(tstate[f"t{i}"], reset_td)
        return reset_td

    def transform_observation_spec(self, spec):
        for t in self.transforms:
            spec = t.transform_observation_spec(spec)
        return spec

    def transform_action_spec(self, spec):
        for t in reversed(self.transforms):
            spec = t.transform_action_spec(spec)
        return spec

    def transform_reward_spec(self, spec):
        for t in self.transforms:
            spec = t.transform_reward_spec(spec)
        return spec

    def transform_done_spec(self, spec):
        for t in self.transforms:
            spec = t.transform_done_spec(spec)
        return spec

    def append(self, t: Transform) -> "Compose":
        return Compose(*self.transforms, t)

    def __repr__(self):
        return f"Compose({', '.join(map(repr, self.transforms))})"


class TransformedEnv(EnvBase):
    """An env with a transform pipeline. State ``{"env": base state,
    "transforms": transform state}``."""

    def __init__(self, env: EnvBase, transform: Transform | Sequence[Transform]):
        if isinstance(transform, (list, tuple)):
            transform = Compose(*transform)
        self.env = env
        self.transform = transform

    @property
    def base_env(self) -> EnvBase:
        return self.env

    @property
    def batch_shape(self):
        return self.env.batch_shape

    @property
    def observation_spec(self) -> Composite:
        return self.transform.transform_observation_spec(self.env.observation_spec)

    @property
    def action_spec(self) -> Spec:
        return self.transform.transform_action_spec(self.env.action_spec)

    @property
    def reward_spec(self) -> Spec:
        return self.transform.transform_reward_spec(self.env.reward_spec)

    @property
    def done_spec(self) -> Composite:
        return self.transform.transform_done_spec(self.env.done_spec)

    def reset(self, generator: torch.Generator):
        base_state, td = self.env.reset(generator)
        tstate, td = self.transform.reset(self.transform.init(td), td)
        return ArrayDict(env=base_state, transforms=tstate), td

    def step(self, state: EnvState, td: ArrayDict):
        base_state, out = self.env.step(state["env"], self.transform.inv(td))
        tstate, next_td = self.transform.step(state["transforms"], out["next"])
        # the input as given (not inv'ed) stays at the root
        return ArrayDict(env=base_state, transforms=tstate), td.set("next", next_td)

    def step_and_reset(self, state: EnvState, td: ArrayDict, generator: torch.Generator):
        """Step, then reset wherever done: the base env's state is masked
        per env, and each transform's state merges through
        :meth:`Transform.on_done`."""
        new_state, full_td = self.step(state, td)
        reset_state, reset_td = self.reset(generator)
        done = full_td["next", "done"]
        tstate = self.transform.on_done(reset_state["transforms"], new_state["transforms"], done)
        reset_td = self.transform.on_done_reset_td(tstate, reset_td)
        carry_td = where_done(done, reset_td, step_mdp(full_td))
        env_carry = where_done(done, reset_state["env"], new_state["env"])
        return ArrayDict(env=env_carry, transforms=tstate), full_td, carry_td

    def rand_action(self, td, generator):
        return td.set("action", self.action_spec.rand(self.batch_shape, generator))
