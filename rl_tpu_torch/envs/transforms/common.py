"""Core transforms (counterpart of :mod:`rl_tpu.envs.transforms.common`;
``RewardSum`` and ``StepCounter`` are ported)."""

from __future__ import annotations

import torch

from ..._stubs import not_ported
from ...data.arraydict import ArrayDict
from ...data.specs import Unbounded
from .base import Transform

__all__ = ["RewardSum", "StepCounter"]


class RewardSum(Transform):
    """The episode's return so far, as ``"episode_reward"``: carried in the
    transform state and zeroed where the episode ends."""

    def init(self, reset_td):
        done = reset_td["done"]
        return ArrayDict(episode_reward=torch.zeros(done.shape, dtype=torch.float32,
                                                    device=done.device))

    def reset(self, tstate, td):
        return tstate, td.set("episode_reward", tstate["episode_reward"])

    def step(self, tstate, next_td):
        total = tstate["episode_reward"] + next_td["reward"]
        carry = torch.where(next_td["done"], 0.0, total)
        return ArrayDict(episode_reward=carry), next_td.set("episode_reward", total)

    def transform_observation_spec(self, spec):
        return spec.set("episode_reward", Unbounded(shape=()))


class StepCounter(Transform):
    """Steps since reset, as ``"step_count"``; with ``max_steps`` the
    episode is truncated there."""

    def __init__(self, max_steps: int | None = None):
        self.max_steps = max_steps

    def init(self, reset_td):
        done = reset_td["done"]
        return ArrayDict(step_count=torch.zeros(done.shape, dtype=torch.int32,
                                                device=done.device))

    def reset(self, tstate, td):
        return tstate, td.set("step_count", tstate["step_count"])

    def step(self, tstate, next_td):
        count = tstate["step_count"] + 1
        out = next_td.set("step_count", count)
        if self.max_steps is not None:
            trunc = out["truncated"] | (count >= self.max_steps)
            out = out.set("truncated", trunc).set("done", out["terminated"] | trunc)
        carry = torch.where(out["done"], 0, count)
        return ArrayDict(step_count=carry), out

    def transform_observation_spec(self, spec):
        return spec.set("step_count", Unbounded(shape=(), dtype=torch.int32))


_ROADMAP = "A7: the remaining transforms"
ObservationNorm = not_ported("ObservationNorm", __name__, _ROADMAP)
RewardScaling = not_ported("RewardScaling", __name__, _ROADMAP)
RewardClipping = not_ported("RewardClipping", __name__, _ROADMAP)
InitTracker = not_ported("InitTracker", __name__, _ROADMAP)
CatFrames = not_ported("CatFrames", __name__, _ROADMAP)
FlattenObservation = not_ported("FlattenObservation", __name__, _ROADMAP)
DTypeCast = not_ported("DTypeCast", __name__, _ROADMAP)
DoubleToFloat = not_ported("DoubleToFloat", __name__, _ROADMAP)
RenameTransform = not_ported("RenameTransform", __name__, _ROADMAP)
CatTensors = not_ported("CatTensors", __name__, _ROADMAP)
UnsqueezeTransform = not_ported("UnsqueezeTransform", __name__, _ROADMAP)
SqueezeTransform = not_ported("SqueezeTransform", __name__, _ROADMAP)
ActionScaling = not_ported("ActionScaling", __name__, _ROADMAP)
TimeMaxPool = not_ported("TimeMaxPool", __name__, _ROADMAP)
