"""Single-process collector (counterpart of :mod:`rl_tpu.collectors.single`).

``collect(cstate)`` runs ``scan_length = frames_per_batch / num_envs``
steps of policy + ``env.step_and_reset`` in a Python loop (the
reference's ``lax.scan``) and returns a time-major ``[T, *env_batch, ...]``
batch in the ``{..., "next": ...}`` layout, with the reference's
``("collector", "traj_ids")`` bookkeeping: a new id wherever an episode
ended, counted from ``traj_count``. Nothing is read back to the host.

``policy`` is ``(td, generator) -> td`` writing "action" (and extras);
``None`` takes random actions from the action spec. The collector state
is a dict holding the env state, the carried observation, the trajectory
counters and the one ``torch.Generator`` every draw of the batch comes
from.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .._stubs import not_ported_call
from ..data.arraydict import ArrayDict
from ..envs.base import EnvBase

__all__ = ["Collector"]


class Collector:
    """Fixed-size batches of ``frames_per_batch`` env frames."""

    def __init__(self, env: EnvBase, policy: Callable | None = None,
                 frames_per_batch: int = 1024, total_frames: int | None = None,
                 postproc: Callable[[ArrayDict], ArrayDict] | None = None,
                 policy_state: ArrayDict | None = None):
        if policy_state is not None or total_frames is not None:
            raise NotImplementedError(
                "Collector(policy_state=..., total_frames=...) is not ported yet "
                "(ROADMAP A6: exploration modules, the frame budget)")
        self.env = env
        self.policy = policy
        num_envs = math.prod(env.batch_shape) if env.batch_shape else 1
        if frames_per_batch % num_envs:
            raise ValueError(
                f"frames_per_batch={frames_per_batch} not divisible by num_envs={num_envs}")
        self.num_envs = num_envs
        self.scan_length = frames_per_batch // num_envs
        self.frames_per_batch = frames_per_batch
        self.postproc = postproc

    def init(self, generator: torch.Generator) -> dict:
        """Reset the envs on the generator's device."""
        dev = generator.device
        env_state, td = self.env.reset(generator)
        shape = self.env.batch_shape
        traj_ids = (torch.arange(self.num_envs, device=dev).reshape(shape) if shape
                    else torch.zeros((), dtype=torch.int64, device=dev))
        return {"env": env_state, "carry": td, "generator": generator, "step_count": 0,
                "traj_count": torch.full((), self.num_envs, dtype=torch.int64, device=dev),
                "traj_ids": traj_ids}

    def step(self, env_state, td, traj_ids, traj_count, generator):
        """One policy + env step: ``(env_state, carry_td, traj_ids,
        traj_count, full_td)``."""
        if self.policy is None:
            td = self.env.rand_action(td, generator)
        else:
            td = self.policy(td, generator)
        env_state, full_td, carry_td = self.env.step_and_reset(env_state, td, generator)
        done = full_td["next", "done"]
        d = done.to(torch.int64)
        new_ids = traj_count + torch.cumsum(d.reshape(-1), 0).reshape(done.shape) - 1
        full_td = full_td.set("collector", ArrayDict(traj_ids=traj_ids))
        return (env_state, carry_td, torch.where(done, new_ids, traj_ids),
                traj_count + d.sum(), full_td)

    @torch.no_grad()
    def collect(self, cstate: dict) -> tuple[ArrayDict, dict]:
        """One batch ``[T, *env_batch, ...]`` and the next collector state."""
        env_state, td = cstate["env"], cstate["carry"]
        traj_ids, traj_count, gen = cstate["traj_ids"], cstate["traj_count"], cstate["generator"]
        steps = []
        for _ in range(self.scan_length):
            env_state, td, traj_ids, traj_count, full_td = self.step(
                env_state, td, traj_ids, traj_count, gen)
            steps.append(full_td)
        batch = ArrayDict.stack(steps, 0)
        if self.postproc is not None:
            batch = self.postproc(batch)
        new_state = {"env": env_state, "carry": td, "generator": gen,
                     "step_count": cstate["step_count"] + self.frames_per_batch,
                     "traj_count": traj_count, "traj_ids": traj_ids}
        return batch, new_state

    _ROADMAP = "A6: the frame budget"
    frames_collected = not_ported_call("Collector.frames_collected", __name__, _ROADMAP)
    done = not_ported_call("Collector.done", __name__, _ROADMAP)
    iterate = not_ported_call("Collector.iterate", __name__, _ROADMAP)
