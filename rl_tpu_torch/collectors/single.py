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
from. ``policy_state`` (an exploration module's state, such as
``EGreedyModule.init_state()``) rides in the carried td under
``"exploration"``: the policy reads and advances it each step, the env
never sees it, and the recorded batch leaves it out.

``total_frames`` is the frame budget: :meth:`Collector.done` reports it
spent, and :meth:`Collector.iterate` yields batches until then (the
reference's ``for batch in collector``). :meth:`Collector.jit_collect`
registers ``collect`` as a program (``collector.collect``): on the card
one CUDA graph of the whole batch, replayed by every later call. The
collector state's ``step_count`` is a host int and stays outside the
graph: the wrapper adds ``frames_per_batch`` to it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..compile import get_program_registry
from ..data.arraydict import ArrayDict
from ..envs.base import EnvBase

__all__ = ["Collector"]


class Collector:
    """Fixed-size batches of ``frames_per_batch`` env frames."""

    def __init__(self, env: EnvBase, policy: Callable | None = None,
                 frames_per_batch: int = 1024, total_frames: int | None = None,
                 postproc: Callable[[ArrayDict], ArrayDict] | None = None,
                 policy_state: ArrayDict | None = None):
        self.env = env
        self.policy = policy
        self.policy_state = policy_state
        num_envs = math.prod(env.batch_shape) if env.batch_shape else 1
        if frames_per_batch % num_envs:
            raise ValueError(
                f"frames_per_batch={frames_per_batch} not divisible by num_envs={num_envs}")
        self.num_envs = num_envs
        self.scan_length = frames_per_batch // num_envs
        self.frames_per_batch = frames_per_batch
        self.total_frames = total_frames
        self.postproc = postproc

    def init(self, generator: torch.Generator) -> dict:
        """Reset the envs on the generator's device."""
        dev = generator.device
        env_state, td = self.env.reset(generator)
        if self.policy_state is not None:
            td = td.set("exploration", self.policy_state.to(dev))
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
        env_state, full_td, carry_td = self.env.step_and_reset(
            env_state, td.exclude("exploration"), generator)
        if "exploration" in td:
            carry_td = carry_td.set("exploration", td["exploration"])
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

    def jit_collect(self, registry=None) -> "_GraphedCollect":
        """:meth:`collect` as a registered program (``collector.collect``):
        ``collect(cstate) -> (batch, cstate)``. On the card each state
        layout is captured once as a CUDA graph (every env step, the policy
        and the post-processing) and replayed; on the CPU it runs eagerly.
        A replay's outputs are copies, so no two batches alias."""
        return _GraphedCollect(self, registry or get_program_registry())

    # -- the python-loop API --------------------------------------------------

    def frames_collected(self, cstate: dict) -> int:
        return int(cstate["step_count"])

    def done(self, cstate: dict) -> bool:
        return self.total_frames is not None and self.frames_collected(cstate) >= self.total_frames

    def iterate(self, generator: torch.Generator, jit: bool = True, registry=None):
        """Batches until the frame budget is spent (the reference's ``for
        batch in collector``), from a state reset on ``generator``; ``jit``
        collects through :meth:`jit_collect`."""
        collect = self.jit_collect(registry) if jit else self.collect
        cstate = self.init(generator)
        while not self.done(cstate):
            batch, cstate = collect(cstate)
            yield batch


class _GraphedCollect:
    """:meth:`Collector.jit_collect`'s callable."""

    def __init__(self, collector: Collector, registry):
        self._c = collector
        self.program = registry.register("collector.collect", collector.collect,
                                         fingerprint=repr(collector.frames_per_batch))

    def __call__(self, cstate: dict) -> tuple[ArrayDict, dict]:
        batch, out = self.program({**cstate, "step_count": 0})
        return batch, {**out, "step_count": cstate["step_count"] + self._c.frames_per_batch}
