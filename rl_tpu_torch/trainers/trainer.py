"""Hook-driven trainer around a program's ``train_step`` (counterpart of
:mod:`rl_tpu.trainers.trainer`; ``Trainer``, ``LogScalar`` and
``CountFramesLog`` are ported).

Hooks run on the host between steps: ``"pre_step"``, ``"post_step"``
(given the step's metrics), ``"post_eval"`` and ``"save_checkpoint"``.
A hook is ``hook(trainer)`` or ``hook(trainer, metrics)``, registered
with :meth:`Trainer.register_op`. The step runs eagerly (the reference
``jax.jit``\\ s it); metrics stay on the device unless a hook reads them.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Any, Callable

import torch

from .. import resolve_device
from .._stubs import not_ported, refuse_options
from ..data.arraydict import ArrayDict
from ..record.loggers import Logger, NullLogger

__all__ = ["Trainer", "LogScalar", "CountFramesLog"]

STAGES = ("pre_step", "post_step", "post_eval", "save_checkpoint")
_log = logging.getLogger(__name__)


class Trainer:
    """The train loop.

    Args (the reference's, plus ``device``):
        program: an object with ``init(generator)`` and ``train_step(ts)
            -> (ts, metrics)`` (an :class:`OnPolicyProgram`).
        total_steps: train steps to run.
        logger: experiment logger (default: :class:`NullLogger`).
        frames_per_step: env frames a step (default: the program's
            collector's ``frames_per_batch``).
        checkpoint / checkpoint_interval / auto_resume: not ported yet;
            any value but the default raises (ROADMAP A5).
        device: where the generator and so the program live: the card by
            default (no card: raises); ``"cpu"`` on request.
    """

    def __init__(self, program: Any, total_steps: int, logger: Logger | None = None,
                 frames_per_step: int | None = None, checkpoint: Any | None = None,
                 checkpoint_interval: int = 0, log_interval: int = 1,
                 auto_resume: bool = False, device=None):
        refuse_options("Trainer", __name__, [
            ("checkpoint", checkpoint, None, "A5: checkpoints"),
            ("checkpoint_interval", checkpoint_interval, 0, "A5: checkpoints"),
            ("auto_resume", auto_resume, False, "A5: checkpoints")])
        self.device = resolve_device(device)
        self.program = program
        self.total_steps = total_steps
        self.logger = logger or NullLogger()
        self.frames_per_step = frames_per_step or getattr(
            getattr(program, "collector", None), "frames_per_batch", 0)
        self.log_interval = log_interval
        self._hooks: dict[str, list[Callable]] = defaultdict(list)
        self.step_count = 0
        self.collected_frames = 0
        self.ts: Any = None
        self._stop = False

    def register_op(self, stage: str, hook: Callable) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; options {STAGES}")
        self._hooks[stage].append(hook)

    def _run_hooks(self, stage: str, *args) -> None:
        for h in self._hooks[stage]:
            h(self, *args)

    def request_stop(self) -> None:
        self._stop = True

    def train(self, seed: int = 0, ts: Any = None) -> Any:
        """Run until ``total_steps`` (or a hook's stop request). Without a
        train state, one ``torch.Generator`` seeded with ``seed`` on the
        trainer's device starts the program (and fills its replay buffer
        where the program has ``prefill``)."""
        if ts is None and self.ts is not None:
            ts = self.ts  # a previous train()
        if ts is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            ts = self.program.init(gen)
            if hasattr(self.program, "prefill"):
                ts = self.program.prefill(ts)
        self.ts = ts
        while self.step_count < self.total_steps and not self._stop:
            self._run_hooks("pre_step")
            self.ts, metrics = self.program.train_step(self.ts)
            self.step_count += 1
            self.collected_frames += self.frames_per_step
            self._run_hooks("post_step", metrics)
        return self.ts


class LogScalar:
    """Every ``interval`` steps, the step's scalar metrics to the logger
    as ``prefix/name`` at the collected frame count."""

    def __init__(self, prefix: str = "train", interval: int = 1):
        self.prefix = prefix
        self.interval = interval

    def __call__(self, trainer: Trainer, metrics: ArrayDict) -> None:
        if trainer.step_count % self.interval:
            return
        flat = {f"{self.prefix}/{'/'.join(k)}": v
                for k, v in metrics.items(nested=True, leaves_only=True)}
        trainer.logger.log_scalars(flat, step=trainer.collected_frames)


class CountFramesLog:
    """Every ``interval`` steps, frames per second since the last report
    (host wall clock; the device may still be working on queued steps)."""

    def __init__(self, interval: int = 10):
        self.interval = interval
        self._last = None

    def __call__(self, trainer: Trainer, metrics=None) -> None:
        now = time.perf_counter()
        if trainer.step_count % self.interval == 0:
            if self._last is not None:
                t0, f0 = self._last
                fps = (trainer.collected_frames - f0) / max(now - t0, 1e-9)
                trainer.logger.log_scalar("train/fps", fps, step=trainer.collected_frames)
                _log.info("step %d frames %d fps %.0f", trainer.step_count,
                          trainer.collected_frames, fps)
            self._last = (now, trainer.collected_frames)


_ROADMAP = "A7: the remaining trainer hooks"
LogTiming = not_ported("LogTiming", __name__, _ROADMAP)
EarlyStopping = not_ported("EarlyStopping", __name__, _ROADMAP)
UTDRHook = not_ported("UTDRHook", __name__, _ROADMAP)
MetricsHook = not_ported("MetricsHook", __name__, _ROADMAP)
Evaluator = not_ported("Evaluator", __name__, _ROADMAP)
