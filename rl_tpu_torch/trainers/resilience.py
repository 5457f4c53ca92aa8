"""Preemption-aware training: SIGTERM checkpoints and deterministic resume
(counterpart of :mod:`rl_tpu.trainers.resilience`; ``PreemptionHandler``
is ported).

A preemption or maintenance event delivers SIGTERM with a grace window:
the handler raises a flag, the trainer finishes the step in flight, saves
a final checkpoint and stops cleanly. A later run with
``Trainer(auto_resume=True)`` restores the train state (its parameters,
optimizer, collector state and ``torch.Generator`` states, so the
continuation is bit for bit the uninterrupted run) and runs only the
remainder.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Any

import torch

__all__ = ["PreemptionHandler"]

_log = logging.getLogger(__name__)


class PreemptionHandler:
    """Install as a signal handler AND a ``post_step`` hook.

    >>> handler = PreemptionHandler().install()
    >>> trainer.register_op("post_step", handler)
    >>> try:
    ...     trainer.train(0)   # SIGTERM -> checkpoint + clean stop
    ... finally:
    ...     handler.uninstall()

    The flag is also settable in-process (:meth:`preempt`), for tests,
    for the chaos injector's ``preempt`` faults and for schedulers that
    know the deadline without a signal. ``registry`` and ``tracer`` (the
    process-wide ones by default) receive the preemption's counter and
    instant.
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,), registry: Any = None,
                 tracer: Any = None):
        self.signals = signals
        self._flag = threading.Event()
        self._handled = False
        self._prev: dict = {}
        self._registry = registry
        self._tracer = tracer

    # -- signal side -----------------------------------------------------------

    def install(self) -> "PreemptionHandler":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        # async-signal-safe: only raise the flag; the work happens between
        # train steps on the main thread
        self._flag.set()

    def preempt(self) -> None:
        """Raise the flag programmatically (deadline-aware schedulers)."""
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    # -- trainer hook ----------------------------------------------------------

    def __call__(self, trainer: Any, metrics: Any = None) -> None:
        if not self._flag.is_set() or self._handled:
            return
        self._handled = True
        from ..obs import get_registry, get_tracer

        (self._tracer or get_tracer()).instant("preemption", {"step": int(trainer.step_count)})
        (self._registry or get_registry()).counter(
            "rl_tpu_preemptions_total", "preemption signals acted on").inc()
        _log.info("preemption at step %d: checkpointing and stopping", trainer.step_count)
        if trainer.checkpoint is not None:
            device = torch.device(trainer.device)
            if device.type == "cuda":  # the step in flight lands before the save reads it
                torch.cuda.synchronize(device)
            trainer.checkpoint.save(trainer.step_count)
            trainer._run_hooks("save_checkpoint")
        trainer.request_stop()
