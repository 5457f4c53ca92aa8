"""Experiment loggers (counterpart of :mod:`rl_tpu.record`; ``Logger``,
``NullLogger`` and ``CSVLogger`` are ported)."""

from .loggers import CSVLogger, Logger, NullLogger

__all__ = ["CSVLogger", "Logger", "NullLogger"]
