"""Trainers (counterpart of :mod:`rl_tpu.trainers`; the sequential GRPO
trainer is ported so far)."""

from .grpo import Adam, GRPOTrainer

__all__ = ["Adam", "GRPOTrainer"]
