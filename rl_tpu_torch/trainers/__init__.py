"""Trainers (counterpart of :mod:`rl_tpu.trainers`; the sequential GRPO
trainer and the off-policy program are ported)."""

from .grpo import Adam, GRPOTrainer
from .off_policy import OffPolicyConfig, OffPolicyProgram, default_device_metrics

__all__ = ["Adam", "GRPOTrainer", "OffPolicyConfig", "OffPolicyProgram",
           "default_device_metrics"]
