"""Losses (counterpart of :mod:`rl_tpu.objectives`; the GRPO family is
ported so far)."""

from .llm import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage

__all__ = ["CISPOLoss", "DAPOLoss", "GRPOLoss", "mc_advantage"]
