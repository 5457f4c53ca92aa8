"""Losses (counterpart of :mod:`rl_tpu.objectives`; the GRPO family and
SAC are ported)."""

from .common import LossModule, SoftUpdate, bootstrap_discount, hold_out
from .llm import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage
from .sac import SACLoss

__all__ = ["CISPOLoss", "DAPOLoss", "GRPOLoss", "LossModule", "SACLoss", "SoftUpdate",
           "bootstrap_discount", "hold_out", "mc_advantage"]
