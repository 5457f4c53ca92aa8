from .grpo import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage

__all__ = ["CISPOLoss", "DAPOLoss", "GRPOLoss", "mc_advantage"]
