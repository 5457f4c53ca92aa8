"""Losses (counterpart of :mod:`rl_tpu.objectives`; the GRPO family, SAC,
DQN, the PPO family with A2C and REINFORCE, and the value estimators are
ported)."""

from .common import (ActorCriticLossMixin, HardUpdate, LossModule, SoftUpdate,
                     bootstrap_discount, hold_out, masked_mean)
from .dqn import DQNLoss
from .llm import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage
from .ppo import A2CLoss, ClipPPOLoss, KLPENPPOLoss, PPOLoss, ReinforceLoss
from .sac import SACLoss
from .value import (GAE, TD0Estimator, TD1Estimator, TDLambdaEstimator, ValueEstimatorBase,
                    ValueEstimators, VTrace, make_value_estimator)

__all__ = ["A2CLoss", "ActorCriticLossMixin", "CISPOLoss", "ClipPPOLoss", "DAPOLoss", "DQNLoss",
           "GAE", "GRPOLoss", "HardUpdate", "KLPENPPOLoss", "LossModule", "PPOLoss",
           "ReinforceLoss", "SACLoss", "SoftUpdate", "TD0Estimator", "TD1Estimator",
           "TDLambdaEstimator", "VTrace", "ValueEstimatorBase", "ValueEstimators",
           "bootstrap_discount", "hold_out", "make_value_estimator", "masked_mean", "mc_advantage"]
