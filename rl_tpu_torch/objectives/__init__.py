"""Losses (counterpart of :mod:`rl_tpu.objectives`; the GRPO family, SAC
and discrete SAC, DQN, DDPG, TD3, TD3+BC, REDQ, CrossQ, the PPO family
with A2C and REINFORCE, and the value estimators are ported)."""

from .common import (ActorCriticLossMixin, HardUpdate, LossModule, SoftUpdate,
                     bootstrap_discount, hold_out, masked_mean)
from .crossq import BatchNormMLP, CrossQLoss
from .ddpg import DDPGLoss, TD3BCLoss, TD3Loss
from .dqn import DQNLoss
from .llm import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage
from .ppo import A2CLoss, ClipPPOLoss, KLPENPPOLoss, PPOLoss, ReinforceLoss
from .redq import REDQLoss
from .sac import DiscreteSACLoss, SACLoss
from .value import (GAE, TD0Estimator, TD1Estimator, TDLambdaEstimator, ValueEstimatorBase,
                    ValueEstimators, VTrace, make_value_estimator)

__all__ = ["A2CLoss", "ActorCriticLossMixin", "BatchNormMLP", "CISPOLoss", "ClipPPOLoss",
           "CrossQLoss", "DAPOLoss", "DDPGLoss", "DQNLoss", "DiscreteSACLoss", "GAE", "GRPOLoss",
           "HardUpdate", "KLPENPPOLoss", "LossModule", "PPOLoss", "REDQLoss", "ReinforceLoss",
           "SACLoss", "SoftUpdate", "TD3BCLoss", "TD3Loss", "TD0Estimator", "TD1Estimator",
           "TDLambdaEstimator", "VTrace", "ValueEstimatorBase", "ValueEstimators",
           "bootstrap_discount", "hold_out", "make_value_estimator", "masked_mean", "mc_advantage"]
