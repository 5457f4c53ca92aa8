"""Trainers (counterpart of :mod:`rl_tpu.trainers`; the sequential and
pipelined GRPO trainers, the off-policy and on-policy programs, the
overlapped host-env off-policy trainer, the
hook-driven ``Trainer`` and the PPO, A2C, DQN, SAC, TD3, DDPG, REDQ and
CrossQ trainer factories are ported)."""

from .algorithms import (default_continuous_actor, default_discrete_actor, make_a2c_trainer,
                         make_crossq_trainer, make_ddpg_trainer, make_dqn_trainer,
                         make_ppo_trainer, make_redq_trainer, make_sac_trainer,
                         make_td3_trainer)
from .grpo import Adam, GRPOTrainer, PipelinedGRPOTrainer, RolloutPipeline
from .off_policy import (AsyncOffPolicyTrainer, OffPolicyConfig, OffPolicyProgram,
                         default_device_metrics)
from .on_policy import OnPolicyConfig, OnPolicyProgram
from .trainer import CountFramesLog, LogScalar, Trainer

__all__ = ["Adam", "AsyncOffPolicyTrainer", "CountFramesLog", "GRPOTrainer", "LogScalar", "OffPolicyConfig",
           "OffPolicyProgram", "OnPolicyConfig", "OnPolicyProgram", "PipelinedGRPOTrainer",
           "RolloutPipeline", "Trainer",
           "default_continuous_actor", "default_device_metrics", "default_discrete_actor",
           "make_a2c_trainer", "make_crossq_trainer", "make_ddpg_trainer", "make_dqn_trainer",
           "make_ppo_trainer", "make_redq_trainer", "make_sac_trainer", "make_td3_trainer"]
