"""Modules (counterpart of :mod:`rl_tpu.modules`; the networks,
distributions and key-routed modules of SAC, PPO, DQN and the TD3 family
and the epsilon-greedy, additive Gaussian and Ornstein-Uhlenbeck
exploration modules are ported)."""

from .distributions import Categorical, Distribution, Normal, TanhNormal
from .exploration import AdditiveGaussianModule, EGreedyModule, OrnsteinUhlenbeckModule
from .networks import (MLP, ConcatMLP, Ensemble, NormalParamExtractor, TanhPolicy,
                       apply_ensemble, init_ensemble)
from .tdmodule import (ProbabilisticActor, QValueActor, QValueModule, TDModule, TDSequential,
                       ValueOperator)
from .weights import params_from_flax

__all__ = ["MLP", "AdditiveGaussianModule", "Categorical", "ConcatMLP", "Distribution",
           "EGreedyModule", "Ensemble", "Normal", "NormalParamExtractor",
           "OrnsteinUhlenbeckModule", "ProbabilisticActor", "QValueActor", "QValueModule",
           "TDModule", "TDSequential", "TanhNormal", "TanhPolicy", "ValueOperator",
           "apply_ensemble", "init_ensemble", "params_from_flax"]
