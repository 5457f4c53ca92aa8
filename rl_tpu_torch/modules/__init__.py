"""Modules (counterpart of :mod:`rl_tpu.modules`; the networks,
distributions and key-routed modules of SAC, PPO and DQN and the
epsilon-greedy exploration module are ported)."""

from .distributions import Categorical, Distribution, Normal, TanhNormal
from .exploration import EGreedyModule
from .networks import (MLP, ConcatMLP, Ensemble, NormalParamExtractor, apply_ensemble,
                       init_ensemble)
from .tdmodule import (ProbabilisticActor, QValueActor, QValueModule, TDModule, TDSequential,
                       ValueOperator)
from .weights import params_from_flax

__all__ = ["MLP", "Categorical", "ConcatMLP", "Distribution", "EGreedyModule", "Ensemble",
           "Normal", "NormalParamExtractor", "ProbabilisticActor", "QValueActor", "QValueModule",
           "TDModule", "TDSequential", "TanhNormal", "ValueOperator", "apply_ensemble",
           "init_ensemble", "params_from_flax"]
