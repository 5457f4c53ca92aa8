"""Modules (counterpart of :mod:`rl_tpu.modules`; the networks,
distributions and key-routed modules of SAC and PPO are ported)."""

from .distributions import Categorical, Distribution, Normal, TanhNormal
from .networks import (MLP, ConcatMLP, Ensemble, NormalParamExtractor, apply_ensemble,
                       init_ensemble)
from .tdmodule import ProbabilisticActor, TDModule, TDSequential, ValueOperator
from .weights import params_from_flax

__all__ = ["MLP", "Categorical", "ConcatMLP", "Distribution", "Ensemble", "Normal",
           "NormalParamExtractor", "ProbabilisticActor", "TDModule", "TDSequential",
           "TanhNormal", "ValueOperator", "apply_ensemble", "init_ensemble",
           "params_from_flax"]
