"""Modules (counterpart of :mod:`rl_tpu.modules`; the networks,
distributions and key-routed modules of SAC are ported)."""

from .distributions import Distribution, Normal, TanhNormal
from .networks import (MLP, ConcatMLP, Ensemble, NormalParamExtractor, apply_ensemble,
                       init_ensemble)
from .tdmodule import ProbabilisticActor, TDModule, TDSequential
from .weights import params_from_flax

__all__ = ["MLP", "ConcatMLP", "Distribution", "Ensemble", "Normal", "NormalParamExtractor",
           "ProbabilisticActor", "TDModule", "TDSequential", "TanhNormal", "apply_ensemble",
           "init_ensemble", "params_from_flax"]
