"""Value estimators over ArrayDict batches (counterpart of
:mod:`rl_tpu.objectives.value`).

Batches are time-major rollouts (``[T, *env_batch]``, the collector's
layout): the root holds observations, actions and log-probs, ``"next"``
the outcomes. An estimator writes ``"advantage"``, ``"value_target"`` and
``"state_value"`` at the root. ``value_network`` is a module ``td -> td``
writing ``"state_value"`` (a :class:`~rl_tpu_torch.modules.ValueOperator`);
it runs under ``torch.no_grad()``, the reference's ``stop_gradient``.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

from .._stubs import not_ported
from ..data.arraydict import ArrayDict
from ..ops import value as F

__all__ = ["ValueEstimators", "ValueEstimatorBase", "TD0Estimator", "TD1Estimator",
           "TDLambdaEstimator", "GAE", "VTrace", "make_value_estimator"]


class ValueEstimators(enum.Enum):
    TD0 = "td0"
    TD1 = "td1"
    TDLambda = "td_lambda"
    GAE = "gae"
    VTrace = "vtrace"


def _squeeze_value(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] if v.dim() and v.shape[-1] == 1 else v


class ValueEstimatorBase:
    """V(s) and V(s') from ``value_network``, then the estimator's math.
    Values with a trailing singleton dim are squeezed to the reward's
    shape."""

    def __init__(self, value_network: Callable, gamma: float = 0.99, shifted: bool = True):
        self.value_network = value_network
        self.gamma = gamma
        self.shifted = shifted  # reserved, as in the reference

    @torch.no_grad()
    def _values(self, batch: ArrayDict) -> tuple[torch.Tensor, torch.Tensor]:
        root = self.value_network(batch)
        nxt = self.value_network(batch["next"])
        return _squeeze_value(root["state_value"]), _squeeze_value(nxt["state_value"])

    def _kernel(self, value, next_value, batch):
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, batch: ArrayDict) -> ArrayDict:
        value, next_value = self._values(batch)
        adv, target = self._kernel(value, next_value, batch)
        return batch.set("advantage", adv).set("value_target", target).set("state_value", value)


class GAE(ValueEstimatorBase):
    """GAE(gamma, lambda); ``average_gae`` standardises the advantage over
    the batch (population std, clipped at 1e-6)."""

    def __init__(self, value_network, gamma: float = 0.99, lmbda: float = 0.95,
                 average_gae: bool = False):
        super().__init__(value_network, gamma)
        self.lmbda = lmbda
        self.average_gae = average_gae

    def _kernel(self, value, next_value, batch):
        adv, target = F.generalized_advantage_estimate(
            self.gamma, self.lmbda, value, next_value, batch["next", "reward"],
            batch["next", "done"], batch["next", "terminated"])
        if self.average_gae:
            adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0), min=1e-6)
        return adv, target


class TD0Estimator(ValueEstimatorBase):
    def _kernel(self, value, next_value, batch):
        target = F.td0_return_estimate(self.gamma, next_value, batch["next", "reward"],
                                       batch["next", "terminated"])
        return target - value, target


class TD1Estimator(ValueEstimatorBase):
    def _kernel(self, value, next_value, batch):
        target = F.td1_return_estimate(self.gamma, next_value, batch["next", "reward"],
                                       batch["next", "done"], batch["next", "terminated"])
        return target - value, target


class TDLambdaEstimator(ValueEstimatorBase):
    def __init__(self, value_network, gamma: float = 0.99, lmbda: float = 0.95):
        super().__init__(value_network, gamma)
        self.lmbda = lmbda

    def _kernel(self, value, next_value, batch):
        target = F.td_lambda_return_estimate(
            self.gamma, self.lmbda, next_value, batch["next", "reward"], batch["next", "done"],
            batch["next", "terminated"])
        return target - value, target


class VTrace(ValueEstimatorBase):
    """V-trace with importance ratios of the current policy's log-prob of
    the stored action (``actor_log_prob(td)``) over ``"sample_log_prob"``."""

    def __init__(self, value_network, actor_log_prob: Callable, gamma: float = 0.99,
                 rho_clip: float = 1.0, c_clip: float = 1.0):
        super().__init__(value_network, gamma)
        self.actor_log_prob = actor_log_prob
        self.rho_clip = rho_clip
        self.c_clip = c_clip

    @torch.no_grad()
    def __call__(self, batch: ArrayDict) -> ArrayDict:
        value, next_value = self._values(batch)
        log_rhos = self.actor_log_prob(batch) - batch["sample_log_prob"]
        adv, target = F.vtrace_advantage_estimate(
            self.gamma, log_rhos, value, next_value, batch["next", "reward"],
            batch["next", "done"], batch["next", "terminated"], rho_clip=self.rho_clip,
            c_clip=self.c_clip)
        return batch.set("advantage", adv).set("value_target", target).set("state_value", value)


def make_value_estimator(kind: ValueEstimators, value_network, **kwargs):
    """The estimator of ``kind`` over ``value_network``."""
    table = {ValueEstimators.TD0: TD0Estimator, ValueEstimators.TD1: TD1Estimator,
             ValueEstimators.TDLambda: TDLambdaEstimator, ValueEstimators.GAE: GAE,
             ValueEstimators.VTrace: VTrace}
    return table[kind](value_network, **kwargs)


MultiAgentGAE = not_ported("MultiAgentGAE", __name__, "A7: multi-agent")
