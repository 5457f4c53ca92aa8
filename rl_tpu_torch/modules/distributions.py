"""Policy distributions (counterpart of :mod:`rl_tpu.modules.distributions`;
``Normal`` and ``TanhNormal`` are ported).

``sample`` and ``rsample`` draw ``loc + scale * eps`` with ``eps`` either
given (a standard-normal tensor of the loc's shape, so a test can feed
both packages the same noise) or drawn from ``generator``. ``sample`` is
cut from the graph; ``rsample`` keeps the reparameterised gradient.
``log_prob`` sums the last axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .._stubs import not_ported
from ..ops.math import safeatanh, safetanh

__all__ = ["Distribution", "Normal", "TanhNormal"]

_LOG_2PI = math.log(2.0 * math.pi)


def _eps(loc: torch.Tensor, generator, eps, sample_shape=()) -> torch.Tensor:
    if eps is not None:
        return eps
    return torch.randn(tuple(sample_shape) + tuple(loc.shape), generator=generator,
                       device=loc.device, dtype=loc.dtype)


class Distribution:
    """Base: ``rsample``, ``sample`` (no gradient), ``log_prob``, ``mode``,
    ``mean``, ``deterministic_sample``."""

    def rsample(self, generator=None, sample_shape=(), eps=None) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, generator=None, sample_shape=(), eps=None) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(generator, sample_shape, eps)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def deterministic_sample(self) -> torch.Tensor:
        return self.mode


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """Diagonal Gaussian; ``log_prob`` sums the last axis."""

    loc: Any
    scale: Any

    def rsample(self, generator=None, sample_shape=(), eps=None):
        return self.loc + self.scale * _eps(self.loc, generator, eps, sample_shape)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return (-0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)).sum(-1)

    def entropy(self):
        return (0.5 * (1.0 + _LOG_2PI) + torch.log(self.scale)).sum(-1)

    @property
    def mode(self):
        return self.loc

    @property
    def mean(self):
        return self.loc


@dataclasses.dataclass(frozen=True)
class TanhNormal(Distribution):
    """tanh-squashed Gaussian mapped into [low, high]; the pre-tanh loc is
    bounded as ``upscale * tanh(loc / upscale)``, and the squash and its
    inverse are :func:`safetanh`/:func:`safeatanh`."""

    loc: Any
    scale: Any
    low: Any = -1.0
    high: Any = 1.0
    upscale: Any = 5.0

    @property
    def _bounded_loc(self) -> torch.Tensor:
        return self.upscale * torch.tanh(self.loc / self.upscale)

    def _squash(self, pre):
        t = safetanh(pre)
        return (t + 1.0) * 0.5 * (self.high - self.low) + self.low

    def _unsquash(self, x):
        t = (x - self.low) / (self.high - self.low) * 2.0 - 1.0
        return safeatanh(t)

    def rsample(self, generator=None, sample_shape=(), eps=None):
        loc = self._bounded_loc
        return self._squash(loc + self.scale * _eps(loc, generator, eps, sample_shape))

    def log_prob(self, x):
        pre = self._unsquash(x)
        z = (pre - self._bounded_loc) / self.scale
        base = -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)
        # |dx/dpre| = (1 - tanh^2) * (high - low) / 2
        t = safetanh(pre)
        log_det = torch.log1p(-t * t) + math.log((self.high - self.low) * 0.5)
        return (base - log_det).sum(-1)

    def entropy(self):
        raise NotImplementedError(
            "TanhNormal entropy has no closed form; use -log_prob(sample) estimates")

    @property
    def mode(self):
        return self._squash(self._bounded_loc)

    @property
    def mean(self):
        return self._squash(self._bounded_loc)


_ROADMAP = "A6/A7: the remaining distributions"
TruncatedNormal = not_ported("TruncatedNormal", __name__, _ROADMAP)
Delta = not_ported("Delta", __name__, _ROADMAP)
TanhDelta = not_ported("TanhDelta", __name__, _ROADMAP)
Categorical = not_ported("Categorical", __name__, _ROADMAP)
OneHotCategorical = not_ported("OneHotCategorical", __name__, _ROADMAP)
MaskedCategorical = not_ported("MaskedCategorical", __name__, _ROADMAP)
Ordinal = not_ported("Ordinal", __name__, _ROADMAP)
OneHotOrdinal = not_ported("OneHotOrdinal", __name__, _ROADMAP)
