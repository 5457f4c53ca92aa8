"""Specs: shapes, dtypes and domains of env inputs and outputs
(counterpart of :mod:`rl_tpu.data.specs`; the continuous specs and
``Composite`` are ported).

``rand`` draws from a ``torch.Generator`` on that generator's device (the
reference takes a PRNG key); ``zero`` takes the device. A bound that is
one value for every element stays a Python scalar, so drawing actions on
the card copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._stubs import not_ported
from .arraydict import ArrayDict

__all__ = ["Spec", "Bounded", "Unbounded", "Composite"]


def _canon_shape(shape) -> tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _device(generator, device):
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Spec:
    """Leaf spec: feature shape and dtype."""

    shape: tuple[int, ...] = ()
    dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", _canon_shape(self.shape))

    def rand(self, batch_shape=(), generator: torch.Generator | None = None,
             device=None) -> torch.Tensor:
        raise NotImplementedError

    def zero(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(_canon_shape(batch_shape) + self.shape, dtype=self.dtype,
                           device=device)

    def project(self, val: torch.Tensor) -> torch.Tensor:
        return val.to(self.dtype)


@dataclasses.dataclass(frozen=True)
class Bounded(Spec):
    """Box with per-element bounds (``low``/``high`` broadcast to ``shape``)."""

    low: Any = -1.0
    high: Any = 1.0

    def __post_init__(self):
        super().__post_init__()
        for name in ("low", "high"):
            v = torch.broadcast_to(torch.as_tensor(getattr(self, name), dtype=torch.float64),
                                   self.shape)
            object.__setattr__(self, name, tuple(float(x) for x in v.reshape(-1).tolist()))

    def _bound(self, which: str, device):
        vals = getattr(self, which)
        if len(set(vals)) == 1:  # one value: a Python scalar, nothing to copy
            return vals[0]
        return torch.tensor(vals, dtype=self.dtype, device=device).reshape(self.shape)

    def rand(self, batch_shape=(), generator=None, device=None):
        dev = _device(generator, device)
        shape = _canon_shape(batch_shape) + self.shape
        u = torch.rand(shape, generator=generator, device=dev, dtype=self.dtype)
        low, high = self._bound("low", dev), self._bound("high", dev)
        return u * (high - low) + low

    def project(self, val):
        low, high = self._bound("low", val.device), self._bound("high", val.device)
        return torch.clamp(val.to(self.dtype), low, high)


@dataclasses.dataclass(frozen=True)
class Unbounded(Spec):
    """Unbounded space; ``rand`` draws standard normals."""

    def rand(self, batch_shape=(), generator=None, device=None):
        dev = _device(generator, device)
        return torch.randn(_canon_shape(batch_shape) + self.shape, generator=generator,
                           device=dev, dtype=self.dtype)


class Composite(Spec):
    """A nested dict of specs; ``rand``/``zero`` give ArrayDicts."""

    def __init__(self, specs: dict | None = None, shape=(), **kw: Spec):
        merged = dict(specs or {})
        merged.update(kw)
        out = {}
        for k, v in merged.items():
            if isinstance(v, dict):
                v = Composite(v)
            if not isinstance(v, Spec):
                raise TypeError(f"Composite values must be Spec, got {type(v)} for {k!r}")
            out[k] = v
        object.__setattr__(self, "_specs", dict(sorted(out.items())))
        object.__setattr__(self, "shape", _canon_shape(shape))
        object.__setattr__(self, "dtype", None)

    def __getitem__(self, key) -> Spec:
        if isinstance(key, tuple):
            node: Spec = self
            for k in key:
                node = node[k]
            return node
        return self._specs[key]

    def __contains__(self, key) -> bool:
        try:
            self[key]
            return True
        except (KeyError, TypeError):
            return False

    def keys(self):
        return self._specs.keys()

    def items(self):
        return self._specs.items()

    def rand(self, batch_shape=(), generator=None, device=None) -> ArrayDict:
        bs = _canon_shape(batch_shape) + self.shape
        return ArrayDict({k: v.rand(bs, generator, device) for k, v in self._specs.items()})

    def zero(self, batch_shape=(), device=None) -> ArrayDict:
        bs = _canon_shape(batch_shape) + self.shape
        return ArrayDict({k: v.zero(bs, device) for k, v in self._specs.items()})

    def __repr__(self) -> str:
        return f"Composite(shape={self.shape}, {self._specs})"


_ROADMAP = "A6/A7: the discrete specs come with DQN and PPO on CartPole"
Categorical = not_ported("Categorical", __name__, _ROADMAP)
MultiCategorical = not_ported("MultiCategorical", __name__, _ROADMAP)
OneHot = not_ported("OneHot", __name__, _ROADMAP)
MultiOneHot = not_ported("MultiOneHot", __name__, _ROADMAP)
Binary = not_ported("Binary", __name__, _ROADMAP)
NonTensor = not_ported("NonTensor", __name__, _ROADMAP)
stack_specs = not_ported("stack_specs", __name__, _ROADMAP)
make_composite_from_arraydict = not_ported("make_composite_from_arraydict", __name__, _ROADMAP)
