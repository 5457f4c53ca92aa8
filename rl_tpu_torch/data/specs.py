"""Specs: shapes, dtypes and domains of env inputs and outputs
(counterpart of :mod:`rl_tpu.data.specs`; the continuous specs, the
discrete ``Categorical``, ``OneHot`` and ``Binary``, and ``Composite`` are
ported).

``rand`` draws from a ``torch.Generator`` on that generator's device (the
reference takes a PRNG key); ``zero`` takes the device. A bound that is
one value for every element stays a Python scalar, so drawing actions on
the card copies nothing from the host. ``is_in`` checks the shape and
dtype, then the domain (one read of the value on the host).

A categorical action keeps the reference's ``int32``; torch's ``gather``
and ``one_hot`` take ``int64``, so those casts happen where they are
used.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .._stubs import not_ported
from .arraydict import ArrayDict

__all__ = ["Spec", "Bounded", "Unbounded", "Categorical", "OneHot", "Binary", "Composite"]


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

    def is_in(self, val: torch.Tensor) -> bool:
        """Shape (trailing dims) and dtype, then the domain."""
        n = len(self.shape)
        if (tuple(val.shape[len(val.shape) - n:]) if n else ()) != self.shape:
            return False
        if val.dtype != self.dtype:
            return False
        return bool(self._domain_ok(val))

    def _domain_ok(self, val: torch.Tensor):
        return True


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

    def _domain_ok(self, val):
        low, high = self._bound("low", val.device), self._bound("high", val.device)
        return torch.all((val >= low) & (val <= high))


@dataclasses.dataclass(frozen=True)
class Unbounded(Spec):
    """Unbounded space; ``rand`` draws standard normals."""

    def rand(self, batch_shape=(), generator=None, device=None):
        dev = _device(generator, device)
        return torch.randn(_canon_shape(batch_shape) + self.shape, generator=generator,
                           device=dev, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class Categorical(Spec):
    """Integer categorical in [0, n); ``shape`` leaves out the class
    dimension (a scalar action has ``shape=()``); ``n = -1`` is an unknown
    cardinality, whose domain is unconstrained."""

    n: int = -1
    dtype: Any = torch.int32

    def rand(self, batch_shape=(), generator=None, device=None):
        return torch.randint(0, max(self.n, 1), _canon_shape(batch_shape) + self.shape,
                             generator=generator, device=_device(generator, device),
                             dtype=self.dtype)

    def project(self, val):
        val = val.to(self.dtype)
        return val if self.n < 0 else torch.clamp(val, 0, self.n - 1)

    def _domain_ok(self, val):
        return True if self.n < 0 else torch.all((val >= 0) & (val < self.n))

    @property
    def num_actions(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class OneHot(Spec):
    """One-hot categorical; ``shape[-1]`` is the number of classes ``n``."""

    n: int = 0
    dtype: Any = torch.float32

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (self.n,))
        super().__post_init__()
        if self.n == 0:
            object.__setattr__(self, "n", int(self.shape[-1]))
        if self.shape[-1] != self.n:
            raise ValueError("shape[-1] must equal n")

    def rand(self, batch_shape=(), generator=None, device=None):
        idx = torch.randint(0, self.n, _canon_shape(batch_shape) + self.shape[:-1],
                            generator=generator, device=_device(generator, device))
        return F.one_hot(idx, self.n).to(self.dtype)

    def project(self, val):
        return F.one_hot(torch.argmax(val, dim=-1), self.n).to(self.dtype)

    def encode(self, val: torch.Tensor) -> torch.Tensor:
        if val.dim() and val.shape[-1] == self.n and val.is_floating_point():
            return val.to(self.dtype)
        return F.one_hot(val.to(torch.int64), self.n).to(self.dtype)

    def to_categorical_spec(self) -> Categorical:
        return Categorical(shape=self.shape[:-1], n=self.n)

    def _domain_ok(self, val):
        ones = torch.sum(val != 0, dim=-1) == 1
        return torch.all(ones) & torch.all((val == 0) | (val == 1))


@dataclasses.dataclass(frozen=True)
class Binary(Spec):
    """Binary flags (the env's done, terminated and truncated)."""

    dtype: Any = torch.bool

    def rand(self, batch_shape=(), generator=None, device=None):
        u = torch.rand(_canon_shape(batch_shape) + self.shape, generator=generator,
                       device=_device(generator, device))
        return (u < 0.5).to(self.dtype)

    def _domain_ok(self, val):
        return torch.all((val == 0) | (val == 1))


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

    def set(self, key, spec: Spec) -> "Composite":
        """A new Composite with ``key`` set (nested nodes made as needed)."""
        head, *rest = tuple(key.split(".")) if isinstance(key, str) else tuple(key)
        specs = dict(self._specs)
        if rest:
            child = specs.get(head)
            if not isinstance(child, Composite):
                child = Composite(shape=self.shape)
            specs[head] = child.set(tuple(rest), spec)
        else:
            specs[head] = spec
        return Composite(specs, shape=self.shape)

    def is_in(self, val) -> bool:
        return isinstance(val, (ArrayDict, dict)) and all(
            k in val and spec.is_in(val[k]) for k, spec in self._specs.items())

    def rand(self, batch_shape=(), generator=None, device=None) -> ArrayDict:
        bs = _canon_shape(batch_shape) + self.shape
        return ArrayDict({k: v.rand(bs, generator, device) for k, v in self._specs.items()})

    def zero(self, batch_shape=(), device=None) -> ArrayDict:
        bs = _canon_shape(batch_shape) + self.shape
        return ArrayDict({k: v.zero(bs, device) for k, v in self._specs.items()})

    def __repr__(self) -> str:
        return f"Composite(shape={self.shape}, {self._specs})"


_ROADMAP = "A7: the remaining specs"
MultiCategorical = not_ported("MultiCategorical", __name__, _ROADMAP)
MultiOneHot = not_ported("MultiOneHot", __name__, _ROADMAP)
NonTensor = not_ported("NonTensor", __name__, _ROADMAP)
stack_specs = not_ported("stack_specs", __name__, _ROADMAP)
make_composite_from_arraydict = not_ported("make_composite_from_arraydict", __name__, _ROADMAP)
