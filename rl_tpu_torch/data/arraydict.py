"""ArrayDict: the port's data model (counterpart of
:mod:`rl_tpu.data.arraydict`).

A nested mapping of names to ``torch.Tensor`` leaves with an inferred
leading batch shape. Keys are strings; a tuple is a path into nested
ArrayDicts (``td["next", "reward"]``). As in the reference, ``set``,
``replace``, ``update``, ``delete`` and ``exclude`` return a new
ArrayDict; the tensors themselves are shared, never copied, so an
in-place write to a leaf is seen by every ArrayDict that holds it.

Indexing with anything but a key path (an index tensor, a slice, an int)
indexes every leaf over its batch dims.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator

import torch

__all__ = ["ArrayDict", "NESTED_SEP"]

NESTED_SEP = "."


def _path(key) -> tuple[str, ...]:
    if isinstance(key, str):
        return tuple(key.split(NESTED_SEP)) if NESTED_SEP in key else (key,)
    return tuple(key)


def _is_path(key) -> bool:
    return isinstance(key, str) or (
        isinstance(key, tuple) and bool(key) and all(isinstance(k, str) for k in key)
    )


class ArrayDict(Mapping):
    """Nested mapping of names to tensors.

    >>> td = ArrayDict(obs=torch.zeros(4, 3), reward=torch.zeros(4))
    >>> td.batch_shape
    (4,)
    """

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any] | None = None, /, **kwargs: Any):
        merged: dict[str, Any] = {}
        if data is not None:
            merged.update(data)
        merged.update(kwargs)
        out: dict[str, Any] = {}
        for k, v in merged.items():
            if not isinstance(k, str):
                raise TypeError(f"ArrayDict keys must be str, got {type(k)}")
            out[k] = ArrayDict(v) if isinstance(v, Mapping) and not isinstance(v, ArrayDict) else v
        object.__setattr__(self, "_data", dict(sorted(out.items())))

    @classmethod
    def _unsafe(cls, data: dict[str, Any]) -> "ArrayDict":
        self = object.__new__(cls)
        object.__setattr__(self, "_data", data)
        return self

    # -- Mapping protocol -----------------------------------------------------

    def __getitem__(self, key: Any) -> Any:
        if _is_path(key):
            node: Any = self
            for k in _path(key):
                if not isinstance(node, ArrayDict):
                    raise KeyError(key)
                node = node._data[k]
            return node
        return self.apply(lambda x: x[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Any) -> bool:
        if not _is_path(key):
            return False
        try:
            self[key]
        except KeyError:
            return False
        return True

    def keys(self, nested: bool = False, leaves_only: bool = False):
        if not nested:
            return self._data.keys()
        out = []
        for k, v in self._data.items():
            if isinstance(v, ArrayDict):
                if not leaves_only:
                    out.append((k,))
                out.extend((k, *sub) for sub in v.keys(True, leaves_only))
            else:
                out.append((k,))
        return out

    def items(self, nested: bool = False, leaves_only: bool = False):
        if not nested:
            return self._data.items()
        return [(k, self[k]) for k in self.keys(True, leaves_only)]

    def values(self):
        return self._data.values()

    def leaves(self) -> list:
        out = []
        for v in self._data.values():
            out.extend(v.leaves() if isinstance(v, ArrayDict) else [v])
        return out

    # -- mutators that return a new ArrayDict ---------------------------------

    def set(self, key, value: Any) -> "ArrayDict":
        """A new ArrayDict with ``key`` set (nested nodes made as needed)."""
        head, *rest = _path(key)
        data = dict(self._data)
        if rest:
            child = data.get(head)
            data[head] = (child if isinstance(child, ArrayDict) else ArrayDict()).set(
                tuple(rest), value)
        else:
            if isinstance(value, Mapping) and not isinstance(value, ArrayDict):
                value = ArrayDict(value)
            data[head] = value
        return ArrayDict._unsafe(dict(sorted(data.items())))

    def replace(self, **kwargs: Any) -> "ArrayDict":
        out = self
        for k, v in kwargs.items():
            out = out.set(k, v)
        return out

    def update(self, other: Mapping[str, Any] | None = None, **kw: Any) -> "ArrayDict":
        """Recursive merge: nested ArrayDicts merge key-wise, leaves overwrite."""
        out = self
        for k, v in list((other or {}).items()) + list(kw.items()):
            cur = out._data.get(k) if isinstance(k, str) and NESTED_SEP not in k else None
            if isinstance(cur, ArrayDict) and isinstance(v, Mapping):
                out = out.set(k, cur.update(v))
            else:
                out = out.set(k, v)
        return out

    def delete(self, key) -> "ArrayDict":
        head, *rest = _path(key)
        data = dict(self._data)
        if rest:
            child = data[head]
            if not isinstance(child, ArrayDict):
                raise KeyError(key)
            data[head] = child.delete(tuple(rest))
        else:
            del data[head]
        return ArrayDict._unsafe(data)

    def exclude(self, *keys) -> "ArrayDict":
        out = self
        for k in keys:
            try:
                out = out.delete(k)
            except KeyError:
                pass
        return out

    # -- shape ----------------------------------------------------------------

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """Longest common leading prefix of all leaf shapes."""
        shapes = [tuple(v.shape) for v in self.leaves()]
        if not shapes:
            return ()
        prefix = shapes[0]
        for s in shapes[1:]:
            n = 0
            for a, b in zip(prefix, s):
                if a != b:
                    break
                n += 1
            prefix = prefix[:n]
        return prefix

    shape = batch_shape

    @property
    def batch_ndim(self) -> int:
        return len(self.batch_shape)

    def reshape(self, *shape: int) -> "ArrayDict":
        """Every leaf's batch dims reshaped to ``shape`` (feature dims kept)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        nb = self.batch_ndim
        return self.apply(lambda x: x.reshape(tuple(shape) + tuple(x.shape[nb:])))

    def flatten_batch(self) -> "ArrayDict":
        """All batch dims folded into one, row-major (``[T, N]`` -> ``[T * N]``)."""
        return self.reshape(-1)

    def apply(self, fn: Callable[[Any], Any]) -> "ArrayDict":
        """Apply ``fn`` to every leaf."""
        return ArrayDict._unsafe({
            k: (v.apply(fn) if isinstance(v, ArrayDict) else fn(v)) for k, v in self._data.items()
        })

    def named_apply(self, fn: Callable[[tuple, Any], Any]) -> "ArrayDict":
        """Apply ``fn(path, leaf)`` to every leaf."""

        def rec(node: "ArrayDict", prefix: tuple) -> "ArrayDict":
            return ArrayDict._unsafe({
                k: (rec(v, prefix + (k,)) if isinstance(v, ArrayDict) else fn(prefix + (k,), v))
                for k, v in node._data.items()
            })

        return rec(self, ())

    def unsqueeze(self, dim: int = 0) -> "ArrayDict":
        return self.apply(lambda x: x.unsqueeze(dim))

    def to(self, device) -> "ArrayDict":
        return self.apply(lambda x: x.to(device))

    @staticmethod
    def stack(dicts: list["ArrayDict"], dim: int = 0) -> "ArrayDict":
        """Stack same-structured ArrayDicts leaf by leaf along ``dim``."""
        first = dicts[0]
        return ArrayDict._unsafe({
            k: (ArrayDict.stack([d._data[k] for d in dicts], dim) if isinstance(v, ArrayDict)
                else torch.stack([d._data[k] for d in dicts], dim))
            for k, v in first._data.items()
        })

    def __repr__(self) -> str:
        def fmt(v):
            if isinstance(v, torch.Tensor):
                return f"Tensor{tuple(v.shape)}[{v.dtype}]"
            return repr(v)

        inner = ", ".join(f"{k}: {fmt(v)}" for k, v in self._data.items())
        return f"ArrayDict(batch_shape={self.batch_shape}, {{{inner}}})"
