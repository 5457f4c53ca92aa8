"""Checkpoint registry with adapters and schema migrations (counterpart of
:mod:`rl_tpu.checkpoint.checkpoint`; ``Checkpoint``, ``ArrayTreeAdapter``,
``JSONAdapter``, ``PickleAdapter`` and ``GlobalRNGState`` are ported).

Components register by name with an adapter, as in the reference. Orbax
has no counterpart here; the on-disk format is:

- one directory a step, ``<root>/step_<n>/``, holding a subdirectory a
  component, ``_rng/`` (with ``capture_rng``) and ``meta.json``;
- :class:`ArrayTreeAdapter`: ``arrays.pt``, one :func:`torch.save` (its zip
  format) of the tree with a CPU copy of every tensor, each
  ``torch.Generator`` as its device and ``get_state()`` bytes, each
  ``ArrayDict`` as a marked dict. It is read back with
  ``torch.load(weights_only=True)``: containers, tensors and Python scalars
  only, nothing executable;
- :class:`JSONAdapter`: ``data.json``; :class:`PickleAdapter`: ``data.pkl``.

Every file is written to a temporary name and renamed into place, and
``meta.json`` is removed first and written last, so a save that stops
part way never looks complete (:meth:`Checkpoint.latest_step` skips it).

The port's random state lives in explicit ``torch.Generator`` objects in
the train state (the reference keeps typed JAX keys there), so generators
round-trip as leaves. ``GlobalRNGState`` captures Python's and numpy's
global generators, as the reference does.

A tree is nested ``dict``, ``list``, ``tuple`` and ``ArrayDict`` over
tensors, generators and Python scalars. :func:`to_tree` turns an object
with a ``state_tree()`` method (the port's ``Adam``) into its tree;
:func:`restore_into` writes a loaded tree back into live objects in place
(tensors by ``copy_``, generators by ``set_state``, objects by
``load_state_tree``), which keeps CUDA graphs captured over them valid.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import tempfile
from typing import Any, Callable

import numpy as np
import torch

from ..data.arraydict import ArrayDict

__all__ = [
    "Checkpoint",
    "ArrayTreeAdapter",
    "JSONAdapter",
    "PickleAdapter",
    "GlobalRNGState",
    "restore_into",
    "to_tree",
]

SCHEMA_VERSION = 1
_GEN = "__rl_tpu_torch_generator__"
_AD = "__rl_tpu_torch_arraydict__"


def _atomic_write(path: str, write: Callable[[Any], None], mode: str = "wb") -> None:
    """``write(file)`` into a temporary file beside ``path``, then rename."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def to_tree(x: Any) -> Any:
    """``x`` with every object that has ``state_tree()`` replaced by its
    tree (recursively through dicts, lists, tuples and ArrayDicts)."""
    if hasattr(x, "state_tree"):
        return to_tree(x.state_tree())
    if isinstance(x, ArrayDict):
        return ArrayDict._unsafe({k: to_tree(x[k]) for k in x.keys()})
    if isinstance(x, dict):
        return {k: to_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_tree(v) for v in x)
    return x


def _encode(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        # a CPU tensor is copied: saved as it is, a view would save its whole storage
        return x.detach().clone() if x.device.type == "cpu" else x.detach().cpu()
    if isinstance(x, torch.Generator):
        return {_GEN: str(x.device), "state": x.get_state()}
    if isinstance(x, ArrayDict):
        return {_AD: {k: _encode(x[k]) for k in x.keys()}}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"ArrayTreeAdapter: cannot save a leaf of type {type(x).__name__}")


def _decode(x: Any, template: Any, where: str) -> Any:
    if isinstance(x, torch.Tensor):
        if template is None:
            return x
        if not isinstance(template, torch.Tensor):
            raise ValueError(f"checkpoint leaf {where}: a tensor where the template has "
                             f"{type(template).__name__}")
        if x.shape != template.shape or x.dtype != template.dtype:
            raise ValueError(f"checkpoint leaf {where}: {tuple(x.shape)} {x.dtype}, the "
                             f"template {tuple(template.shape)} {template.dtype}")
        return x.to(template.device)
    if isinstance(x, dict) and _GEN in x:
        device = template.device if isinstance(template, torch.Generator) else "cpu"
        gen = torch.Generator(device=device)
        gen.set_state(x["state"])
        return gen
    if isinstance(x, dict) and _AD in x:
        items = x[_AD]
        return ArrayDict._unsafe({k: _decode(v, _child(template, k, where), f"{where}/{k}")
                                  for k, v in items.items()})
    if isinstance(x, dict):
        return {k: _decode(v, _child(template, k, where), f"{where}/{k}") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if template is not None and len(template) != len(x):
            raise ValueError(f"checkpoint node {where}: {len(x)} entries, the template "
                             f"{len(template)}")
        return type(x)(_decode(v, None if template is None else template[i], f"{where}/{i}")
                       for i, v in enumerate(x))
    return x


def _child(template: Any, key: str, where: str) -> Any:
    if template is None:
        return None
    if key not in template:
        raise ValueError(f"checkpoint node {where}: key {key!r} is not in the template")
    return template[key]


@torch.no_grad()
def restore_into(live: Any, tree: Any) -> Any:
    """Write ``tree`` (a loaded tree of ``live``'s structure) into ``live``
    in place where a leaf can be written (tensors, generators, objects
    with ``load_state_tree``) and return the merged structure (other leaves
    come from ``tree``)."""
    if hasattr(live, "load_state_tree"):
        live.load_state_tree(tree)
        return live
    if isinstance(live, torch.Tensor):
        live.copy_(tree)
        return live
    if isinstance(live, torch.Generator):
        live.set_state(tree.get_state())
        return live
    if isinstance(live, ArrayDict):
        return ArrayDict._unsafe({k: restore_into(live[k], tree[k]) for k in live.keys()})
    if isinstance(live, dict):
        return {k: restore_into(v, tree[k]) for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        return type(live)(restore_into(a, b) for a, b in zip(live, tree))
    return tree


class ArrayTreeAdapter:
    """A tree of tensors (parameters, optimizer state, replay and sampler
    states, generators) as ``arrays.pt``; restored onto the devices of the
    template's leaves (without a template, onto the CPU)."""

    def save(self, path: str, obj: Any) -> None:
        os.makedirs(path, exist_ok=True)
        tree = _encode(to_tree(obj))
        _atomic_write(os.path.join(path, "arrays.pt"), lambda f: torch.save(tree, f))

    def load(self, path: str, template: Any | None = None) -> Any:
        tree = torch.load(os.path.join(path, "arrays.pt"), map_location="cpu",
                          weights_only=True)
        return _decode(tree, None if template is None else to_tree(template), "")


class JSONAdapter:
    def save(self, path: str, obj: Any) -> None:
        os.makedirs(path, exist_ok=True)
        _atomic_write(os.path.join(path, "data.json"), lambda f: json.dump(obj, f), "w")

    def load(self, path: str, template: Any | None = None) -> Any:
        with open(os.path.join(path, "data.json")) as f:
            return json.load(f)


class PickleAdapter:
    def save(self, path: str, obj: Any) -> None:
        os.makedirs(path, exist_ok=True)
        _atomic_write(os.path.join(path, "data.pkl"), lambda f: pickle.dump(obj, f))

    def load(self, path: str, template: Any | None = None) -> Any:
        with open(os.path.join(path, "data.pkl"), "rb") as f:
            return pickle.load(f)


class GlobalRNGState:
    """Host RNG capture: Python's and numpy's global generators (the
    reference's, which leaves out torch; the port's torch draws come from
    generators in the train state)."""

    @staticmethod
    def get() -> dict:
        np_state = np.random.get_state()
        return {
            "python": list(random.getstate()[1]) + [random.getstate()[0], random.getstate()[2]],
            "numpy": [np_state[0], np_state[1].tolist(), *np_state[2:]],
        }

    @staticmethod
    def set(state: dict) -> None:
        py = state["python"]
        random.setstate((py[-2], tuple(py[:-2]), py[-1]))
        np_s = state["numpy"]
        np.random.set_state((np_s[0], np.asarray(np_s[1], dtype=np.uint32), *np_s[2:]))


class Checkpoint:
    """Named-component checkpoint registry.

    >>> ckpt = Checkpoint("ckpts/run1")
    >>> ckpt.register("train_state", lambda: ts, lambda v: restore(v))
    >>> ckpt.save(step=1000)
    >>> ckpt.load(step=1000)
    """

    def __init__(self, root: str, capture_rng: bool = True):
        self.root = root
        self.capture_rng = capture_rng
        self._components: dict[str, tuple[Callable, Callable, Any, Any]] = {}
        self._migrations: dict[int, Callable[[str], None]] = {}

    def register(self, name: str, getter: Callable[[], Any], setter: Callable[[Any], None],
                 adapter: Any | None = None, template: Callable[[], Any] | None = None) -> None:
        """``getter`` supplies the object at save; ``setter`` receives the
        restored object at load. Adapter defaults to ArrayTreeAdapter."""
        self._components[name] = (getter, setter, adapter or ArrayTreeAdapter(), template)

    def register_migration(self, from_version: int, fn: Callable[[str], None]) -> None:
        """Migrate an on-disk checkpoint written at ``from_version`` forward
        one schema step."""
        self._migrations[from_version] = fn

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int) -> str:
        d = self._dir(step)
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, "meta.json")
        if os.path.exists(meta_path):  # a save over an old one is partial until it ends
            os.remove(meta_path)
        meta = {"schema_version": SCHEMA_VERSION, "step": step,
                "components": list(self._components)}
        if self.capture_rng:
            JSONAdapter().save(os.path.join(d, "_rng"), GlobalRNGState.get())
        for name, (getter, _, adapter, _t) in self._components.items():
            adapter.save(os.path.join(d, name), getter())
        _atomic_write(meta_path, lambda f: json.dump(meta, f), "w")
        return d

    def load(self, step: int) -> None:
        d = self._dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        version = meta.get("schema_version", 0)
        migrated = False
        while version < SCHEMA_VERSION:
            if version not in self._migrations:
                raise RuntimeError(
                    f"checkpoint at schema v{version}, current v{SCHEMA_VERSION}, "
                    f"no migration registered for v{version}"
                )
            self._migrations[version](d)
            version += 1
            migrated = True
        if migrated:
            # persist the new schema version so a migration never runs twice
            meta["schema_version"] = version
            _atomic_write(os.path.join(d, "meta.json"), lambda f: json.dump(meta, f), "w")
        if self.capture_rng and os.path.exists(os.path.join(d, "_rng")):
            GlobalRNGState.set(JSONAdapter().load(os.path.join(d, "_rng")))
        for name, (_, setter, adapter, template) in self._components.items():
            tmpl = template() if template is not None else None
            setter(adapter.load(os.path.join(d, name), tmpl))

    def latest_step(self) -> int | None:
        """The latest complete checkpoint (``meta.json`` is written last,
        so a directory without it is partial or foreign and skipped)."""
        if not os.path.isdir(self.root):
            return None
        steps = []
        for n in os.listdir(self.root):
            if not n.startswith("step_"):
                continue
            suffix = n.removeprefix("step_")
            if not suffix.isdigit():
                continue
            if os.path.exists(os.path.join(self.root, n, "meta.json")):
                steps.append(int(suffix))
        return max(steps) if steps else None
