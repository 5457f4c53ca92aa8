"""The store of captured programs (counterpart of
:mod:`rl_tpu.compile.store`).

The reference serializes XLA executables to disk, keyed by the abstract
call signature, so that a restarted process loads them instead of
lowering again. A captured CUDA graph cannot be written to disk: it holds
device addresses of one process. So this store keeps captured graphs in
memory, filed under the program that captured it and its call signature
(tree structure, each tensor's shape, dtype and device, every other
leaf's value), and what a restart reuses is the native code: the hashed
libraries of :mod:`rl_tpu_torch.kernels._build` (``nvcc``) and of
:mod:`rl_tpu_torch.csrc` (``g++``) under :attr:`ExecutableStore.root`,
which load without running a compiler. :meth:`ExecutableStore.libraries`
lists them.
"""

from __future__ import annotations

import threading
import weakref
from pathlib import Path
from typing import Any, Hashable

import torch

from ..kernels._build import BUILD_DIR

__all__ = ["ExecutableStore", "default_store", "set_default_store", "signature_of"]


def _leaf_sig(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"T{tuple(leaf.shape)}:{leaf.dtype}:{leaf.device}"
    if isinstance(leaf, torch.Generator):
        return f"G:{leaf.device}"
    return f"V:{type(leaf).__name__}:{leaf!r}"


def signature_of(tree: Any) -> str:
    """Deterministic string signature of a tree of tensors (dicts, lists,
    tuples and Mappings such as ``ArrayDict``): the structure, then per
    leaf a tensor's shape, dtype and device, a generator's device, or any
    other value's repr. Reads no tensor's data."""
    parts: list[str] = []

    def walk(x: Any) -> str:
        if isinstance(x, (torch.Tensor, torch.Generator)):
            parts.append(_leaf_sig(x))
            return "*"
        if hasattr(x, "keys") and hasattr(x, "__getitem__"):
            return "{" + ",".join(f"{k!r}:{walk(x[k])}" for k in x.keys()) + "}"
        if isinstance(x, (list, tuple)):
            inner = ",".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner})"
        parts.append(_leaf_sig(x))
        return "*"

    return "|".join([walk(tree)] + parts)


class ExecutableStore:
    """Captured graphs in memory, by program and signature; the native
    libraries on disk.

    ``root`` (default ``build/rl_tpu_torch/`` at the root of the checkout)
    is where :mod:`rl_tpu_torch.kernels._build` and
    :mod:`rl_tpu_torch.csrc` put their hashed libraries. A graph holds
    the tensors of the :class:`~rl_tpu_torch.compile.CachedProgram` that
    captured it, so only that program can replay it: the store files each
    graph under its program (held weakly: the graphs go with it) and its
    call signature."""

    def __init__(self, root: str | Path | None = None):
        self.root = Path(root) if root is not None else BUILD_DIR
        self._lock = threading.Lock()
        self._graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self.stats = {"hits": 0, "misses": 0, "saves": 0}

    def save(self, program: Any, signature: Hashable, graph: Any) -> None:
        with self._lock:
            self._graphs.setdefault(program, {})[signature] = graph
            self.stats["saves"] += 1

    def load(self, program: Any, signature: Hashable) -> Any | None:
        with self._lock:
            hit = self._graphs.get(program, {}).get(signature)
            self.stats["hits" if hit is not None else "misses"] += 1
        return hit

    def count(self, program: Any) -> int:
        """Graphs filed under ``program``."""
        with self._lock:
            return len(self._graphs.get(program, ()))

    def libraries(self) -> list[str]:
        """The hashed native libraries under :attr:`root`: what a new
        process loads without running ``nvcc`` or ``g++``."""
        return sorted(p.name for p in self.root.glob("*.so")) if self.root.is_dir() else []


_default: ExecutableStore | None = None
_default_lock = threading.Lock()


def default_store() -> ExecutableStore:
    """The process-default store (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ExecutableStore()
        return _default


def set_default_store(store: ExecutableStore | None) -> ExecutableStore | None:
    """Swap the process default; returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, store
        return prev
