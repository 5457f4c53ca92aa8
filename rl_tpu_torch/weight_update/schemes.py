"""Weight publication from the trainer to the rollout model (counterpart
of :mod:`rl_tpu.weight_update.schemes`).

In the port the trainer holds a float32 master model and the rollout side
serves copies in ``cfg.dtype`` (bf16 on the card). The reference publishes
immutable parameter trees, so a rollout that is running keeps the weights
it snapshotted whatever the learner pushes next. PyTorch tensors are
written in place, so the port gets the same guarantee from a ring of
serving copies:

- :class:`DevicePutScheme` writes each push into the next copy of its
  ring, cast on the way, on the caller's CUDA stream; it records a
  "published" event behind the copies and only then bumps the version.
  ``pull_versioned()`` returns ``(copy, version)``; a reader on another
  stream makes that stream wait on :meth:`DevicePutScheme.published`
  (:meth:`~DevicePutScheme.wait_published`) and never waits on the host.
  With one copy (the sequential trainer) every push overwrites the model
  that ``pull()`` returns, as an engine built over it expects.
- :class:`SharedProgramScheme` aliases the pushed module.
- :class:`DoubleBufferScheme` hands weights over through two ``.npz``
  files and an atomically replaced version file.

``ShardedSyncScheme`` waits for the mesh (ROADMAP A7).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Sequence

import numpy as np
import torch

from .._stubs import not_ported

__all__ = ["DevicePutScheme", "DoubleBufferScheme", "ShardedSyncScheme", "SharedProgramScheme",
           "WeightSyncScheme"]


class WeightSyncScheme:
    """Protocol: ``push(master)`` on the sender; ``pull() -> model`` on
    the receiver; ``version`` counts pushes."""

    def push(self, master) -> None:
        raise NotImplementedError

    def pull(self):
        raise NotImplementedError

    def pull_versioned(self):
        """Atomic ``(model, version)`` snapshot (a pipelined consumer must
        know which push it generated with)."""
        return self.pull(), self.version

    @property
    def version(self) -> int:
        raise NotImplementedError


class SharedProgramScheme(WeightSyncScheme):
    """Same-process aliasing: ``push`` keeps a reference to the module,
    ``pull`` returns it; no copy.

    In the reference the pushed params are an immutable tree, so a
    snapshot never changes. Here the pushed module is the one Adam
    updates in place: every later update shows through a pulled
    snapshot, on the card while a rollout may still be reading it. The
    scheme is therefore safe only for the sequential trainer, where
    collect and update never overlap; a pipelined trainer needs
    :class:`DevicePutScheme`'s ring.
    """

    def __init__(self):
        self._model = None
        self._version = 0
        self._lock = threading.Lock()

    def push(self, master: torch.nn.Module) -> None:
        with self._lock:
            self._model = master
            self._version += 1

    def pull(self) -> torch.nn.Module:
        if self._model is None:
            raise RuntimeError("no params pushed yet")
        return self._model

    def pull_versioned(self):
        with self._lock:
            return self.pull(), self._version

    @property
    def version(self) -> int:
        return self._version


class DevicePutScheme(WeightSyncScheme):
    """Publish ``master``'s parameters into a ring of serving models by
    in-place cast copies.

    ``targets`` is one model or a sequence of models with the master's
    parameter names (any parameter dtype), on the rollout device. Push
    ``v`` (1-based) writes copy ``(v - 1) % len(targets)``, so a snapshot
    stays unchanged for the next ``len(targets) - 1`` pushes. A pipelined
    trainer with ``max_pending`` batches in flight holds a ring of
    ``max_pending + 1``: under its ticket gate every batch queued or in
    generation when push ``v`` is issued was generated at version ``v -
    max_pending`` or later, while the copy push ``v`` writes held version
    ``v - max_pending - 1``, so no rollout still reads it
    (:class:`~rl_tpu_torch.trainers.grpo.RolloutPipeline` gives the proof).

    The push runs on the caller's current CUDA stream and enqueues the
    copies without waiting. On the card it records an event behind them
    before it publishes the version; :meth:`published` returns it.
    """

    def __init__(self, targets: torch.nn.Module | Sequence[torch.nn.Module]):
        if isinstance(targets, torch.nn.Module):
            targets = [targets]
        self.targets = list(targets)
        if not self.targets:
            raise ValueError("DevicePutScheme needs at least one target model")
        self._dst = [dict(t.named_parameters()) for t in self.targets]
        if any(d.keys() != self._dst[0].keys() for d in self._dst):
            raise ValueError("DevicePutScheme: the target models' parameters differ by name")
        self._cuda = next(iter(self._dst[0].values())).is_cuda
        self._events: list = [None] * len(self.targets)
        self._slot_version = [0] * len(self.targets)
        self._version = 0
        self._lock = threading.Lock()

    @property
    def target(self) -> torch.nn.Module:
        """The first serving model (the only one of a one-copy ring)."""
        return self.targets[0]

    def _slot(self, version: int) -> int:
        return (version - 1) % len(self.targets)

    @torch.no_grad()
    def push(self, master: torch.nn.Module) -> None:
        version = self._version + 1  # one publisher: only push moves the version
        slot = self._slot(version)
        src, dst = dict(master.named_parameters()), self._dst[slot]
        if src.keys() != dst.keys():
            raise ValueError("push: master and target parameters differ by name")
        names = list(dst)
        torch._foreach_copy_([dst[n] for n in names], [src[n] for n in names],
                             non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            self._events[slot] = event
            self._slot_version[slot] = version
            self._version = version

    def pull(self) -> torch.nn.Module:
        if self._version == 0:
            raise RuntimeError("no params pushed yet")
        return self.targets[self._slot(self._version)]

    def pull_versioned(self):
        with self._lock:
            return self.pull(), self._version

    def published(self, version: int):
        """The event recorded behind push ``version``'s copies (None off
        the card). Raises if a later push has overwritten that copy."""
        with self._lock:
            slot = self._slot(version)
            if self._slot_version[slot] != version:
                raise RuntimeError(
                    f"version {version} is no longer held: its copy holds version "
                    f"{self._slot_version[slot]} (a ring of {len(self.targets)})")
            return self._events[slot]

    def wait_published(self, version: int) -> None:
        """Make the current CUDA stream wait until push ``version`` has
        landed (no host wait; nothing to do off the card)."""
        event = self.published(version)
        if event is not None:
            torch.cuda.current_stream(self.target.device).wait_event(event)

    @property
    def slot_versions(self) -> list[int]:
        """The version each copy of the ring holds (0: never written)."""
        with self._lock:
            return list(self._slot_version)

    @property
    def version(self) -> int:
        return self._version


ShardedSyncScheme = not_ported("ShardedSyncScheme", __name__,
                               "A7: parallel/ (shard-local publication on a mesh)")


class DoubleBufferScheme(WeightSyncScheme):
    """Two on-disk buffers and an atomically replaced version file; sender
    and receiver may be different processes. Push ``v`` saves the
    module's parameters by name into ``buf{v % 2}.npz`` (as float32:
    numpy has no bfloat16, and bf16 widens exactly) and then replaces
    ``VERSION.json``; ``pull`` loads the newest buffer into a module (the
    ``target`` given here or to ``pull``), cast to its parameters' dtype,
    and returns it."""

    def __init__(self, directory: str | None = None, target: torch.nn.Module | None = None):
        self.dir = directory or tempfile.mkdtemp(prefix="rl_tpu_torch_weights_")
        os.makedirs(self.dir, exist_ok=True)
        self.target = target

    def _slot(self, version: int) -> str:
        return os.path.join(self.dir, f"buf{version % 2}.npz")

    def _pointer(self) -> str:
        return os.path.join(self.dir, "VERSION.json")

    @torch.no_grad()
    def push(self, master: torch.nn.Module) -> None:
        version = self.version + 1
        arrays = {n: p.detach().float().cpu().numpy() for n, p in master.named_parameters()}
        np.savez(self._slot(version), **arrays)
        tmp = self._pointer() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": version}, f)
        os.replace(tmp, self._pointer())  # atomic flip

    @torch.no_grad()
    def pull(self, target: torch.nn.Module | None = None) -> torch.nn.Module:
        version = self.version
        if version == 0:
            raise RuntimeError("no params pushed yet")
        target = target if target is not None else self.target
        if target is None:
            raise RuntimeError("the receiver needs a module to load into (pass it to pull)")
        params = dict(target.named_parameters())
        with np.load(self._slot(version)) as z:
            if set(z.files) != params.keys():
                raise ValueError("pull: the buffer and the module's parameters differ by name")
            for n, p in params.items():
                p.copy_(torch.from_numpy(z[n]))
        return target

    @property
    def version(self) -> int:
        try:
            with open(self._pointer()) as f:
                return json.load(f)["version"]
        except FileNotFoundError:
            return 0
