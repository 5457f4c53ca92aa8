"""Weight publication from the trainer to the rollout model (counterpart
of :mod:`rl_tpu.weight_update.schemes`).

In the port the trainer holds a float32 master model and the rollout side
serves a second model in ``cfg.dtype`` (bf16 on the card, one copy of each
weight). :class:`DevicePutScheme` publishes by copying the master's
parameters into the serving model's tensors in place, cast on the way, on
the current CUDA stream: the push enqueues copies and returns, nothing
waits on the host, and whatever the engine launches next queues behind
the copies. ``pull()`` returns the serving model itself, so an engine
built over it sees every later push.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["DevicePutScheme", "WeightSyncScheme"]


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


class DevicePutScheme(WeightSyncScheme):
    """Publish ``master``'s parameters into ``target`` (a model with the
    same parameter names, any parameter dtype) by an in-place cast copy.
    The target's device is the rollout device; both models normally share
    one card."""

    def __init__(self, target: torch.nn.Module):
        self.target = target
        self._dst = dict(target.named_parameters())
        self._version = 0
        self._lock = threading.Lock()

    @torch.no_grad()
    def push(self, master: torch.nn.Module) -> None:
        src = dict(master.named_parameters())
        if src.keys() != self._dst.keys():
            raise ValueError("push: master and target parameters differ by name")
        names = list(self._dst)
        torch._foreach_copy_([self._dst[n] for n in names], [src[n] for n in names],
                             non_blocking=True)
        with self._lock:
            self._version += 1

    def pull(self) -> torch.nn.Module:
        if self._version == 0:
            raise RuntimeError("no params pushed yet")
        return self.target

    def pull_versioned(self):
        with self._lock:
            return self.pull(), self._version

    @property
    def version(self) -> int:
        return self._version
