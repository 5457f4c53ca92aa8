"""Host-side prioritized sampler on the port's C++ segment trees
(counterpart of :mod:`rl_tpu.data.replay.host_per`).

The trees live on the host (:mod:`rl_tpu_torch.csrc`): O(log N) point
updates and prefix-search sampling. Serving a device learner, each
update cycle crosses the host boundary twice: the sampled indices go up
to the device, which gathers the batch and computes td-errors, and the
td-errors come down to update the tree. ``on_write`` and
``update_priority`` read their device indices and priorities back on the
host, and ``sample`` reads the buffer's size; each of those waits for
the device. :class:`~rl_tpu_torch.data.replay.samplers.PrioritizedSampler`
is the device path, which reads nothing back.

The trees are mutable state of the sampler object, as in the reference;
the sampler state returned by :meth:`init` is empty.
"""

from __future__ import annotations

import numpy as np
import torch

from ...csrc import MinSegmentTree, SumSegmentTree
from ..arraydict import ArrayDict
from .samplers import Sampler

__all__ = ["HostPrioritizedSampler"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class HostPrioritizedSampler(Sampler):
    """Proportional PER on host trees: ``P(i) ~ (|p_i| + eps)^alpha``,
    importance weights ``(N P(i))^-beta`` normalised by the largest
    possible one (from the min tree)."""

    def __init__(self, alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-8):
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._sum = None
        self._min = None
        self._max_priority = 1.0
        self.device = torch.device("cpu")
        self._sampled = None  # (the last sampled index tensor, its host copy)

    def init(self, capacity: int, device=None) -> ArrayDict:
        """New trees of ``capacity`` leaves; sampled indices and weights
        go to ``device``."""
        self.capacity = capacity
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._sum = SumSegmentTree(capacity)
        self._min = MinSegmentTree(capacity)
        self._max_priority = 1.0
        return ArrayDict()

    def on_write(self, sstate, idx, items):
        """New items get the largest priority seen so far."""
        idx = _host(idx).astype(np.int64)
        p = self._max_priority**self.alpha
        self._sum[idx] = np.full(idx.shape, p)
        self._min[idx] = np.full(idx.shape, p)
        return sstate

    def update_priority(self, sstate, idx, priority, ok=None):
        """Set ``(|priority| + eps)^alpha`` at ``idx``. A false ``ok`` (a
        0-dim bool tensor: the program's finite guard) leaves the trees
        and the largest priority as they were."""
        if ok is not None and not bool(ok):
            return sstate
        if self._sampled is not None and idx is self._sampled[0]:
            idx = self._sampled[1]  # the indices this sampler sent up: no copy back
        else:
            idx = _host(idx).astype(np.int64)
        priority = np.abs(_host(priority).astype(np.float64)) + self.eps
        self._max_priority = max(self._max_priority, float(priority.max()))
        p = priority**self.alpha
        self._sum[idx] = p
        self._min[idx] = p
        return sstate

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        """``batch_size`` indices by prefix search of ``u * total``.
        ``u`` (uniform draws in [0, 1)) replaces the draws from
        ``generator``. Returns ``(idx, info, sstate)`` with the indices
        (int64) and ``info["_weight"]`` (float32) on the sampler's device."""
        size = int(size)
        total = self._sum.reduce(0, size)
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=generator.device)
        # float32 draws times the mass, in float32 as the reference computes them
        us = _host(u).astype(np.float32) * total
        idx = np.minimum(self._sum.scan(us), size - 1)

        n = max(size, 1)
        probs = self._sum[idx] / max(total, 1e-12)
        weights = (n * np.clip(probs, 1e-12, None)) ** -self.beta
        min_prob = self._min.reduce(0, size) / max(total, 1e-12)
        max_w = (n * max(min_prob, 1e-12)) ** -self.beta
        weights = weights / max(max_w, 1e-12)
        idx = idx.astype(np.int64)
        idx_t = self._upload(idx)
        self._sampled = (idx_t, idx)
        info = ArrayDict(_weight=self._upload(weights.astype(np.float32)), index=idx_t)
        return idx_t, info, sstate

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)
