"""Replay writers (counterpart of :mod:`rl_tpu.data.replay.writers`;
``RoundRobinWriter`` is ported).

A writer decides where incoming items land. The reference marks the
items of a chunk that laps the ring with an out-of-bounds index
(``INT32_MAX``), which XLA's scatter drops; ``index_put_`` raises on such
an index instead, so here :meth:`Writer.assign` returns indices for the
*kept* items only: the last ``len(idx)`` items of the chunk. Which items
are kept depends only on the chunk and ring sizes, never on the data.
"""

from __future__ import annotations

import torch

from ..._stubs import not_ported
from ..arraydict import ArrayDict

__all__ = ["Writer", "RoundRobinWriter"]


class Writer:
    def init(self, capacity: int) -> ArrayDict:
        return ArrayDict()

    def assign(self, wstate, bstate, items, n: int, capacity: int):
        """``(indices of the last len(indices) of the n items, new writer
        state, new storage state with cursor and size advanced)``."""
        raise NotImplementedError


class RoundRobinWriter(Writer):
    """Ring-cursor writer. A chunk of more than ``capacity`` items keeps
    its last ``capacity`` (later items win, as in the reference)."""

    def assign(self, wstate, bstate, items, n, capacity):
        cursor = bstate["cursor"]
        keep = min(n, capacity)
        offs = torch.arange(n - keep, n, device=cursor.device)
        idx = (cursor + offs) % capacity
        new_b = bstate.replace(cursor=(cursor + n) % capacity,
                               size=torch.clamp_max(bstate["size"] + n, capacity))
        return idx, wstate, new_b


_ROADMAP = "A7: the other writers"
MaxValueWriter = not_ported("MaxValueWriter", __name__, _ROADMAP)
ImmutableDatasetWriter = not_ported("ImmutableDatasetWriter", __name__, _ROADMAP)
