"""Composed replay buffer (counterpart of :mod:`rl_tpu.data.replay.buffer`).

``ReplayBuffer(storage, sampler, writer)`` is configuration; the state
is one ArrayDict ``{"storage", "sampler", "writer"}``. The storage rings
and the prioritized sampler's tree are updated in place;
the small counters (cursor, size, the sampler's step and max priority)
are replaced by new tensors, as the reference replaces everything.
``transform`` maps each sampled batch (after its "index" and the
sampler's info are set).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..._stubs import not_ported_call
from ..arraydict import ArrayDict
from .samplers import RandomSampler, Sampler
from .storages import DeviceStorage, Storage
from .writers import RoundRobinWriter, Writer

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    """Storage x sampler x writer."""

    def __init__(self, storage: Storage | None = None, sampler: Sampler | None = None,
                 writer: Writer | None = None,
                 transform: Callable[[ArrayDict], ArrayDict] | None = None,
                 batch_size: int | None = None):
        self.storage = storage if storage is not None else DeviceStorage(10_000)
        self.sampler = sampler if sampler is not None else RandomSampler()
        self.writer = writer if writer is not None else RoundRobinWriter()
        self.transform = transform
        self.batch_size = batch_size

    @property
    def capacity(self) -> int:
        return self.storage.capacity

    def init(self, example: ArrayDict) -> ArrayDict:
        """State for items shaped like ``example`` (no batch dims), on its device."""
        storage = self.storage.init(example)
        return ArrayDict(storage=storage,
                         sampler=self.sampler.init(self.capacity, storage["cursor"].device),
                         writer=self.writer.init(self.capacity))

    def size(self, state: ArrayDict) -> torch.Tensor:
        return self.storage.size(state["storage"])

    def add(self, state: ArrayDict, item: ArrayDict) -> ArrayDict:
        """Insert one item (no batch dims)."""
        return self.extend(state, item.unsqueeze(0), n=1)

    def extend(self, state: ArrayDict, items: ArrayDict, n: int | None = None) -> ArrayDict:
        """Insert a leading-axis batch of ``n`` items."""
        if n is None:
            n = int(items.batch_shape[0])
        idx, wstate, bstorage = self.writer.assign(
            state["writer"], state["storage"], items, n, self.capacity)
        if idx.shape[0] < n:  # a chunk lapping the ring keeps its last items
            items = items[n - idx.shape[0]:]
        bstorage = self.storage.set(bstorage, idx, items)
        sstate = self.sampler.on_write(state["sampler"], idx, items)
        return ArrayDict(storage=bstorage, sampler=sstate, writer=wstate)

    make_extend = not_ported_call("ReplayBuffer.make_extend", __name__,
                                  "A6: AsyncOffPolicyTrainer")

    def sample(self, state: ArrayDict, generator: torch.Generator | None,
               batch_size: int | None = None, *, u: torch.Tensor | None = None
               ) -> tuple[ArrayDict, ArrayDict]:
        """``(batch, new_state)``; the batch carries "index" and, under
        PER, "_weight". ``u`` replaces the sampler's uniform draws."""
        bs = batch_size or self.batch_size
        if bs is None:
            raise ValueError("batch_size not set on buffer or sample call")
        idx, info, sstate = self.sampler.sample(
            state["sampler"], generator, bs, self.size(state), self.capacity, u=u)
        batch = self.storage.get(state["storage"], idx).set("index", idx).update(info)
        if self.transform is not None:
            batch = self.transform(batch)
        return batch, state.set("sampler", sstate)

    def update_priority(self, state: ArrayDict, idx: torch.Tensor, priority: torch.Tensor,
                        ok: torch.Tensor | None = None) -> ArrayDict:
        """Write back priorities; ``ok`` (a 0-dim bool tensor) gates the
        write on the device (see :meth:`PrioritizedSampler.update_priority`)."""
        return state.set("sampler",
                         self.sampler.update_priority(state["sampler"], idx, priority, ok=ok))
