"""Composed replay buffer (counterpart of :mod:`rl_tpu.data.replay.buffer`).

``ReplayBuffer(storage, sampler, writer)`` is configuration; the state
is one ArrayDict ``{"storage", "sampler", "writer"}``. The storage rings
and the prioritized sampler's tree are updated in place;
the small counters (cursor, size, the sampler's step and max priority)
are replaced by new tensors, as the reference replaces everything.
``transform`` maps each sampled batch (after its "index" and the
sampler's info are set). :meth:`ReplayBuffer.make_extend` makes the write
of a fixed-size chunk one registered program (``replay.extend``), a CUDA
graph on the card, for a host loop that feeds the buffer batch by batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...obs.registry import get_registry
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

    def make_extend(self, n: int, donate: bool = True, registry=None) -> "ChunkWriter":
        """The write of exactly ``n`` items as one registered program
        (``replay.extend``), for a host loop that drains a collector's
        queue: ``write(state, items) -> state``. On the card the program
        is a CUDA graph over a static device chunk: each call copies the
        items into it (host items through pinned memory, ``non_blocking``,
        on the current stream) and replays the graph; on the CPU the write
        runs eagerly. Each call counts ``rl_tpu_replay_extends_total`` and
        ``rl_tpu_replay_items_written_total`` in the process metrics
        registry. The state is updated in place, as the reference's
        donated state is: ``donate=False`` is refused."""
        if not donate:
            raise ValueError("make_extend(donate=False): the port writes the buffer in place")
        from ...compile import get_program_registry

        return ChunkWriter(self, n, registry or get_program_registry())

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


class ChunkWriter:
    """:meth:`ReplayBuffer.make_extend`'s callable. ``program`` is its
    registered program, called with a state and :meth:`chunk`."""

    def __init__(self, buffer: ReplayBuffer, n: int, registry):
        self.buffer, self.n = buffer, n
        self.program = registry.register(
            "replay.extend", self._write,
            fingerprint=repr((n, type(buffer.storage).__name__, type(buffer.sampler).__name__,
                              type(buffer.writer).__name__)))
        self._chunk: ArrayDict | None = None  # the graph's static input, on the card
        self._staging: list = []  # two pinned host chunks, each with its copy's event
        self._calls = 0
        reg = get_registry()
        self._m_ext = reg.counter("rl_tpu_replay_extends_total", "chunked buffer writes")
        self._m_items = reg.counter("rl_tpu_replay_items_written_total",
                                    "items written to replay")

    def _write(self, state: ArrayDict, items: ArrayDict) -> ArrayDict:
        return self.buffer.extend(state, items, n=self.n)

    def chunk(self, state: ArrayDict) -> ArrayDict:
        """The static chunk for ``state``'s storage layout (made once)."""
        if self._chunk is None:
            self._chunk = state["storage", "data"].apply(
                lambda buf: torch.zeros((self.n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                                        device=buf.device))
        return self._chunk

    def _stage(self, state: ArrayDict, items: ArrayDict) -> ArrayDict:
        """Copy ``items`` into the static chunk on the current stream: a
        device leaf directly, a host leaf through a pinned staging chunk
        (two, used in turn; one is refilled only once its last copy has
        landed)."""
        chunk = self.chunk(state)
        if not self._staging:
            self._staging = [(chunk.apply(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                                pin_memory=True)), None)
                             for _ in range(2)]
        slot = self._calls % 2
        stage, done = self._staging[slot]
        if done is not None:
            done.synchronize()
        for path, dst in chunk.items(nested=True, leaves_only=True):
            src = items[path]
            if src.is_cuda:
                dst.copy_(src)
            else:
                stage[path].copy_(src)
                dst.copy_(stage[path], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staging[slot] = (stage, event)
        return chunk

    def __call__(self, state: ArrayDict, items: ArrayDict) -> ArrayDict:
        if state["storage", "cursor"].is_cuda:
            items = self._stage(state, items)
        out = self.program(state, items)
        self._calls += 1
        self._m_ext.inc()
        self._m_items.inc(self.n)
        return out
