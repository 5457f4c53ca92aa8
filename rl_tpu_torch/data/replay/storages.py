"""Replay storages (counterpart of :mod:`rl_tpu.data.replay.storages`;
``DeviceStorage`` is ported).

``DeviceStorage`` preallocates a ``[capacity, *feature]`` ring per leaf
on the example's device. Its state is ``ArrayDict(data, cursor, size)``;
``set`` writes the rings in place (``index_put_``), where the reference
returns updated copies, so a whole replay buffer is never copied.
"""

from __future__ import annotations

from typing import Any

import torch

from ..._stubs import not_ported
from ..arraydict import ArrayDict

__all__ = ["Storage", "DeviceStorage"]


class Storage:
    """Abstract storage: ``init`` from an example item; ``set``/``get`` by
    index; the size lives in the state."""

    def __init__(self, capacity: int):
        self.capacity = capacity

    def init(self, example: ArrayDict) -> Any:
        raise NotImplementedError

    def set(self, state, idx: torch.Tensor, items: ArrayDict):
        raise NotImplementedError

    def get(self, state, idx: torch.Tensor) -> ArrayDict:
        raise NotImplementedError

    def size(self, state) -> torch.Tensor:
        raise NotImplementedError


class DeviceStorage(Storage):
    """Preallocated ring of ArrayDicts on the device of the example item
    (whose batch dims, if any, are ignored: the layout is per item)."""

    def __init__(self, capacity: int, sharding: Any = None):
        if sharding is not None:
            raise NotImplementedError(
                "DeviceStorage(sharding=...) is not ported yet (ROADMAP A7: parallel/)")
        super().__init__(capacity)

    def init(self, example: ArrayDict) -> ArrayDict:
        dev = example.leaves()[0].device
        zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)  # noqa: E731
        return ArrayDict(
            data=example.apply(lambda x: torch.zeros((self.capacity,) + tuple(x.shape),
                                                     dtype=x.dtype, device=x.device)),
            cursor=zero(), size=zero())

    def set(self, state, idx, items):
        """Write ``items`` at ``idx`` in place (``idx`` distinct)."""
        for path, buf in state["data"].items(nested=True, leaves_only=True):
            buf[idx] = items[path].to(buf.dtype)
        return state

    def get(self, state, idx):
        return state["data"].apply(lambda buf: buf[idx])

    def size(self, state):
        return state["size"]


_ROADMAP = "A7: host storages come with the host-replay slice"
MemmapStorage = not_ported("MemmapStorage", __name__, _ROADMAP)
ListStorage = not_ported("ListStorage", __name__, _ROADMAP)
CompressedListStorage = not_ported("CompressedListStorage", __name__, _ROADMAP)
StorageEnsemble = not_ported("StorageEnsemble", __name__, _ROADMAP)
