"""Replay (counterpart of :mod:`rl_tpu.data.replay`; the device buffer
with the uniform and prioritized samplers is ported)."""

from .buffer import ReplayBuffer
from .samplers import PrioritizedSampler, RandomSampler, Sampler
from .storages import DeviceStorage, Storage
from .writers import RoundRobinWriter, Writer

__all__ = ["DeviceStorage", "PrioritizedSampler", "RandomSampler", "ReplayBuffer",
           "RoundRobinWriter", "Sampler", "Storage", "Writer"]
