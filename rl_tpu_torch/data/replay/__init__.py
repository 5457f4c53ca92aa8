"""Replay (counterpart of :mod:`rl_tpu.data.replay`; the device buffer
with the uniform and prioritized samplers and the host-tree prioritized
sampler are ported)."""

from .buffer import ReplayBuffer
from .host_per import HostPrioritizedSampler
from .samplers import PrioritizedSampler, RandomSampler, Sampler
from .storages import DeviceStorage, Storage
from .writers import RoundRobinWriter, Writer

__all__ = ["DeviceStorage", "HostPrioritizedSampler", "PrioritizedSampler", "RandomSampler",
           "ReplayBuffer", "RoundRobinWriter", "Sampler", "Storage", "Writer"]
