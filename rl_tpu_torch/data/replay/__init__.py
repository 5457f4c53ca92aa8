"""Replay (counterpart of :mod:`rl_tpu.data.replay`; the device buffer
with its chunk writer, the eight samplers and the host-tree prioritized
sampler are ported)."""

from .buffer import ChunkWriter, ReplayBuffer
from .host_per import HostPrioritizedSampler
from .samplers import (PrioritizedSampler, PrioritizedSliceSampler, RandomSampler, Sampler,
                       SamplerWithoutReplacement, SliceSampler, SliceSamplerWithoutReplacement,
                       StalenessAwareSampler)
from .storages import DeviceStorage, Storage
from .writers import RoundRobinWriter, Writer

__all__ = ["ChunkWriter", "DeviceStorage", "HostPrioritizedSampler", "PrioritizedSampler",
           "PrioritizedSliceSampler", "RandomSampler", "ReplayBuffer", "RoundRobinWriter",
           "Sampler", "SamplerWithoutReplacement", "SliceSampler",
           "SliceSamplerWithoutReplacement", "StalenessAwareSampler", "Storage", "Writer"]
