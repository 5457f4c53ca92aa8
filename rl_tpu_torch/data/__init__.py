"""Data (counterpart of :mod:`rl_tpu.data`; the LLM chat containers, the
tokenizer, ``ArrayDict``, the continuous and discrete specs, the device
replay buffer and its eight samplers, the host-tree prioritized sampler
and ``MultiStep`` are ported)."""

from .arraydict import ArrayDict
from .postprocs import MultiStep
from .replay import (DeviceStorage, HostPrioritizedSampler, PrioritizedSampler,
                     PrioritizedSliceSampler, RandomSampler, ReplayBuffer, Sampler,
                     SamplerWithoutReplacement, SliceSampler, SliceSamplerWithoutReplacement,
                     StalenessAwareSampler)
from .specs import Binary, Bounded, Categorical, Composite, OneHot, Spec, Unbounded

__all__ = ["ArrayDict", "Binary", "Bounded", "Categorical", "Composite", "DeviceStorage",
           "HostPrioritizedSampler", "MultiStep", "OneHot", "PrioritizedSampler",
           "PrioritizedSliceSampler", "RandomSampler", "ReplayBuffer", "Sampler",
           "SamplerWithoutReplacement", "SliceSampler", "SliceSamplerWithoutReplacement",
           "Spec", "StalenessAwareSampler", "Unbounded"]
