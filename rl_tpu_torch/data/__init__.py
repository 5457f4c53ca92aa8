"""Data (counterpart of :mod:`rl_tpu.data`; the LLM chat containers, the
tokenizer, ``ArrayDict``, the continuous specs and the device replay
buffer are ported)."""

from .arraydict import ArrayDict
from .replay import DeviceStorage, PrioritizedSampler, RandomSampler, ReplayBuffer
from .specs import Bounded, Composite, Spec, Unbounded

__all__ = ["ArrayDict", "Bounded", "Composite", "DeviceStorage", "PrioritizedSampler",
           "RandomSampler", "ReplayBuffer", "Spec", "Unbounded"]
