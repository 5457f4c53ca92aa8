"""Data (counterpart of :mod:`rl_tpu.data`; the LLM chat containers, the
tokenizer, ``ArrayDict``, the continuous and discrete specs and the
device replay buffer are ported)."""

from .arraydict import ArrayDict
from .replay import DeviceStorage, PrioritizedSampler, RandomSampler, ReplayBuffer
from .specs import Binary, Bounded, Categorical, Composite, OneHot, Spec, Unbounded

__all__ = ["ArrayDict", "Binary", "Bounded", "Categorical", "Composite", "DeviceStorage",
           "OneHot", "PrioritizedSampler", "RandomSampler", "ReplayBuffer", "Spec", "Unbounded"]
