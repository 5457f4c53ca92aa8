"""Prefix-aware KV memory tier (counterpart of :mod:`rl_tpu.kvmem`).

A radix tree over token-block sequences maps shared prompt prefixes to
refcounted physical KV blocks, with copy-on-write paged allocation and
leaf-refcounted LRU eviction: the layer that makes a request pay for the
KV blocks it adds, not for its whole context.
"""

from .allocator import DEFER_ROUND, AdmitPlan, PrefixKVAllocator
from .radix import PrefixTree, RadixNode

__all__ = [
    "AdmitPlan",
    "DEFER_ROUND",
    "PrefixKVAllocator",
    "PrefixTree",
    "RadixNode",
]
