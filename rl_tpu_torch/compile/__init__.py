"""Shape configuration and the program registry (counterpart of
:mod:`rl_tpu.compile`): the bucket ladders, :class:`ProgramRegistry` and
:class:`CachedProgram` (hot programs captured as CUDA graphs, one per
signature, with ``aot_warmup``; ``stats`` counts the captures),
:class:`GraphPool` (one memory pool for several programs' graphs) and
:class:`ExecutableStore` (the captured graphs in memory; the native
libraries on disk).
"""

from .buckets import ShapeBuckets, pow2ceil
from .registry import (CachedProgram, GraphPool, ProgramRegistry, WarmupHandle,
                       get_program_registry, set_program_registry)
from .store import ExecutableStore, default_store, set_default_store, signature_of

__all__ = ["CachedProgram", "ExecutableStore", "GraphPool", "ProgramRegistry", "ShapeBuckets",
           "WarmupHandle", "default_store", "get_program_registry", "pow2ceil",
           "set_default_store", "set_program_registry", "signature_of"]
