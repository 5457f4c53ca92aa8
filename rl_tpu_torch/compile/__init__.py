"""Shape configuration and the program registry (counterpart of
:mod:`rl_tpu.compile`): the bucket ladders, :class:`ProgramRegistry` and
:class:`CachedProgram` (hot programs captured as CUDA graphs, one per
signature, with ``aot_warmup``; ``stats`` counts the captures),
:class:`GraphPool` (one memory pool for several programs' graphs) and
:class:`ExecutableStore` (the captured graphs in memory; the native
libraries on disk) and :class:`CompileDelta` (the captures made across a
block).
"""

from .buckets import ShapeBuckets, pow2ceil
from .metrics import CompileDelta, compile_counts, compiles_total
from .registry import (CachedProgram, GraphPool, ProgramRegistry, WarmupHandle,
                       get_program_registry, set_program_registry)
from .store import ExecutableStore, default_store, set_default_store, signature_of

__all__ = ["CachedProgram", "CompileDelta", "ExecutableStore", "GraphPool", "ProgramRegistry",
           "ShapeBuckets", "WarmupHandle", "compile_counts", "compiles_total", "default_store",
           "get_program_registry", "pow2ceil", "set_default_store", "set_program_registry",
           "signature_of"]
