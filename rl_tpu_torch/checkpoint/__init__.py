"""Checkpoints (counterpart of :mod:`rl_tpu.checkpoint`)."""

from .checkpoint import (ArrayTreeAdapter, Checkpoint, GlobalRNGState, JSONAdapter, PickleAdapter,
                         restore_into, to_tree)

__all__ = [
    "Checkpoint",
    "ArrayTreeAdapter",
    "JSONAdapter",
    "PickleAdapter",
    "GlobalRNGState",
    "restore_into",
    "to_tree",
]
