"""Trainer-to-rollout weight publication (counterpart of
:mod:`rl_tpu.weight_update`)."""

from .schemes import (DevicePutScheme, DoubleBufferScheme, ShardedSyncScheme,
                      SharedProgramScheme, WeightSyncScheme)

__all__ = ["DevicePutScheme", "DoubleBufferScheme", "ShardedSyncScheme", "SharedProgramScheme",
           "WeightSyncScheme"]
