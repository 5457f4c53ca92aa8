"""Trainer-to-rollout weight publication (counterpart of
:mod:`rl_tpu.weight_update`)."""

from .schemes import DevicePutScheme, WeightSyncScheme

__all__ = ["DevicePutScheme", "WeightSyncScheme"]
