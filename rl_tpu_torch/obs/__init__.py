"""Observability (counterpart of :mod:`rl_tpu.obs`; only the on-device
step metrics are ported so far)."""

from .device import DeviceMetrics

__all__ = ["DeviceMetrics"]
