"""Shape configuration for the serving engine (counterpart of
:mod:`rl_tpu.compile`; only the bucket ladders are ported so far)."""

from .buckets import ShapeBuckets, pow2ceil

__all__ = ["ShapeBuckets", "pow2ceil"]
