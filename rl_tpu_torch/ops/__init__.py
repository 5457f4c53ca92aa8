"""Tensor operations with hand-written kernels (counterpart of
:mod:`rl_tpu.ops`; only the paged decode attention is ported so far)."""

from .attention import paged_flash_decode, paged_flash_decode_ref

__all__ = ["paged_flash_decode", "paged_flash_decode_ref"]
