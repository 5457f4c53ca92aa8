"""Hand-written CUDA kernels for Hopper (counterpart of
:mod:`rl_tpu.kernels`).

Sources live in ``csrc/`` and are built by :mod:`._build` at first use.
Each kernel has a wrapper that launches it on CUDA tensors (or raises) and
counts its launches, and a plain PyTorch version beside it that the
wrapper runs on CPU tensors.
"""

from .sampling import fused_sample, fused_sample_ref, gumbel_like
from .sumtree import sumtree_update, sumtree_update_ref

__all__ = ["fused_sample", "fused_sample_ref", "gumbel_like", "sumtree_update",
           "sumtree_update_ref"]
