"""Prioritized-replay sum-tree update, kernel B7 (counterpart of
:mod:`rl_tpu.kernels.sumtree`).

:func:`sumtree_update` computes ``priorities[idx[i]] += delta[i]`` and
``esum[idx[i] // fanout] += delta[i]``, each target receiving its adds one
at a time in batch order: the order of the reference's stock scatter-adds
(``.at[idx].add``), which its Pallas kernel is bit-exact against. It
updates both arrays **in place** (the TPU kernel copies them through only
because Pallas outputs are new buffers) and returns them.

On CUDA tensors it launches ``kernels/csrc/sumtree.cu``, which keeps that
order without atomics: up to 4096 updates go to one block that orders
the updates by target (a bitonic sort, skipped when they already ascend)
and lets the first of each run fold it; a larger batch goes to the scan
route, where each update scans the batch (see the source; the kernel
picks the route from the batch size alone). On CPU tensors it runs
:func:`sumtree_update_ref`, an explicitly ordered fold. Each level takes
its index as the reference's ``.at[...].add`` does, on its own: a negative
index counts from the end, a target outside its array is skipped. So -1
adds to the last leaf and to block ``-1 // fanout``, the last one.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.graph import increment_version

from . import _build

__all__ = ["sumtree_update", "sumtree_update_ref"]

KEY_LIMIT = 2**31  # leaves and NB * fanout: the kernel keys targets in 32 bits


def sumtree_update_ref(priorities, esum, idx, delta, *, fanout):
    """The plain version: for i in batch order, ``priorities[j] +=
    delta[i]`` then ``esum[j // fanout] += delta[i]`` with ``j = idx[i]``,
    each a float32 add, with indices taken as NumPy's (negative from the
    end, out of range skipped) on each level on its own. In place; returns
    ``(priorities, esum)``."""
    P, NB = priorities.shape[0], esum.shape[0]
    for i, j in enumerate(idx.reshape(-1).tolist()):
        leaf, blk = j + P if j < 0 else j, j // fanout
        blk = blk + NB if blk < 0 else blk
        if 0 <= leaf < P:
            priorities[leaf] += delta[i]
        if 0 <= blk < NB:
            esum[blk] += delta[i]
    return priorities, esum


def _check(priorities, esum, idx, delta, fanout):
    if priorities.dtype != torch.float32 or esum.dtype != torch.float32:
        raise ValueError("sumtree_update: priorities and esum must be float32")
    if priorities.dim() != 1 or esum.dim() != 1 or idx.dim() != 1 or delta.dim() != 1:
        raise ValueError("sumtree_update: priorities, esum, idx and delta must be 1-D")
    if idx.shape != delta.shape:
        raise ValueError(f"sumtree_update: idx {tuple(idx.shape)} and delta "
                         f"{tuple(delta.shape)} differ")
    if fanout < 1 or esum.shape[0] * fanout < priorities.shape[0]:
        raise ValueError(f"sumtree_update: {esum.shape[0]} blocks of {fanout} do not cover "
                         f"{priorities.shape[0]} leaves")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(f"sumtree_update: idx must be integer, got {idx.dtype}")
    if max(priorities.shape[0], esum.shape[0] * fanout) >= KEY_LIMIT:
        raise ValueError(f"sumtree_update: {priorities.shape[0]} leaves in {esum.shape[0]} "
                         f"blocks of {fanout}: leaves and blocks * fanout must stay below "
                         f"2**31 (32-bit keys)")


def sumtree_update(priorities, esum, idx, delta, *, fanout):
    """Apply the batch of leaf deltas to both tree levels in place;
    returns ``(priorities, esum)``. CPU tensors: :func:`sumtree_update_ref`.
    CUDA tensors: the kernel, or an exception; never the plain version."""
    idx, delta = idx.reshape(-1), delta.reshape(-1)
    _check(priorities, esum, idx, delta, fanout)
    if priorities.device.type == "cpu":
        return sumtree_update_ref(priorities, esum, idx, delta.to(torch.float32),
                                  fanout=fanout)
    tensors = (priorities, esum, idx, delta)
    if not all(t.is_cuda and t.device == priorities.device for t in tensors):
        raise ValueError("sumtree_update: CUDA kernel needs all tensors on one CUDA device")
    if not (priorities.is_contiguous() and esum.is_contiguous()):
        raise ValueError("sumtree_update: priorities and esum are updated in place and "
                         "must be contiguous")
    B = idx.shape[0]
    if B == 0:
        return priorities, esum
    _launch(priorities, esum, idx.to(torch.int64).contiguous(),
            delta.to(torch.float32).contiguous(), fanout)
    # written through raw pointers: bump the version counters as an
    # in-place op does, so autograd and a graph capture see the update
    increment_version(priorities)
    increment_version(esum)
    _build.count_launch(sumtree_update)
    return priorities, esum


def _launch(priorities, esum, idx, delta, fanout):
    """One launch on checked contiguous CUDA tensors (idx int64, delta
    float32); the wrapper's body after its checks."""
    fn = _build.function(
        "sumtree", "rl_sumtree_update",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(priorities.device).cuda_stream
    with torch.cuda.device(priorities.device):
        code = fn(priorities.data_ptr(), esum.data_ptr(), idx.data_ptr(), delta.data_ptr(),
                  idx.shape[0], priorities.shape[0], esum.shape[0], int(fanout), stream)
    _build.check(code, "sumtree", "sumtree_update")


sumtree_update.launches = 0  # kernel launches (CUDA path only)
