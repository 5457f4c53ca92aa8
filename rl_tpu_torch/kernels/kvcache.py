"""int8 paged KV cache with per-(block, kv-head) scales (counterpart of
:mod:`rl_tpu.kernels.kvcache`).

Layout: beside each head-major pool ``[N, Hk, block, D]`` (int8 when
``TransformerConfig.kv_int8``), the cache carries ``scale_k``/``scale_v``
``[N, Hk]`` float32, one symmetric scale per (pool block, kv head). A
value x is stored as ``round(x / scale)`` clipped to +-127 and read back
as ``q * scale``.

Scales only grow: a write scatter-maxes the incoming tokens' |amax|/127
into their blocks' scales, then requantizes those blocks' stored values
under the new scales (factor old/new), then quantizes and scatters the
incoming tokens. Dequantization always uses the scale a value was
quantized with, so a reused block with an inflated scale loses precision
(step scale/127), never correctness.

Scales are block-major like the pools, so the engine's copy-on-write fork
copies them with the same block indices.

Unlike the reference, which returns new arrays, :func:`quantize_block_write`
updates the pool and the scales IN PLACE (the engine's pools are
long-lived tensors). It also requantizes only the blocks it writes when
the write is small: for every other block the factor is exactly 1.0 and
``round(q * 1.0) = q``, so skipping them changes no bit, and a decode step
then touches 8 blocks instead of the whole pool.
"""

from __future__ import annotations

import torch

__all__ = [
    "dequantize",
    "effective_blocks_ratio",
    "init_scales",
    "kv_block_bytes",
    "quantize_block_write",
]


def init_scales(n_blocks: int, kv_heads: int, device=None) -> torch.Tensor:
    return torch.zeros((n_blocks, kv_heads), dtype=torch.float32, device=device)


def _requant(q, factor):
    """``clip(round(q * factor), -127, 127)`` as int8; factor broadcast
    over the trailing (block, D) dims."""
    return torch.clamp(torch.round(q.float() * factor[..., None, None]), -127, 127).to(torch.int8)


def _requant_written(pool, factor, blk):
    """Requantize the blocks of ``blk`` (one gather and one scatter of a
    block per written row): only they can have a factor other than 1.0. A
    block written by several rows gets the same values from each."""
    pool[blk] = _requant(pool[blk], factor[blk])


def _requant_pool(pool, factor):
    """Requantize every block (one pass over the pool), as the reference
    does."""
    pool.copy_(_requant(pool, factor))


def quantize_block_write(pool, scale, flat_blk, flat_off, vals):
    """The int8 twin of ``pool[flat_blk, :, flat_off] = vals``, in place.

    pool: ``[N, Hk, block, D]`` int8; scale: ``[N, Hk]`` float32;
    flat_blk/flat_off: ``[M]`` integer (inactive rows already sent to
    scratch block 0); vals: ``[M, Hk, D]`` float. Returns ``(pool,
    scale)``, the same tensors, updated.

    The reference's steps and order of operations, so that pools and
    scales match it bit for bit: grow each touched block's scale to cover
    the incoming amax (scatter-max: duplicates resolve to the true max),
    requantize under the grown scales, then quantize and scatter the
    incoming tokens.
    """
    v = vals.float()
    need = v.abs().amax(dim=-1) / 127.0  # [M, Hk]
    blk = flat_blk.long()
    old = scale.clone()
    scale.scatter_reduce_(0, blk[:, None].expand_as(need), need, "amax", include_self=True)
    safe = torch.where(scale > 0, scale, 1.0)
    factor = torch.where(scale > 0, old / safe, 1.0)  # [N, Hk]
    # the written blocks alone move fewer bytes while the rows are fewer
    # than the pool's blocks (a decode step: one row a slot); a prefill's
    # rows repeat each block block_size times, so past that the one pass
    # over the pool moves fewer (chip_smoke.py times both ways at a decode
    # write and a prefill round)
    if blk.numel() < pool.shape[0]:
        _requant_written(pool, factor, blk)
    else:
        _requant_pool(pool, factor)
    q = torch.clamp(torch.round(v / safe[blk][:, :, None]), -127, 127).to(torch.int8)
    pool[blk, :, flat_off.long()] = q
    return pool, scale


def dequantize(q, scale):
    """q: ``[..., Hk, block, D]`` int8 (pool-gather layout); scale:
    ``[..., Hk]`` float32, broadcast over the trailing (block, D) dims."""
    return q.float() * scale[..., None, None]


def kv_block_bytes(block: int, kv_heads: int, head_dim: int, *, int8: bool) -> int:
    """Device bytes one pool block costs for K+V together (+ scales if
    int8), against a float32 pool."""
    elems = 2 * kv_heads * block * head_dim
    if int8:
        return elems + 2 * kv_heads * 4
    return elems * 4


def effective_blocks_ratio(block: int, kv_heads: int, head_dim: int) -> float:
    """How many int8 blocks fit in the memory one float32 block takes."""
    return kv_block_bytes(block, kv_heads, head_dim, int8=False) / kv_block_bytes(
        block, kv_heads, head_dim, int8=True
    )
