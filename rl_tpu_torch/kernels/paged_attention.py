"""Paged decode attention over int8 K/V pools (counterpart of
:mod:`rl_tpu.kernels.paged_attention`).

:func:`paged_flash_decode_int8` is :func:`rl_tpu_torch.ops.attention.
paged_flash_decode` with int8 pools ``[N, Hk, block, D]`` and float32
scales ``[N, Hk]``: each (block, kv head) tile is read as int8 and
dequantized by its scale inside the kernel, so no float copy of the pool
is ever made. On CUDA tensors it launches ``csrc/paged_decode_int8.cu``,
which splits each slot's sequence as :func:`rl_tpu_torch.ops.attention.
paged_flash_decode` does (:func:`~rl_tpu_torch.ops.attention.
paged_decode_plan`: a split kernel and a combine, one C call), with the
int8 rows widened and scaled at use; on CPU tensors it runs
:func:`paged_flash_decode_int8_ref`, the plain version. The reference's
registry glue (``decode_mode``, the kernel-off switch) has no
counterpart: the port has no switch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.attention import (
    _BLOCK_SIZES,
    _DTYPES,
    _HEAD_DIMS,
    decode_softmax_pv,
    paged_decode_plan,
)
from . import _build
from .kvcache import dequantize

__all__ = ["paged_flash_decode_int8", "paged_flash_decode_int8_ref"]


def paged_flash_decode_int8_ref(q, pool_k, pool_v, scale_k, scale_v, block_table, attend_lens,
                                scale=None):
    """The plain version: gather and dequantize every table block, then
    one masked softmax in float32 (positions ``< attend_len`` in entries
    ``> 0``; a row with none gives zeros). Returns ``[S, 1, H, D]`` in q's
    dtype."""
    S, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"paged_flash_decode_int8 is the T=1 step; got T={Tq}")
    N, Hk, block, _ = pool_k.shape
    if H % Hk:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({Hk})")
    max_blocks = block_table.shape[1]
    scale = scale if scale is not None else D**-0.5
    L = max_blocks * block
    table = block_table.long()
    safe = table.clamp(0, N - 1)
    # [S, max_blocks, Hk, block, D] -> [S, Hk, L, D]
    k = dequantize(pool_k[safe], scale_k[safe]).permute(0, 2, 1, 3, 4).reshape(S, Hk, L, D)
    v = dequantize(pool_v[safe], scale_v[safe]).permute(0, 2, 1, 3, 4).reshape(S, Hk, L, D)
    qf = (q * scale)[:, 0].float().reshape(S, Hk, H // Hk, D)
    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < attend_lens.long()[:, None]) & (
        table > 0
    ).repeat_interleave(block, dim=1)
    o = decode_softmax_pv(qf, k, v, valid[:, None, None, :])
    return o.reshape(S, 1, H, D).to(q.dtype)


def paged_flash_decode_int8(q, pool_k, pool_v, scale_k, scale_v, block_table, attend_lens,
                            scale=None):
    """Single-token decode attention over int8 paged pools, read in place
    through the block table. q: ``[S, 1, H, D]`` float32 or bfloat16;
    pools ``[N, Hk, block, D]`` int8; scales ``[N, Hk]`` float32; table
    ``[S, max_blocks]`` int32; ``attend_lens [S]`` int32. Returns ``[S, 1,
    H, D]`` in q's dtype. CPU tensors: the plain version. CUDA tensors:
    the CUDA kernel, or an exception; never the plain version."""
    args = (q, pool_k, pool_v, scale_k, scale_v, block_table, attend_lens)
    if q.device.type == "cpu":
        return paged_flash_decode_int8_ref(*args, scale)
    S, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"paged_flash_decode_int8 is the T=1 step; got T={Tq}")
    if any(not t.is_cuda for t in args):
        raise ValueError("paged_flash_decode_int8: CUDA kernel needs CUDA tensors")
    if len({t.device for t in args}) != 1:
        raise ValueError("paged_flash_decode_int8: tensors on different devices")
    N, Hk, block, Dk = pool_k.shape
    if q.dtype not in _DTYPES or pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise ValueError(
            f"paged_flash_decode_int8: q float32 or bfloat16 and int8 pools, got "
            f"{q.dtype}/{pool_k.dtype}/{pool_v.dtype}"
        )
    if D not in _HEAD_DIMS or Dk != D or block not in _BLOCK_SIZES:
        raise ValueError(
            f"paged_flash_decode_int8: kernel supports D in {_HEAD_DIMS} and block in "
            f"{_BLOCK_SIZES}; got D={D} (pool {Dk}), block={block}"
        )
    if H % Hk or pool_v.shape != pool_k.shape:
        raise ValueError("paged_flash_decode_int8: pools must match with Hk dividing H")
    for sc in (scale_k, scale_v):
        if sc.shape != (N, Hk) or sc.dtype != torch.float32:
            raise ValueError("paged_flash_decode_int8: scales must be [N, Hk] float32")
    max_blocks = block_table.shape[1]
    if block_table.shape != (S, max_blocks) or block_table.dtype != torch.int32:
        raise ValueError("paged_flash_decode_int8: block_table must be [S, max_blocks] int32")
    if attend_lens.shape != (S,) or attend_lens.dtype != torch.int32:
        raise ValueError("paged_flash_decode_int8: attend_lens must be [S] int32")
    pool_k, pool_v = pool_k.contiguous(), pool_v.contiguous()
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_flash_decode_int8: pools must be 16-byte aligned")
    scale = scale if scale is not None else D**-0.5
    qs = (q * scale).contiguous()  # scaled in q's dtype, as the reference does
    out = torch.empty_like(qs)
    if S == 0:
        return out
    _launch(qs, pool_k, pool_v, scale_k.contiguous(), scale_v.contiguous(),
            block_table.contiguous(), attend_lens.contiguous(), out)
    _build.count_launch(paged_flash_decode_int8)
    return out


def _paged_decode_int8_smem(D, G):
    """Shared memory of one split block of ``paged_decode_int8.cu`` in
    bytes: two 32-row int8 K/V stages, then float32 queries and the warps'
    states (2 warps at D = 32, else 4) for 1 or up to 4 heads of the
    group."""
    heads, warps = (1 if G == 1 else 4), (2 if D == 32 else 4)
    return 2 * 2 * 32 * D + 4 * (heads * D + warps * heads * (D + 2))


def _launch(qs, pool_k, pool_v, scale_k, scale_v, table, lens, out):
    """One call of the kernel on checked, contiguous CUDA tensors (q
    already scaled, pools 16-byte aligned): the split kernel and the
    combine, on a float32 scratch of :func:`paged_decode_plan`'s shapes."""
    S, H, D = qs.shape[0], qs.shape[2], qs.shape[3]
    _, Hk, block, _ = pool_k.shape
    max_blocks = table.shape[1]
    n_split, acc_shape, ml_shape = paged_decode_plan(S, H, D, block, max_blocks)
    scratch = torch.empty((math.prod(acc_shape) + math.prod(ml_shape),),
                          dtype=torch.float32, device=qs.device)
    fn = _build.function(
        "paged_decode_int8", "rl_paged_decode_int8",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        code = fn(
            qs.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), scale_k.data_ptr(),
            scale_v.data_ptr(), table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), S, H, Hk, D, block, max_blocks, n_split, _DTYPES[qs.dtype],
            stream,
        )
    _build.check(code, "paged_decode_int8", "paged_flash_decode_int8")


paged_flash_decode_int8.launches = 0  # kernel launches (CUDA path only)
