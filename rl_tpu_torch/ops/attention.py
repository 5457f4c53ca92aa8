"""Paged single-token decode attention (counterpart of the paged part of
:mod:`rl_tpu.ops.attention`).

:func:`paged_flash_decode` keeps the reference's signature and layouts:
q ``[S, 1, H, D]``; head-major pools ``[N, Hk, block, D]`` shared by all
slots; block table ``[S, max_blocks]`` int32 with ``-1`` for unassigned
entries and block 0 as reserved scratch; ``attend_lens = len + 1`` for the
decode-after-write step. On CUDA tensors it launches the hand-written
kernel ``kernels/csrc/paged_decode.cu``; on CPU tensors it runs
:func:`paged_flash_decode_ref`, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build

__all__ = ["paged_flash_decode", "paged_flash_decode_ref"]

_HEAD_DIMS = (32, 64, 128)
_BLOCK_SIZES = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def paged_flash_decode_ref(q, pool_k, pool_v, block_table, attend_lens, scale=None):
    """The plain version: gather every table block, then one masked
    softmax in float32. A position counts when it is ``< attend_len`` and
    its table entry is ``> 0``; a row with no such position gives zeros.
    Returns ``[S, 1, H, D]`` in q's dtype."""
    S, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"paged_flash_decode is the T=1 step; got T={Tq}")
    N, Hk, block, _ = pool_k.shape
    if H % Hk:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({Hk})")
    max_blocks = block_table.shape[1]
    scale = scale if scale is not None else D**-0.5
    L = max_blocks * block
    table = block_table.long()
    safe = table.clamp(0, N - 1)
    # [S, max_blocks, Hk, block, D] -> [S, Hk, L, D]
    k = pool_k[safe].permute(0, 2, 1, 3, 4).reshape(S, Hk, L, D).float()
    v = pool_v[safe].permute(0, 2, 1, 3, 4).reshape(S, Hk, L, D).float()
    qf = (q * scale)[:, 0].float().reshape(S, Hk, H // Hk, D)
    s = torch.einsum("sgrd,sgld->sgrl", qf, k)
    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < attend_lens.long()[:, None]) & (
        table > 0
    ).repeat_interleave(block, dim=1)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - torch.where(valid, m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("sgrl,sgld->sgrd", p, v)
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.reshape(S, 1, H, D).to(q.dtype)


def paged_flash_decode(q, pool_k, pool_v, block_table, attend_lens, scale=None):
    """Single-token decode attention over the paged KV pool, read in place
    through the block table. CPU tensors: :func:`paged_flash_decode_ref`.
    CUDA tensors: the CUDA kernel, or an exception; never the plain
    version. Supported by the kernel: ``D`` in (32, 64, 128), ``block`` in
    (8, 16, 32, 64), float32 or bfloat16 (q and pools alike)."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(
            q, pool_k, pool_v, block_table, attend_lens, scale
        )
    S, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"paged_flash_decode is the T=1 step; got T={Tq}")
    N, Hk, block, Dk = pool_k.shape
    tensors = (q, pool_k, pool_v, block_table, attend_lens)
    if any(not t.is_cuda for t in tensors):
        raise ValueError("paged_flash_decode: CUDA kernel needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_flash_decode: tensors on different devices")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError(
            f"paged_flash_decode: q/pools must share float32 or bfloat16, got "
            f"{q.dtype}/{pool_k.dtype}/{pool_v.dtype}"
        )
    if D not in _HEAD_DIMS or Dk != D or block not in _BLOCK_SIZES:
        raise ValueError(
            f"paged_flash_decode: kernel supports D in {_HEAD_DIMS} and block "
            f"in {_BLOCK_SIZES}; got D={D} (pool {Dk}), block={block}"
        )
    if H % Hk:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({Hk})")
    if pool_v.shape != pool_k.shape:
        raise ValueError("paged_flash_decode: pool_k and pool_v shapes differ")
    max_blocks = block_table.shape[1]
    if block_table.shape != (S, max_blocks) or block_table.dtype != torch.int32:
        raise ValueError("paged_flash_decode: block_table must be [S, max_blocks] int32")
    if attend_lens.shape != (S,) or attend_lens.dtype != torch.int32:
        raise ValueError("paged_flash_decode: attend_lens must be [S] int32")
    G = H // Hk
    smem = 4 * (2 * G * D + 2 * block * D + G * block + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode: group of {G} heads needs {smem} B of shared memory")
    scale = scale if scale is not None else D**-0.5
    # the reference scales q in q's dtype before its kernel
    qs = (q * scale).contiguous()
    out = torch.empty_like(qs)
    if S == 0:
        return out
    _launch(
        qs, pool_k.contiguous(), pool_v.contiguous(), block_table.contiguous(),
        attend_lens.contiguous(), out,
    )
    paged_flash_decode.launches += 1
    return out


def _launch(qs, pool_k, pool_v, table, lens, out):
    """One launch of the kernel on checked, contiguous CUDA tensors (q
    already scaled); the wrapper's body after its checks."""
    S, H, D = qs.shape[0], qs.shape[2], qs.shape[3]
    _, Hk, block, _ = pool_k.shape
    fn = _build.function(
        "paged_decode", "rl_paged_decode",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        code = fn(
            qs.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            S, H, Hk, D, block, table.shape[1], _DTYPES[qs.dtype], stream,
        )
    _build.check(code, "paged_decode", "paged_flash_decode")


paged_flash_decode.launches = 0  # kernel launches (CUDA path only)
