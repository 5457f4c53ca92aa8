"""Flash attention and paged single-token decode attention (counterpart of
:mod:`rl_tpu.ops.attention`).

:func:`flash_attention` is the training and scoring attention over
``[B, T, H, D]`` with GQA/MQA, a padding ``kv_mask`` or packed
``segment_ids``. Both masks lower to int32 query and key segment ids, as
the reference's ``_seg_from_args`` does. A ``torch.autograd.Function``
saves ``o`` and the float32 per-row logsumexp and runs the two backward
kernels (FlashAttention-2 recompute scheme) in place of the reference's
``jax.custom_vjp``. On CUDA tensors the three kernels are
``kernels/csrc/flash_fwd.cu`` (:func:`flash_fwd`) and
``kernels/csrc/flash_bwd.cu`` (:func:`flash_bwd`, which launches
:func:`flash_bwd_dq` and :func:`flash_bwd_dkv` on inputs made once); on
CPU tensors :func:`flash_attention_ref` and
:func:`flash_attention_bwd_ref`, the plain versions. A query row with no
attended key (a left-padded prompt's pad positions) gives zeros and
lse = -1e30 in both.

:func:`flash_decode` is the T=1 step of the dense-cache ``generate``: q
``[B, 1, H, D]`` over a preallocated cache ``[B, S, Hk, D]`` whose first
``cache_len`` positions (a Python int) are filled, with an optional
``kv_mask [B, S]``. On CUDA tensors it launches
``kernels/csrc/flash_decode.cu``, which splits the positions below
``cache_len`` into chunks of :data:`PAGED_SPLIT_CHUNK` across blocks
(:func:`flash_decode_plan`), never fetches a masked position, and merges
the chunks' states in a second kernel; on CPU tensors
:func:`flash_decode_ref`. A row with no visible key gives zeros.

:func:`paged_flash_decode` keeps the reference's signature and layouts:
q ``[S, 1, H, D]``; head-major pools ``[N, Hk, block, D]`` shared by all
slots; block table ``[S, max_blocks]`` int32 with ``-1`` for unassigned
entries and block 0 as reserved scratch; ``attend_lens = len + 1`` for the
decode-after-write step. On CUDA tensors it launches the hand-written
kernel ``kernels/csrc/paged_decode.cu``, which splits each slot's
sequence into chunks of :data:`PAGED_SPLIT_CHUNK` positions across blocks
(:func:`paged_decode_plan`) and merges their states in a second kernel; on
CPU tensors it runs :func:`paged_flash_decode_ref`, the plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import math
import operator

import torch

from ..kernels import _build

__all__ = [
    "decode_softmax_pv",
    "flash_attention",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_inputs",
    "flash_decode",
    "flash_decode_plan",
    "flash_decode_ref",
    "flash_fwd",
    "paged_decode_plan",
    "paged_flash_decode",
    "paged_flash_decode_ref",
]

_HEAD_DIMS = (32, 64, 128)
_BLOCK_SIZES = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def decode_softmax_pv(qf, k, v, valid):
    """The decode kernels' plain arithmetic: float32 ``qf [S, Hk, G, D]``
    (already scaled) against ``k``/``v [S, Hk, L, D]``, one softmax over
    the positions ``valid [S, 1, 1, L]`` marks; a row with no valid
    position gives zeros. Returns ``[S, Hk, G, D]`` float32."""
    s = torch.einsum("sgrd,sgld->sgrl", qf, k)
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - torch.where(valid, m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("sgrl,sgld->sgrd", p, v)
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


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
    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < attend_lens.long()[:, None]) & (
        table > 0
    ).repeat_interleave(block, dim=1)
    o = decode_softmax_pv(qf, k, v, valid[:, None, None, :])
    return o.reshape(S, 1, H, D).to(q.dtype)


PAGED_SPLIT_CHUNK = 64  # positions per split of the paged and dense decode (kChunk in paged_split.cuh)


def paged_decode_plan(S, H, D, block, max_blocks):
    """The paged-decode kernel's split plan, fixed by the shapes alone (the
    host never reads the device lengths): ``(n_split, acc_shape,
    ml_shape)``. Split ``i`` of a slot covers positions ``[64 i, 64 i +
    64)``; it writes its unnormalised float32 ``acc`` ``[S, H, n_split,
    D]`` and its ``(m, l)`` ``[S, H, n_split, 2]`` into one scratch
    buffer, and only the splits that start below the slot's length do."""
    n_split = -(-max_blocks * block // PAGED_SPLIT_CHUNK)
    return n_split, (S, H, n_split, D), (S, H, n_split, 2)


def _paged_decode_smem(element_size, D, G):
    """Shared memory of one split block of ``paged_decode.cu`` in bytes:
    two 32-row K/V stages in the pools' type, then float32 queries and the
    four warps' states for up to 1, 4 or 8 heads of the group."""
    heads = 1 if G == 1 else 4 if G <= 4 else 8
    return element_size * 2 * 2 * 32 * D + 4 * (heads * D + 4 * heads * (D + 2))


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
    smem = _paged_decode_smem(q.element_size(), D, H // Hk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode: needs {smem} B of shared memory")
    pool_k, pool_v = pool_k.contiguous(), pool_v.contiguous()
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_flash_decode: pools must start 16-byte aligned "
                         "(the kernel copies 16-byte vectors)")
    scale = scale if scale is not None else D**-0.5
    # the reference scales q in q's dtype before its kernel
    qs = (q * scale).contiguous()
    out = torch.empty_like(qs)
    if S == 0:
        return out
    _launch(qs, pool_k, pool_v, block_table.contiguous(), attend_lens.contiguous(), out)
    _build.count_launch(paged_flash_decode)
    return out


def _launch(qs, pool_k, pool_v, table, lens, out):
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
        "paged_decode", "rl_paged_decode",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        code = fn(
            qs.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            S, H, Hk, D, block, max_blocks, n_split, _DTYPES[qs.dtype], stream,
        )
    _build.check(code, "paged_decode", "paged_flash_decode")


paged_flash_decode.launches = 0  # kernel launches (CUDA path only)


# -- dense-cache decode ---------------------------------------------------------


def flash_decode_plan(B, H, D, cache_len):
    """The dense-decode kernel's split plan, from the host-side
    ``cache_len``: ``(n_split, acc_shape, ml_shape)``. Split ``i`` covers
    positions ``[64 i, 64 i + 64)`` below ``cache_len``; every split writes
    its ``(m, l)`` ``[B, H, n_split, 2]`` into one float32 scratch after
    its unnormalised ``acc`` ``[B, H, n_split, D]``, which a split the
    mask hides whole leaves unwritten (its ``l`` is 0)."""
    n_split = -(-cache_len // PAGED_SPLIT_CHUNK)
    return n_split, (B, H, n_split, D), (B, H, n_split, 2)


def flash_decode_ref(q, k_cache, v_cache, cache_len, scale=None, kv_mask=None):
    """The plain version: one masked softmax in float32 over the cache
    positions below ``cache_len`` that ``kv_mask`` (if given) marks; a row
    with no such position gives zeros. Returns ``[B, 1, H, D]`` in q's
    dtype."""
    B, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"flash_decode is the T=1 step; got T={Tq}")
    Hk = k_cache.shape[2]
    if H % Hk:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({Hk})")
    scale = scale if scale is not None else D**-0.5
    n = cache_len
    if n == 0:
        return torch.zeros_like(q)
    k = k_cache[:, :n].permute(0, 2, 1, 3).float()  # [B, Hk, n, D]
    v = v_cache[:, :n].permute(0, 2, 1, 3).float()
    qf = (q * scale)[:, 0].float().reshape(B, Hk, H // Hk, D)
    valid = torch.ones((B, n), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = valid & kv_mask[:, :n].bool()
    o = decode_softmax_pv(qf, k, v, valid[:, None, None, :])
    return o.reshape(B, 1, H, D).to(q.dtype)


def _aligned16(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels load
    16-byte vectors); a fresh copy when the storage offset breaks it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_operand(t):
    """A flash kernel's q, k, v or do: contiguous, and for bf16 (whose
    kernels copy 16-byte vectors with cp.async) also 16-byte aligned, a
    view at an odd offset taking one copy. A paged pool is never copied
    this way: a copy of the whole pool each step would cost more than the
    step, so the paged wrappers raise instead."""
    return _aligned16(t) if t.dtype == torch.bfloat16 else t.contiguous()


def flash_decode(q, k_cache, v_cache, cache_len, scale=None, kv_mask=None):
    """Single-token decode attention over a dense cache ``[B, S, Hk, D]``
    filled below ``cache_len`` (a host int: nothing is read back from
    the device). CPU tensors: :func:`flash_decode_ref`. CUDA tensors: the
    CUDA kernel, which reads only positions below ``cache_len``, or an
    exception; never the plain version. Supported by the kernel: ``D`` in
    (32, 64, 128), float32 or bfloat16 (q and cache alike)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, cache_len, scale, kv_mask)
    B, Tq, H, D = q.shape
    if Tq != 1:
        raise ValueError(f"flash_decode is the T=1 step; got T={Tq}")
    tensors = [t for t in (q, k_cache, v_cache, kv_mask) if t is not None]
    if any(not t.is_cuda for t in tensors):
        raise ValueError("flash_decode: CUDA kernel needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_decode: tensors on different devices")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"flash_decode: q/cache must share float32 or bfloat16, got "
            f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
        )
    Bk, S, Hk, Dk = k_cache.shape
    if D not in _HEAD_DIMS or Dk != D or Bk != B or H % Hk or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"flash_decode: kernel supports D in {_HEAD_DIMS} with k/v [B, S, Hk, D], Hk "
            f"dividing H; got q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}"
        )
    if kv_mask is not None and tuple(kv_mask.shape) != (B, S):
        raise ValueError(f"flash_decode: kv_mask must be [B, S] = [{B}, {S}]")
    n = operator.index(cache_len)
    if not 0 <= n <= S:
        raise ValueError(f"flash_decode: cache_len {n} outside 0..{S}")
    scale = scale if scale is not None else D**-0.5
    qs = (q * scale).contiguous()  # scaled in q's dtype, as the reference does
    out = torch.empty_like(qs)
    if B == 0:
        return out
    mask = None if kv_mask is None else kv_mask.to(torch.bool).contiguous()
    _decode_launch(qs, _aligned16(k_cache), _aligned16(v_cache), mask, out, n)
    _build.count_launch(flash_decode)
    return out


def _decode_launch(qs, k, v, mask, out, cache_len):
    """One call of ``flash_decode.cu`` on checked CUDA tensors (q already
    scaled, k/v 16-byte aligned, mask bool or None): the split kernel and
    the combine, on a float32 scratch of :func:`flash_decode_plan`'s
    shapes."""
    B, H, D = qs.shape[0], qs.shape[2], qs.shape[3]
    S, Hk = k.shape[1], k.shape[2]
    n_split, acc_shape, ml_shape = flash_decode_plan(B, H, D, cache_len)
    scratch = torch.empty((math.prod(acc_shape) + math.prod(ml_shape),),
                          dtype=torch.float32, device=qs.device)
    fn = _build.function(
        "flash_decode", "rl_flash_decode",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        code = fn(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B, S, H, Hk, D, cache_len, n_split, _DTYPES[qs.dtype], stream,
        )
    _build.check(code, "flash_decode", "flash_decode")


flash_decode.launches = 0  # kernel launches (CUDA path only)


# -- flash attention ----------------------------------------------------------

_NEG_INF = -1e30  # the reference's masked score


def _seg_from_args(kv_mask, segment_ids, B, T, device):
    """(qseg, kseg) int32 [B, T], or (None, None): ``segment_ids`` are both;
    a padding ``kv_mask`` gives queries segment 1 and masked keys -1, so
    padded keys are invisible to every query."""
    if kv_mask is not None and segment_ids is not None:
        raise ValueError("pass kv_mask or segment_ids, not both")
    if segment_ids is not None:
        seg = segment_ids.to(device=device, dtype=torch.int32).contiguous()
        return seg, seg
    if kv_mask is not None:
        kseg = torch.where(kv_mask.to(device).bool(), 1, -1).to(torch.int32)
        return torch.ones((B, T), dtype=torch.int32, device=device), kseg.contiguous()
    return None, None


def _attend_mask(B, T, causal, qseg, kseg, device):
    """[B, 1, T, T] bool (or [1, 1, T, T]): query t attends key u."""
    valid = torch.ones((T, T), dtype=torch.bool, device=device)
    if causal:
        valid = valid.tril()
    valid = valid[None, None]
    if qseg is not None:
        valid = valid & (qseg[:, None, :, None] == kseg[:, None, None, :])
    return valid


def _heads_first(x, group=1):
    """[B, T, Hx, D] -> float32 [B, Hx*group, T, D] (kv heads repeated per
    query head of their group)."""
    x = x.float().permute(0, 2, 1, 3)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def flash_attention_ref(q, k, v, causal=True, scale=None, qseg=None, kseg=None):
    """The plain version of the forward: one masked softmax in float32.
    Returns ``(o [B, T, H, D] in q's dtype, lse [B, H, T] float32)``; a row
    with no attended key gives o = 0 and lse = -1e30."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    scale = scale if scale is not None else D**-0.5
    s = _heads_first(q) @ _heads_first(k, G).transpose(-1, -2) * scale
    valid = _attend_mask(B, T, causal, qseg, kseg, q.device)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l > 0, l, 1.0)
    o = (p @ _heads_first(v, G)) / l
    lse = (m + torch.log(l))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, scale=None, qseg=None,
                            kseg=None):
    """The plain version of the backward: P recomputed from ``lse``
    (masked by a select), ``delta = sum(do * o)``; dK/dV summed over each
    KV head's query-head group. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else D**-0.5
    qf, kf, vf = _heads_first(q), _heads_first(k, G), _heads_first(v, G)
    dof = _heads_first(do)
    delta = (dof * _heads_first(o)).sum(dim=-1)  # [B, H, T]
    valid = _attend_mask(B, T, causal, qseg, kseg, q.device)
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf

    def per_kv_head(x):  # [B, H, T, D] -> [B, T, Hk, D], group-summed
        return x.reshape(B, Hk, G, T, D).sum(dim=2).permute(0, 2, 1, 3)

    return (dq.permute(0, 2, 1, 3).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _check_flash(name, tensors, q, k, v, qseg, kseg):
    if (qseg is None) != (kseg is None):
        raise ValueError(f"{name}: pass both query and key segment ids, or neither")
    if any(not t.is_cuda for t in tensors):
        raise ValueError(f"{name}: CUDA kernel needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: kernel supports D in {_HEAD_DIMS}, got {D}")
    Hk = k.shape[2]
    if k.shape != (B, T, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"{name}: k/v must be [B, T, Hk, D] with Hk dividing H; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if qseg is not None and any(s.shape != (B, T) or s.dtype != torch.int32 for s in (qseg, kseg)):
        raise ValueError(f"{name}: segment ids must be [B, T] int32")


def _seg_ptrs(qseg, kseg):
    if qseg is None:
        return None, None
    return qseg.data_ptr(), kseg.data_ptr()


def flash_fwd(q, k, v, qseg=None, kseg=None, causal=True, scale=None):
    """Forward: ``(o, lse)`` as :func:`flash_attention_ref` returns them.
    CPU tensors: the plain version. CUDA tensors: the kernel
    (``flash_fwd.cu``), or an exception; never the plain version."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale, qseg, kseg)
    tensors = [t for t in (q, k, v, qseg, kseg) if t is not None]
    _check_flash("flash_fwd", tensors, q, k, v, qseg, kseg)
    B, T, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    q, k, v = _flash_operand(q), _flash_operand(k), _flash_operand(v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    fn = _build.function(
        "flash_fwd", "rl_flash_fwd",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                       ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(qseg, kseg),
                  o.data_ptr(), lse.data_ptr(), B, T, H, k.shape[2], D, int(causal),
                  float(scale), _DTYPES[q.dtype], stream)
    _build.check(code, "flash_fwd", "flash_fwd")
    _build.count_launch(flash_fwd)
    return o, lse


def _bwd_launch(symbol, q, k, v, do, lse, delta, qseg, kseg, outs, causal, scale):
    B, T, H, D = q.shape
    fn = _build.function(
        "flash_bwd", symbol,
        [ctypes.c_void_p] * (8 + len(outs)) + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), *_seg_ptrs(qseg, kseg), *(t.data_ptr() for t in outs),
                  B, T, H, k.shape[2], D, int(causal), float(scale), _DTYPES[q.dtype],
                  stream)
    _build.check(code, "flash_bwd", symbol)


def flash_bwd_inputs(q, k, v, o, lse, do, qseg=None, kseg=None):
    """The backward kernels' inputs, checked and made once for both:
    ``(q, k, v, do, lse, delta)`` contiguous on the card (bf16 ones also
    16-byte aligned), ``do`` in q's dtype, lse and ``delta = sum_d do *
    o`` float32 [B, H, T]."""
    tensors = [t for t in (q, k, v, o, lse, do, qseg, kseg) if t is not None]
    _check_flash("flash_bwd", tensors, q, k, v, qseg, kseg)
    B, T, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, T):
        raise ValueError("flash_bwd: o/do must be [B, T, H, D] and lse [B, H, T]")
    # one cast: the product widens o inside its kernel (the same exact
    # products as casting both; a whole extra pass of o saved)
    delta = (do.float() * o).sum(dim=-1).permute(0, 2, 1).contiguous()
    return (_flash_operand(q), _flash_operand(k), _flash_operand(v),
            _flash_operand(do.to(q.dtype)), lse.float().contiguous(), delta)


def flash_bwd_dq(q, k, v, do, lse, delta, qseg, kseg, causal, scale):
    """One launch of ``flash_bwd.cu``'s dQ kernel (walking K/V) on the
    inputs :func:`flash_bwd_inputs` made; returns dQ."""
    if not q.is_cuda:
        raise ValueError("flash_bwd_dq: CUDA kernel needs CUDA tensors")
    dq = torch.empty_like(q)
    if q.numel():
        _bwd_launch("rl_flash_bwd_dq", q, k, v, do, lse, delta, qseg, kseg, [dq], causal,
                    scale)
        _build.count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, qseg, kseg, causal, scale):
    """One launch of ``flash_bwd.cu``'s dK/dV kernel (walking Q) on the
    inputs :func:`flash_bwd_inputs` made; returns (dK, dV), summed over
    each KV head's query-head group."""
    if not q.is_cuda:
        raise ValueError("flash_bwd_dkv: CUDA kernel needs CUDA tensors")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _bwd_launch("rl_flash_bwd_dkv", q, k, v, do, lse, delta, qseg, kseg, [dk, dv],
                    causal, scale)
        _build.count_launch(flash_bwd_dkv)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, qseg=None, kseg=None, causal=True, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`. CPU tensors: the plain
    version. CUDA tensors: the inputs made once, then the dQ kernel and
    the dK/dV kernel, or an exception; never the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale, qseg, kseg)
    prep = flash_bwd_inputs(q, k, v, o, lse, do, qseg, kseg)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    dq = flash_bwd_dq(*prep, qseg, kseg, causal, scale)
    dk, dv = flash_bwd_dkv(*prep, qseg, kseg, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; the backward rebuilds P from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, scale):
        o, lse = flash_fwd(q, k, v, qseg, kseg, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, qseg, kseg, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, kv_mask=None, segment_ids=None):
    """Attention over ``q`` [B, T, H, D] and ``k``/``v`` [B, T, Hk, D]
    (Hk divides H: GQA/MQA), differentiable in q, k and v.

    ``kv_mask`` [B, T] bool: False keys are invisible to every query
    (left- or right-padded batches). ``segment_ids`` [B, T] int: attention
    only within equal ids (packed sequences). Mutually exclusive. The
    softmax scale (default ``D ** -0.5``) multiplies the float32 product.
    On CUDA: the kernels, float32 or bfloat16, D in (32, 64, 128)."""
    B, T, H, D = q.shape
    if H % k.shape[2]:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({k.shape[2]})")
    scale = scale if scale is not None else D**-0.5
    qseg, kseg = _seg_from_args(kv_mask, segment_ids, B, T, q.device)
    return _FlashAttention.apply(q, k, v, qseg, kseg, bool(causal), float(scale))


flash_fwd.launches = 0  # kernel launches (CUDA path only)
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
