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

__all__ = [
    "flash_attention",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_inputs",
    "flash_fwd",
    "paged_flash_decode",
    "paged_flash_decode_ref",
]

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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
    flash_fwd.launches += 1
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
    ``(q, k, v, do, lse, delta)`` contiguous on the card, ``do`` in q's
    dtype, lse and ``delta = sum_d do * o`` float32 [B, H, T]."""
    tensors = [t for t in (q, k, v, o, lse, do, qseg, kseg) if t is not None]
    _check_flash("flash_bwd", tensors, q, k, v, qseg, kseg)
    B, T, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, T):
        raise ValueError("flash_bwd: o/do must be [B, T, H, D] and lse [B, H, T]")
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.to(q.dtype).contiguous(),
            lse.float().contiguous(), delta)


def flash_bwd_dq(q, k, v, do, lse, delta, qseg, kseg, causal, scale):
    """One launch of ``flash_bwd.cu``'s dQ kernel (walking K/V) on the
    inputs :func:`flash_bwd_inputs` made; returns dQ."""
    if not q.is_cuda:
        raise ValueError("flash_bwd_dq: CUDA kernel needs CUDA tensors")
    dq = torch.empty_like(q)
    if q.numel():
        _bwd_launch("rl_flash_bwd_dq", q, k, v, do, lse, delta, qseg, kseg, [dq], causal,
                    scale)
        flash_bwd_dq.launches += 1
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
        flash_bwd_dkv.launches += 1
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
