"""Decoder-only transformer LM (counterpart of
:mod:`rl_tpu.models.transformer`).

The module mirrors the reference's flax model numerically, including
where flax's defaults differ from PyTorch's:

- LayerNorm epsilon is 1e-6, and mean and variance are taken in float32
  (flax's ``force_float32_reductions``; variance as ``E[x^2] - E[x]^2``,
  flax's fast variance), whatever the activation dtype;
- the MLP uses the tanh approximation of GELU (flax's ``nn.gelu``);
- ``Dense(dtype=bf16)`` computes in bf16, and so does the tied-embedding
  head: flax's ``Embed.attend`` promotes both operands to the module
  dtype, so with ``dtype=bfloat16`` the logits come out in bfloat16.

Two parameter layouts (``param_dtype``): ``None`` holds one copy of the
linear and embedding weights in ``cfg.dtype`` (the serving copy);
``torch.float32`` holds float32 parameters and casts each one to
``cfg.dtype`` where it is used, as flax does with ``param_dtype=float32``
(the training master copy: an Adam step of 1e-5 would round away in
bf16). LayerNorm scales and biases are float32 in both.

Ported paths: the no-cache forward with ``attention_impl`` "local" (dense)
or "flash" (the flash-attention kernels; the padding mask becomes
``kv_mask``), per-block ``remat`` through ``torch.utils.checkpoint``, the
dense-cache path of ``generate`` (``init_cache``, T >= 1 writes, the dense
grouped-query read, and with ``flash_decode`` the T=1 read through the
``flash_decode`` kernel), and the paged-cache forward of the
continuous-batching engine (``init_paged_cache``, the paged write, the T=1
read through the ``paged_flash_decode`` kernel and the T>1 gather read;
with ``kv_int8`` int8 pools written by ``quantize_block_write`` and read
through ``paged_flash_decode_int8``). Ring attention and MoE raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from .. import resolve_device
from ..kernels.kvcache import dequantize, init_scales, quantize_block_write
from ..kernels.paged_attention import paged_flash_decode_int8
from ..ops.attention import flash_attention, flash_decode, paged_flash_decode

__all__ = ["TransformerConfig", "TransformerLM"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int | None = None  # < n_heads => GQA/MQA (shared KV heads)
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16  # activation (and serving weight) dtype
    attention_impl: str = "local"  # "local" | "flash" ("ring": not ported)
    flash_decode: bool = False  # T=1 dense-cache reads through the flash_decode kernel
    flash_interpret: bool = False  # Pallas interpret mode: no counterpart
    kv_int8: bool = False  # int8 paged pools with per-(block, kv-head) scales
    mesh: Any = None
    context_axis: str = "context"
    moe_experts: int = 0  # not ported
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # rematerialize each block in the backward (training forward only):
    # "none" recomputes everything, "dots" keeps the matmul outputs,
    # "dots_no_batch" only those of products without batch dimensions
    remat: bool = False
    remat_policy: str = "none"

    def __post_init__(self):
        unported = {
            "moe_experts > 0": self.moe_experts > 0,
            f"attention_impl={self.attention_impl!r}": self.attention_impl
            not in ("local", "flash"),
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"TransformerConfig: {what} is not ported to "
                                          "rl_tpu_torch yet (ROADMAP A7)")
        if self.remat_policy not in ("none", "dots", "dots_no_batch"):
            raise ValueError(
                f"remat_policy must be one of none|dots|dots_no_batch, got {self.remat_policy!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def _paged_attention(cfg, q, k, v, cache, active):
    """Attention over a paged KV cache + block-table writes.

    Layout: ``pool_k``/``pool_v`` [n_blocks, Hk, block, D] (head-major)
    shared across slots; ``block_table`` [S, max_blocks] int32 (block 0 =
    reserved scratch, -1 = unassigned); ``len`` [S] int32 per-slot
    lengths. New tokens (q/k/v [S, T, ...]) land at slot-local positions
    ``len[s] + t``. T=1 reads through the ``paged_flash_decode`` kernel;
    T>1 (prefill) gathers the slot's table blocks and runs one masked
    softmax over the assembled range. With int8 pools (the cache carries
    ``scale_k``/``scale_v`` [n_blocks, Hk]) the write goes through
    ``quantize_block_write``, the T=1 read through
    ``paged_flash_decode_int8`` and the T>1 gather through ``dequantize``.

    Unlike the reference, which returns new pool arrays, the pools (and
    scales) are updated IN PLACE; the returned cache holds the same
    tensors and the advanced lengths.
    """
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
    int8 = "scale_k" in cache
    table, lens = cache["block_table"], cache["len"]
    S, T = q.shape[0], q.shape[1]
    n_blocks, block = pool_k.shape[0], pool_k.shape[2]
    max_blocks = table.shape[1]
    dev = q.device
    # `active` is [S] (whole slots) or [S, T] (token-level: bucketed
    # prefill pads prompts; padded tokens must not land in the cache or
    # advance the length)
    if active is None:
        active_t = torch.ones((S, T), dtype=torch.bool, device=dev)
    elif active.dim() == 1:
        active_t = active[:, None].expand(S, T)
    else:
        active_t = active

    # -- write the new K/V into the pool --------------------------------------
    pos = lens.long()[:, None] + torch.arange(T, device=dev)[None, :]  # [S, T]
    blk_slot = pos // block
    off = pos % block
    blk_global = torch.gather(table.long(), 1, blk_slot.clamp(0, max_blocks - 1))
    # inactive tokens AND positions beyond the table range write into
    # scratch block 0 (reserved, never read)
    blk_global = torch.where(active_t & (blk_slot < max_blocks), blk_global, 0)
    # an unassigned (-1) entry under an active token is a caller bug; send
    # it to scratch too rather than wrapping to the last pool block
    blk_global = blk_global.clamp_min(0)
    flat_blk = blk_global.reshape(-1)
    flat_off = off.reshape(-1)
    # separated advanced indices put the indexed dim first: value [M, Hk, D]
    k_rows, v_rows = k.reshape(S * T, *k.shape[2:]), v.reshape(S * T, *v.shape[2:])
    if int8:
        quantize_block_write(pool_k, cache["scale_k"], flat_blk, flat_off, k_rows)
        quantize_block_write(pool_v, cache["scale_v"], flat_blk, flat_off, v_rows)
    else:
        pool_k[flat_blk, :, flat_off] = k_rows.to(pool_k.dtype)
        pool_v[flat_blk, :, flat_off] = v_rows.to(pool_v.dtype)

    if T == 1:
        # decode-after-write: positions 0..len inclusive
        attend = (lens + 1).to(torch.int32)
        if int8:
            o = paged_flash_decode_int8(q, pool_k, pool_v, cache["scale_k"], cache["scale_v"],
                                        table, attend)
        else:
            o = paged_flash_decode(q, pool_k, pool_v, table, attend)
        return o.to(cfg.dtype), _advance_paged_cache(cache, lens, active_t)

    # one gather materializes every table block, then a single masked
    # softmax over the whole [L = max_blocks*block] range. Rows with no
    # valid key softmax over a uniform -1e9 row and give finite garbage
    # that is never read.
    Hk = pool_k.shape[1]
    rep = cfg.n_heads // cfg.kv_heads
    scale = cfg.head_dim**-0.5
    L = max_blocks * block
    safe_table = table.long().clamp(0, n_blocks - 1)  # -1 (unassigned) -> scratch
    k_all, v_all = pool_k[safe_table], pool_v[safe_table]  # [S, max_blocks, Hk, block, D]
    if int8:
        k_all = dequantize(k_all, cache["scale_k"][safe_table])
        v_all = dequantize(v_all, cache["scale_v"][safe_table])
    k_all = k_all.permute(0, 2, 1, 3, 4).reshape(S, Hk, L, -1).float()
    v_all = v_all.permute(0, 2, 1, 3, 4).reshape(S, Hk, L, -1).float()
    # grouped heads: [S, T, H, D] -> [S, Hk, rep, T, D] (no KV repeat)
    qf = q.transpose(1, 2).float().reshape(S, Hk, rep, T, cfg.head_dim)
    s_all = torch.einsum("shrtd,shld->shrtl", qf, k_all) * scale
    kv_pos = torch.arange(L, device=dev)
    # causal: q token t (at position len+t) sees kv_pos <= len + t;
    # unassigned/scratch table entries are never valid keys
    valid = kv_pos[None, None, :] <= pos[:, :, None]  # [S, T, L]
    valid = valid & (table > 0).repeat_interleave(block, dim=1)[:, None, :]
    s_all = torch.where(valid[:, None, None], s_all, -1e9)
    p = torch.softmax(s_all, dim=-1)
    o = torch.einsum("shrtl,shld->shrtd", p, v_all)
    o = o.reshape(S, cfg.n_heads, T, cfg.head_dim).transpose(1, 2).to(cfg.dtype)
    return o, _advance_paged_cache(cache, lens, active_t)


def _advance_paged_cache(cache, lens, active_t):
    """The one statement of the cache-advance rule (shared by the kernel
    and gather read branches): the same pool and scale tensors, written in
    place, and the advanced lengths."""
    return dict(cache, len=lens + active_t.sum(dim=1, dtype=lens.dtype))


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: float32 statistics (fast
    variance), epsilon 1e-6, float32 scale/bias, output in ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, device=None, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class _Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``: its weight and bias are
    held in the parameter dtype and cast at use (flax ``Dense`` with
    ``dtype`` and ``param_dtype``; the cast is a no-op in the serving
    layout)."""

    def __init__(self, d_in, d_out, dtype, param_dtype, device=None, bias=True):
        super().__init__(d_in, d_out, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x, self.weight.to(self.compute_dtype), bias)


def _dense_gqa(cfg, q, k, v, attn_mask):
    """Dense attention with KV-head grouping ([B, H, T, S] scores) in
    ``cfg.dtype``, softmax in float32 (the reference's ``dense_gqa``)."""
    rep = cfg.n_heads // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.head_dim**-0.5
    s = torch.where(attn_mask, s, -1e9)
    p = torch.softmax(s.float(), dim=-1).to(cfg.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _dense_cache_attention(cfg, q, k, v, cache, mask):
    """Write the T new tokens' K/V at ``cache["len"]`` (in place) and
    attend over the filled prefix: query t (at position len + t) sees keys
    at positions <= len + t that ``mask`` [B, S] (if given) marks real.

    The reference's dispatch rule: with ``cfg.flash_decode``, a T=1 step
    over a cache whose size S is a multiple of min(512, S) reads through
    the ``flash_decode`` kernel; every other step takes the dense read."""
    ck, cv, n = cache["k"], cache["v"], cache["len"]
    T, S = q.shape[1], ck.shape[1]
    ck[:, n : n + T] = k.to(ck.dtype)
    cv[:, n : n + T] = v.to(cv.dtype)
    new_cache = {"k": ck, "v": cv, "len": n + T}
    if cfg.flash_decode and T == 1 and S % min(512, S) == 0:
        o = flash_decode(q, ck, cv, n + T, kv_mask=mask)
        return o.to(cfg.dtype), new_cache
    kv_pos = torch.arange(S, device=q.device)
    q_pos = n + torch.arange(T, device=q.device)
    attn = ((q_pos[:, None] >= kv_pos[None, :]) & (kv_pos[None, :] < n + T))[None, None]
    if mask is not None:  # padding mask over the cached keys [B, S]
        attn = attn & mask.bool()[:, None, None, :]
    return _dense_gqa(cfg, q, ck, cv, attn), new_cache


class _Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=param_dtype, device=device, bias=False)
        d, hd = cfg.d_model, cfg.head_dim
        if cfg.kv_heads == cfg.n_heads:
            self.qkv = _Dense(d, 3 * d, **kw)
        else:  # GQA/MQA: fewer KV heads — smaller cache, less decode traffic
            self.wq = _Dense(d, d, **kw)
            self.wkv = _Dense(d, 2 * cfg.kv_heads * hd, **kw)
        self.proj = _Dense(d, d, **kw)

    def forward(self, x, mask, cache=None):
        cfg = self.cfg
        B, T, _ = x.shape
        Hk = cfg.kv_heads
        if Hk == cfg.n_heads:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q = self.wq(x)
            k, v = self.wkv(x).chunk(2, dim=-1)
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, Hk, cfg.head_dim)
        v = v.reshape(B, T, Hk, cfg.head_dim)

        new_cache = None
        if cache is not None and "pool_k" in cache:
            if mask is not None:
                raise ValueError(
                    "the paged cache path ignores attention_mask — padding "
                    "is expressed through cache['active'] and per-slot "
                    "lens; pass attention_mask=None"
                )
            o, new_cache = _paged_attention(cfg, q, k, v, cache, cache.get("active"))
        elif cache is not None:
            o, new_cache = _dense_cache_attention(cfg, q, k, v, cache, mask)
        elif cfg.attention_impl == "flash":
            # ragged batches ride the kernels: the padding mask -> kv_mask
            o = flash_attention(
                q, k, v, causal=True, kv_mask=None if mask is None else mask.bool()
            ).to(cfg.dtype)
        else:
            causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None]
            if mask is not None:
                causal = causal & mask.bool()[:, None, None, :]
            o = _dense_gqa(cfg, q, k, v, causal)

        o = o.reshape(B, T, cfg.d_model)
        return self.proj(o), new_cache


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype, device=None):
        super().__init__()
        self.ln1 = _LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = _Attention(cfg, param_dtype, device)
        self.ln2 = _LayerNorm(cfg.d_model, cfg.dtype, device)
        self.up = _Dense(cfg.d_model, cfg.d_ff, cfg.dtype, param_dtype, device)
        self.down = _Dense(cfg.d_ff, cfg.d_model, cfg.dtype, param_dtype, device)

    def forward(self, x, mask, cache=None):
        h, new_cache = self.attn(self.ln1(x), mask, cache)
        x = x + h
        y = self.down(F.gelu(self.up(self.ln2(x)), approximate="tanh"))
        return x + y, new_cache


# the matrix products a "dots" remat keeps (jax's checkpoint_dots)
_DOT_OPS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
)


# the products with no batch dimension (jax's checkpoint_dots_with_no_batch_dims):
# the dense layers' 2-d products; the attention's batched products are recomputed
_NO_BATCH_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    policy = checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOT_OPS else policy.PREFER_RECOMPUTE


def _keep_no_batch_dots(ctx, op, *args, **kwargs):
    policy = checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _NO_BATCH_DOT_OPS else policy.PREFER_RECOMPUTE


_POLICIES = {"dots": _keep_dots, "dots_no_batch": _keep_no_batch_dots}


def _block_out(block, x, mask):
    return block(x, mask)[0]


def _remat_block(block, x, mask, policy: str):
    """One block under ``torch.utils.checkpoint`` (non-reentrant): "none"
    keeps only the block input and recomputes the rest in the backward;
    "dots" also keeps the matmul outputs; "dots_no_batch" keeps those of
    the 2-d products (``mm``, ``addmm``: the dense layers) and recomputes
    the batched ones (``bmm``: the attention's scores and values)."""
    kw = {}
    if policy in _POLICIES:
        kw["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _POLICIES[policy]
        )
    return checkpoint.checkpoint(_block_out, block, x, mask, use_reentrant=False, **kw)


class TransformerLM(nn.Module):
    """GPT-style LM: tokens [B, T] -> logits [B, T, V] (in ``cfg.dtype``).

    ``device`` defaults to the CUDA card (no card: raises; pass
    ``device="cpu"`` for the CPU). ``param_dtype=None`` keeps the linear
    and embedding weights in ``cfg.dtype`` (serving); ``torch.float32``
    keeps float32 master weights cast at use (training). Weights are drawn
    from ``seed`` with an explicit generator on that device (normal, std
    0.02; LayerNorm scale 1, biases 0), so the two layouts built from one
    seed hold the same values up to the cast; load trained weights with
    ``load_state_dict`` (see
    :func:`rl_tpu_torch.models.weights.params_from_flax`).
    """

    def __init__(self, cfg: TransformerConfig, *, device=None, seed: int = 0,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        pdt = cfg.dtype if param_dtype is None else param_dtype
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev, dtype=pdt)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model, device=dev, dtype=pdt)
        self.h = nn.ModuleList(_Block(cfg, pdt, dev) for _ in range(cfg.n_layers))
        self.ln_f = _LayerNorm(cfg.d_model, cfg.dtype, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.dim() == 1:  # LayerNorm scale
                    p.fill_(1.0)
                else:
                    w = torch.randn(p.shape, generator=gen, device=dev) * 0.02
                    p.copy_(w)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, tokens, attention_mask=None, cache=None, positions=None):
        """No cache: the forward over ``tokens`` [B, T]; ``attention_mask``
        [B, T] marks real tokens and ``positions`` [B, T] indexes the
        position embedding (default ``arange(T)``; left-padded batches pass
        ``cumsum(mask) - 1``). With a dense ``cache`` (from
        :meth:`init_cache`): ``attention_mask`` is [B, S] over the cache,
        the new K/V are written in place at the cache's length, and it
        returns ``(logits, new_caches)``. With a paged ``cache`` (a list of
        per-layer dicts from :meth:`init_paged_cache` plus
        ``block_table``/``len``/``active``): returns ``(logits,
        new_caches)``; the pools are written in place."""
        cfg = self.cfg
        T = tokens.shape[1]
        dev = tokens.device
        paged = cache is not None and "pool_k" in cache[0]
        if positions is None:
            if paged:
                lens = cache[0]["len"]
                positions = lens.long()[:, None] + torch.arange(T, device=dev)
                # garbage rows (a finished slot's frozen length) must not
                # index past the table; real rows never reach max_seq_len
                positions = positions.clamp_max(cfg.max_seq_len - 1)
            elif cache is not None:
                positions = (cache[0]["len"] + torch.arange(T, device=dev))[None, :]
            else:
                positions = torch.arange(T, device=dev)[None, :]
        # gather, then cast: equal to flax's cast-then-gather, cheaper
        x = (F.embedding(tokens, self.wte.weight).to(cfg.dtype)
             + F.embedding(positions, self.wpe.weight).to(cfg.dtype))

        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        new_caches = [] if cache is not None else None
        for i, block in enumerate(self.h):
            if remat:
                x = _remat_block(block, x, attention_mask, cfg.remat_policy)
                continue
            x, nc = block(x, attention_mask, cache[i] if cache is not None else None)
            if cache is not None:
                new_caches.append(nc)
        x = self.ln_f(x)
        logits = F.linear(x, self.wte.weight.to(cfg.dtype))  # tied embeddings, cfg.dtype
        if cache is not None:
            return logits, new_caches
        return logits

    def init_cache(self, batch_size: int, max_len: int) -> list[dict]:
        """Dense KV cache for :func:`rl_tpu_torch.models.generate`: per
        layer ``k``/``v`` [B, max_len, Hk, D] in ``cfg.dtype`` on the
        model's device and ``len`` (a Python int, the filled prefix)."""
        cfg = self.cfg
        shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
        return [
            {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             "len": 0}
            for _ in range(cfg.n_layers)
        ]

    def init_paged_cache(
        self, n_slots: int, n_blocks: int, block_size: int, max_blocks: int
    ) -> list[dict]:
        """Paged KV cache (vLLM layout) on the model's device: a pool of
        ``n_blocks`` KV blocks of ``block_size`` tokens shared by
        ``n_slots`` sequences, each owning up to ``max_blocks`` table
        entries. Block 0 is reserved as the scratch write target for
        inactive slots; -1 marks unassigned table entries. With
        ``cfg.kv_int8`` the pools are int8 and each layer also carries
        ``scale_k``/``scale_v`` [n_blocks, Hk] float32 (block-major like
        the pools, so the engine's copy-on-write fork carries them)."""
        cfg = self.cfg
        dev = self.device
        pool_dtype = torch.int8 if cfg.kv_int8 else cfg.dtype

        def layer():
            shape = (n_blocks, cfg.kv_heads, block_size, cfg.head_dim)
            c = {
                # HEAD-MAJOR [N, Hk, block, D]: one (block, kv head) tile
                # is contiguous, as the decode kernels read it
                "pool_k": torch.zeros(shape, dtype=pool_dtype, device=dev),
                "pool_v": torch.zeros(shape, dtype=pool_dtype, device=dev),
                "block_table": torch.full(
                    (n_slots, max_blocks), -1, dtype=torch.int32, device=dev
                ),
                "len": torch.zeros(n_slots, dtype=torch.int32, device=dev),
                "active": torch.zeros(n_slots, dtype=torch.bool, device=dev),
            }
            if cfg.kv_int8:
                c["scale_k"] = init_scales(n_blocks, cfg.kv_heads, dev)
                c["scale_v"] = init_scales(n_blocks, cfg.kv_heads, dev)
            return c

        return [layer() for _ in range(cfg.n_layers)]
