"""Decoder-only transformer LM over a paged KV cache (counterpart of
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

The reference keeps float32 parameters and casts them at use; this module
holds one copy of the linear and embedding weights in ``cfg.dtype`` (the
serving copy) and its LayerNorm scales and biases in float32.

Ported paths: the no-cache causal forward and the paged-cache forward of
the continuous-batching engine (``init_paged_cache``, the paged write, the
T=1 read through the ``paged_flash_decode`` kernel and the T>1 gather
read). The dense-cache ``generate`` path, flash/ring attention, MoE and
int8 KV raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.attention import paged_flash_decode

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
    dtype: torch.dtype = torch.bfloat16  # activation and weight dtype
    attention_impl: str = "local"  # only "local" is ported
    flash_decode: bool = False  # dense-cache decode kernel: not ported
    flash_interpret: bool = False  # Pallas interpret mode: no counterpart
    kv_int8: bool = False  # not ported
    mesh: Any = None
    context_axis: str = "context"
    moe_experts: int = 0  # not ported
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    remat: bool = False  # training-only: not ported
    remat_policy: str = "none"

    def __post_init__(self):
        unported = {
            "moe_experts > 0": self.moe_experts > 0,
            "kv_int8": self.kv_int8,
            f"attention_impl={self.attention_impl!r}": self.attention_impl != "local",
            "flash_decode (dense-cache decode)": self.flash_decode,
            "remat": self.remat,
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"TransformerConfig: {what} is not ported yet")

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
    softmax over the assembled range.

    Unlike the reference, which returns new pool arrays, the pools are
    updated IN PLACE (``index_put_``); the returned cache holds the same
    pool tensors and the advanced lengths.
    """
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
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
    pool_k[flat_blk, :, flat_off] = k.reshape(S * T, *k.shape[2:]).to(pool_k.dtype)
    pool_v[flat_blk, :, flat_off] = v.reshape(S * T, *v.shape[2:]).to(pool_v.dtype)

    if T == 1:
        # decode-after-write: positions 0..len inclusive
        attend = (lens + 1).to(torch.int32)
        o = paged_flash_decode(q, pool_k, pool_v, table, attend).to(cfg.dtype)
        return o, _advance_paged_cache(cache, pool_k, pool_v, lens, active_t)

    # one gather materializes every table block, then a single masked
    # softmax over the whole [L = max_blocks*block] range. Rows with no
    # valid key softmax over a uniform -1e9 row and give finite garbage
    # that is never read.
    Hk = pool_k.shape[1]
    rep = cfg.n_heads // cfg.kv_heads
    scale = cfg.head_dim**-0.5
    L = max_blocks * block
    safe_table = table.long().clamp(0, n_blocks - 1)  # -1 (unassigned) -> scratch
    k_all = pool_k[safe_table].permute(0, 2, 1, 3, 4).reshape(S, Hk, L, -1).float()
    v_all = pool_v[safe_table].permute(0, 2, 1, 3, 4).reshape(S, Hk, L, -1).float()
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
    return o, _advance_paged_cache(cache, pool_k, pool_v, lens, active_t)


def _advance_paged_cache(cache, pool_k, pool_v, lens, active_t):
    """The one statement of the cache-advance rule (shared by the kernel
    and gather read branches)."""
    new_cache = dict(cache)
    new_cache.update(
        pool_k=pool_k,
        pool_v=pool_v,
        len=lens + active_t.sum(dim=1, dtype=lens.dtype),
    )
    return new_cache


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


class _Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        d, hd = cfg.d_model, cfg.head_dim
        if cfg.kv_heads == cfg.n_heads:
            self.qkv = nn.Linear(d, 3 * d, **kw)
        else:  # GQA/MQA: fewer KV heads — smaller cache, less decode traffic
            self.wq = nn.Linear(d, d, **kw)
            self.wkv = nn.Linear(d, 2 * cfg.kv_heads * hd, **kw)
        self.proj = nn.Linear(d, d, **kw)

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
        if cache is not None:
            if mask is not None:
                raise ValueError(
                    "the paged cache path ignores attention_mask — padding "
                    "is expressed through cache['active'] and per-slot "
                    "lens; pass attention_mask=None"
                )
            o, new_cache = _paged_attention(cfg, q, k, v, cache, cache.get("active"))
        else:
            causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
            causal = causal[None, None]
            if mask is not None:
                causal = causal & mask.bool()[:, None, None, :]
            if Hk != cfg.n_heads:
                k = k.repeat_interleave(cfg.n_heads // Hk, dim=2)
                v = v.repeat_interleave(cfg.n_heads // Hk, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.head_dim**-0.5
            s = torch.where(causal, s, -1e9)
            p = torch.softmax(s.float(), dim=-1).to(cfg.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v)

        o = o.reshape(B, T, cfg.d_model)
        return self.proj(o), new_cache


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.ln1 = _LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = _Attention(cfg, device)
        self.ln2 = _LayerNorm(cfg.d_model, cfg.dtype, device)
        self.up = nn.Linear(cfg.d_model, cfg.d_ff, device=device, dtype=cfg.dtype)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model, device=device, dtype=cfg.dtype)

    def forward(self, x, mask, cache=None):
        h, new_cache = self.attn(self.ln1(x), mask, cache)
        x = x + h
        y = self.down(F.gelu(self.up(self.ln2(x)), approximate="tanh"))
        return x + y, new_cache


class TransformerLM(nn.Module):
    """GPT-style LM: tokens [B, T] -> logits [B, T, V] (in ``cfg.dtype``).

    ``device`` defaults to the CUDA card (no card: raises; pass
    ``device="cpu"`` for the CPU). Weights are drawn from ``seed`` with an
    explicit generator on that device (normal, std 0.02; LayerNorm scale
    1, biases 0); load trained weights with ``load_state_dict`` (see
    :func:`rl_tpu_torch.models.weights.params_from_flax`).
    """

    def __init__(self, cfg: TransformerConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev, dtype=cfg.dtype)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model, device=dev, dtype=cfg.dtype)
        self.h = nn.ModuleList(_Block(cfg, dev) for _ in range(cfg.n_layers))
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

    def forward(self, tokens, attention_mask=None, cache=None):
        """No cache: the causal forward, ``attention_mask`` [B, T] marks
        real tokens. With a paged ``cache`` (a list of per-layer dicts from
        :meth:`init_paged_cache` plus ``block_table``/``len``/``active``):
        returns ``(logits, new_caches)``; the pools are written in place."""
        cfg = self.cfg
        T = tokens.shape[1]
        if cache is not None:
            lens = cache[0]["len"]
            positions = lens.long()[:, None] + torch.arange(T, device=tokens.device)
            # garbage rows (a finished slot's frozen length) must not index
            # past the table; real rows never reach max_seq_len
            positions = positions.clamp_max(cfg.max_seq_len - 1)
        else:
            positions = torch.arange(T, device=tokens.device)[None, :]
        x = self.wte(tokens) + self.wpe(positions)

        new_caches = [] if cache is not None else None
        for i, block in enumerate(self.h):
            layer_cache = cache[i] if cache is not None else None
            x, nc = block(x, attention_mask, layer_cache)
            if cache is not None:
                new_caches.append(nc)
        x = self.ln_f(x)
        logits = F.linear(x, self.wte.weight)  # tied embeddings, cfg.dtype
        if cache is not None:
            return logits, new_caches
        return logits

    def init_paged_cache(
        self, n_slots: int, n_blocks: int, block_size: int, max_blocks: int
    ) -> list[dict]:
        """Paged KV cache (vLLM layout) on the model's device: a pool of
        ``n_blocks`` KV blocks of ``block_size`` tokens shared by
        ``n_slots`` sequences, each owning up to ``max_blocks`` table
        entries. Block 0 is reserved as the scratch write target for
        inactive slots; -1 marks unassigned table entries."""
        cfg = self.cfg
        dev = self.device

        def layer():
            shape = (n_blocks, cfg.kv_heads, block_size, cfg.head_dim)
            return {
                # HEAD-MAJOR [N, Hk, block, D]: one (block, kv head) tile
                # is contiguous, as the decode kernel reads it
                "pool_k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "pool_v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "block_table": torch.full(
                    (n_slots, max_blocks), -1, dtype=torch.int32, device=dev
                ),
                "len": torch.zeros(n_slots, dtype=torch.int32, device=dev),
                "active": torch.zeros(n_slots, dtype=torch.bool, device=dev),
            }

        return [layer() for _ in range(cfg.n_layers)]
