"""Speculative decoding for the serving path: the shared sampling rule,
the per-slot RNG streams and the draft sources (counterpart of
:mod:`rl_tpu.models.speculative`).

- :func:`sample_tokens` — THE logits -> (token, log-prob) rule, shared by
  prefill, decode and verify. With a ``torch.Generator`` it draws one
  noise tensor over the whole batch (the engine's legacy stream); with a
  per-row key tensor [R, 2] each row draws its own threefry noise.
- :func:`slot_keys` / :func:`spec_keys` — the per-slot, per-token-index
  streams: response token ``n`` of request ``rid`` keys
  ``fold_in(fold_in(key(seed), rid), n)``. The stream depends only on
  ``(seed, rid, n)``, never on batch composition, chunk size or the
  accept/reject history, which is what makes speculative output equal to
  vanilla slot-stream decode: verify and the sequential decode derive the
  same key for the same token.
- :class:`DraftSource` implementations: :class:`PrefixTreeDraft` reads
  continuations out of the prefix-KV radix tree (every served completion
  donated its blocks there); :class:`NGramDraft` is host prompt-lookup
  (propose what followed the last occurrence of the trailing n-gram).

The key streams are JAX's counter-based generator written as plain
PyTorch integer ops, so that a row's noise is the noise the reference
draws for the same key: threefry-2x32 with 20 rounds
(``jax._src.prng.threefry_2x32``), ``threefry_seed``, ``fold_in``
(``threefry_2x32(key, threefry_seed(data))``), the partitionable bits
(counters ``iota_2x32_shape``: high word 0, low word the flat index;
bits ``bits1 ^ bits2``), ``_uniform`` on ``[tiny, 1)`` and the "low"
gumbel ``-log(-log(u))``. uint32 words live in int64 tensors, masked to
32 bits after every add and shift. Everything runs on the device and
reads nothing on the host, so a CUDA graph can hold it: the key words,
``rid`` and ``ntok`` are device tensors.

Exactness (sample-then-compare self-speculation): verify feeds
``[t_prev, d_1..d_{K-1}]`` through the model causally and samples position
``j`` with the key token index ``ntok + j`` would use. Sample 0 is
conditioned on the true history, so it is the vanilla token; sample ``j``
is the vanilla token iff every earlier draft equalled the sample before
it (chain acceptance). A rejected draft's position already holds the
corrected sample, so each dispatch advances at least one token.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch

from ..kernels.sampling import fused_sample, gumbel_like

__all__ = [
    "DraftSource",
    "NGramDraft",
    "PrefixTreeDraft",
    "fold_in",
    "key_from_seed",
    "random_bits",
    "row_gumbel",
    "sample_tokens",
    "slot_keys",
    "spec_keys",
    "threefry2x32",
    "uniform_from_bits",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1, k2, x1, x2):
    """JAX's threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x1, x2)`` under the key ``(k1, k2)``: int64 tensors holding uint32
    words, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) & _M32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """The key words of ``jax.random.key(seed)``: [2] int64 ``(hi, lo)``
    (``threefry_seed``; a seed that fits in int32, as JAX takes it
    without x64, has high word 0)."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed >> 32) & _M32
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for keys [..., 2] and integer data [...]
    (broadcast; data taken as uint32, so -1 is 0xFFFFFFFF): the key hashes
    the counter pair ``threefry_seed(data) = (0, data)``."""
    data = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row of ``keys`` [R, 2]
    with partitionable threefry: [R, n] int64 words ``bits1 ^ bits2`` of
    the counters (0, i)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in float32 from 32-bit
    words: the top 23 bits as the mantissa of a float in [1, 2), less 1,
    scaled onto ``[tiny, 1)`` (``_uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), _TINY, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (1.0 - lo) + lo)


def row_gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[R, n] float32 gumbel noise, row ``r`` drawn with key ``keys[r]``:
    ``jax.vmap(lambda k: jax.random.gumbel(k, (n,), float32))(keys)``."""
    return -torch.log(-torch.log(uniform_from_bits(random_bits(keys, n))))


def slot_keys(base_key: torch.Tensor, rids: torch.Tensor, ntoks: torch.Tensor) -> torch.Tensor:
    """Per-row keys [R, 2] ``fold_in(fold_in(base, rid), ntok)`` — the
    schedule-invariant per-request streams (module docstring)."""
    return fold_in(fold_in(base_key, rids), ntoks)


def spec_keys(base_key: torch.Tensor, rids: torch.Tensor, ntoks: torch.Tensor,
              k: int) -> torch.Tensor:
    """[S, K, 2] key grid for the verify program: position ``j`` of slot
    ``s`` keys token index ``ntoks[s] + j`` of request ``rids[s]``,
    exactly the key sequential decode derives for that token."""
    j = torch.arange(k, dtype=torch.int64, device=ntoks.device)
    return fold_in(fold_in(base_key, rids)[:, None, :], ntoks.to(torch.int64)[:, None] + j)


def sample_tokens(logits, key, *, temperature, greedy, top_k=0):
    """(token, behavior log-prob of that token) per row of ``logits``
    [S, V], through the fused-sampling kernel on CUDA. ``key`` is a
    ``torch.Generator`` (one draw of noise over the whole batch, the
    engine's legacy stream), a per-row key tensor [S, 2] (each row its own
    threefry stream, the slot-stream mode), or None for greedy decoding,
    which draws no noise."""
    if greedy:
        noise = None
    elif isinstance(key, torch.Tensor):
        noise = row_gumbel(key, logits.shape[-1])
    else:
        noise = gumbel_like(logits, key)
    return fused_sample(
        logits, noise, temperature=temperature, greedy=greedy, top_k=top_k
    )


@runtime_checkable
class DraftSource(Protocol):
    """Host-side draft proposer: given a slot's full context (prompt +
    emitted tokens), guess up to ``k`` continuation tokens. Drafts are
    pure data — a wrong draft is rejected by the exactness gate, so a
    source never needs locks against the device state, only against its
    own index."""

    def propose(self, context: Sequence[int], k: int) -> list:
        """Up to ``k`` proposed continuation tokens ([] = no guess)."""
        ...

    def stats(self) -> dict:
        """Hit/miss telemetry for the draft-source gauges."""
        ...


class PrefixTreeDraft:
    """Drafts from the prefix-KV radix tree (:mod:`rl_tpu_torch.kvmem`):
    the best full-context match's stored continuation, read through
    :meth:`PrefixKVAllocator.draft` (which holds the allocator lock). On
    replayed or shared-prefix traffic the tree already holds every
    previously served completion, so the draft costs one host tree walk
    and is usually exact."""

    def __init__(self, allocator):
        self._alloc = allocator

    def propose(self, context: Sequence[int], k: int) -> list:
        return self._alloc.draft(context, k)

    def stats(self) -> dict:
        a = self._alloc
        with a._lock:
            hits, misses, toks = a.draft_hits, a.draft_misses, a.draft_tokens
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / total if total else 0.0,
            "proposed_tokens": toks,
        }


class NGramDraft:
    """Prompt-lookup drafting (the host fallback when no prefix tree is
    available): find the most recent earlier occurrence of the context's
    trailing ``n``-gram and propose the tokens that followed it. Cheap,
    model-free, and effective on repetitive text."""

    def __init__(self, n: int = 3, max_context: int = 4096):
        if n < 1:
            raise ValueError("NGramDraft needs n >= 1")
        self.n = int(n)
        self.max_context = int(max_context)
        self.hits = 0
        self.misses = 0
        self.proposed_tokens = 0

    def propose(self, context: Sequence[int], k: int) -> list:
        c = list(context[-self.max_context:])
        n = self.n
        if k <= 0 or len(c) <= n:
            self.misses += 1
            return []
        tail = c[-n:]
        # most recent match strictly BEFORE the trailing n-gram itself
        for i in range(len(c) - n - 1, -1, -1):
            if c[i:i + n] == tail:
                out = c[i + n:i + n + k]
                if out:
                    self.hits += 1
                    self.proposed_tokens += len(out)
                    return out
                break
        self.misses += 1
        return []

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "proposed_tokens": self.proposed_tokens,
        }
