"""Continuous batching over the paged KV cache (counterpart of the core of
:class:`rl_tpu.models.serving.ContinuousBatchingEngine`).

The reference builds the engine the XLA way: fixed-shape jitted programs
whose dynamism lives in block tables, per-slot lengths and active masks.
The port keeps the same design and the same host bookkeeping, in PyTorch:

- **Slots and a shared block pool.** ``n_slots`` sequence slots own block
  tables into one paged pool (``TransformerLM.init_paged_cache``); a
  finished sequence returns its blocks and its slot is refilled from the
  queue while the other slots keep decoding.
- **Bucketed compact prefill.** Each admission round prefills only the
  admitted rows, padded to a prompt-ladder rung and a power-of-two row
  count (:class:`rl_tpu_torch.compile.ShapeBuckets`); it samples each
  row's first token through the fused-sampling kernel and is synchronous
  (the host needs that token to settle eos and budget at once).
- **On-device stop accounting.** A decode chunk is a Python loop of K
  steps in which ``active``/``budget``/``last``/``lens`` stay on the
  device: each step samples a token, decrements the active slots'
  budgets and deactivates slots that emit eos or run out. Nothing in the
  loop reads a value back to the host, so the host never waits on the
  device to decide continuation.
- **Double-buffered dispatch.** The chunk's tokens and log-probs go into
  preallocated ``[S, K]`` device tensors, which are copied
  (``non_blocking``) into pinned host buffers; a CUDA event marks their
  arrival. ``step()`` launches chunk K+1 before it accepts chunk K, and
  the host re-derives the device's stop rule from the same inputs, so the
  two ledgers never need a reconciliation sync.
- **Pools as per-layer tuples.** A layer's block-major buffers are
  ``(pool_k, pool_v)``, or ``(pool_k, pool_v, scale_k, scale_v)`` for a
  ``kv_int8`` model (the reference's ``_POOL_FIELDS``); every write,
  read and copy goes through the tuple, so the int8 scales ride along.
- **Prefix cache** (``prefix_cache=True``, :mod:`rl_tpu_torch.kvmem`).
  Admission matches each prompt against a radix tree of resident blocks,
  references the shared prefix's blocks, forks at most one block
  copy-on-write (a device copy of every block-major buffer, scales
  included) and prefills only the uncached suffix, padded to the suffix
  ladder. Blocks published at admission are written by that round's
  prefill; the copies, the prefill and every decode chunk are queued on
  the engine's one CUDA stream, so a later reader always runs after the
  write without a host sync.

With a program ``registry`` the engine's device work runs as registered
programs under the reference's names: the decode chunk
(``serving.decode.k{K}``), the bucketed prefill
(``serving.prefill.a{A}.b{B}``, or ``serving.pprefill.a{A}.s{B}`` over
the suffix ladder with a prefix cache; the table gather, the forward and
the first token's sample), the copy-on-write fork
(``serving.cowcopy.n{n}``, its pair count padded up the power-of-two
ladder by repeating the last pair) and the merge of admitted slots into
the decode state (``serving.admit_update``). On the card each is
captured once per shape as a CUDA graph and replayed; one engine's
graphs share one memory pool (:class:`~rl_tpu_torch.compile.GraphPool`).
The host keeps the allocator's plan, the table writes, the round's end,
the first tokens' readback and the eos and budget bookkeeping.
``warmup`` captures the whole ladder before the first request
(:meth:`ContinuousBatchingEngine.aot_warmup`).

**Per-slot RNG streams** (``slot_rng=True``). Response token ``n`` of
request ``rid`` samples with the key ``fold_in(fold_in(key(seed), rid),
n)`` (:mod:`rl_tpu_torch.models.speculative`), derived on the device from
the per-slot ``rid`` and ``ntok`` state, so the sampled sequence depends
only on ``(seed, rid)``: not on batch composition, chunk size or a
speculative accept history. Its programs are the slot-stream family
(``serving.sprefill.a{A}.b{B}``, ``serving.spprefill.a{A}.s{B}``,
``serving.sdecode.k{K}``, ``serving.sadmit_update``); the engine's
``torch.Generator`` is then never drawn from.

**Speculative decoding** (``speculative=True``, which implies
``slot_rng``). Each round drafts up to ``spec_lookahead`` tokens per slot
on the host (:class:`~rl_tpu_torch.models.speculative.PrefixTreeDraft`
over the prefix cache's radix tree, or
:class:`~rl_tpu_torch.models.speculative.NGramDraft`), pads them to one
``[S, K-1]`` batch at the decode ladder's rung ``K`` and scores all ``K``
positions in one forward (``serving.verify.k{K}``, which reads the cache
through the gather route of ``T > 1``). Position ``j`` samples with the
key of token index ``ntok + j``, so an accepted token is the token
vanilla slot-stream decode samples; the device advances each slot's
length by the tokens it emits, and K/V written at rejected positions is
overwritten later and never attended. A round with no draft, or a pool
too tight for width ``K``, runs a plain slot-stream decode instead
(counted in :meth:`~ContinuousBatchingEngine.stats`).

Left for later slices: KV handoff, tracing and metrics, parameter
sharding, and the load balancer, service and fleet layers.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .._stubs import refuse_options
from ..compile import GraphPool, ShapeBuckets, get_program_registry, pow2ceil
from ..kvmem import DEFER_ROUND, PrefixKVAllocator
from .speculative import (DraftSource, NGramDraft, PrefixTreeDraft, key_from_seed,
                          sample_tokens, slot_keys, spec_keys)

__all__ = ["ContinuousBatchingEngine", "FinishedRequest", "Request"]

# every per-layer block-major buffer, in order: int8 KV adds the per-block
# scales, which ride through writes, reads and copy-on-write forks like
# the pools (all are block-major on axis 0)
_POOL_FIELDS = ("pool_k", "pool_v", "scale_k", "scale_v")


def _admit_update(lens, active, budget, last, mask, new_lens, new_budget, new_last):
    """The masked merge of freshly prefilled slots into the device decode
    state (one program however many were admitted)."""
    return (torch.where(mask, new_lens, lens), active | mask,
            torch.where(mask, new_budget, budget), torch.where(mask, new_last, last))


def _sadmit_update(lens, active, budget, last, rid, ntok, mask, new_lens, new_budget, new_last,
                   new_rid):
    """The slot-stream merge: the same masked write, plus the per-slot RNG
    stream state: the occupying rid, and ntok = 1 because the prefill has
    just sampled response token 0."""
    return (*_admit_update(lens, active, budget, last, mask, new_lens, new_budget, new_last),
            torch.where(mask, new_rid, rid), torch.where(mask, torch.ones_like(ntok), ntok))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new_tokens: int


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray  # [N] generated ids (eos included if hit)
    log_probs: np.ndarray  # [N] behavior log-probs of the sampled tokens
    finished_reason: str  # "eos" | "length"


@dataclasses.dataclass
class _InFlight:
    """A dispatched decode chunk whose tokens have not been accepted yet."""

    toks: torch.Tensor  # host [S, K] int32 (pinned when the engine is on CUDA)
    lps: torch.Tensor  # host [S, K] float32
    done: Any  # torch.cuda.Event recorded after the copies (None on the CPU)
    rid0: np.ndarray  # slot -> rid at launch (accept only if unchanged)
    run_mask: np.ndarray  # slots this chunk was allowed to advance
    chunk: int
    dispatch_s: float  # host wall spent dispatching (tuner input)
    kind: str = "decode"  # "decode" | "verify"
    draft: np.ndarray | None = None  # verify: the [S, K-1] drafts it scored


class _ChunkTuner:
    """Pick ``decode_chunk`` from measured sync overhead vs chunk compute.

    Per drained chunk the engine reports the host-side cost of the round
    (dispatch + vectorized accept, ``host_s``) and the blocking remainder
    of the device wait (``wait_s``). With per-step device time
    ``s = wait_s / K``, the chunk size that keeps sync overhead at or
    below ``target_frac`` of the compute is ``K >= host_s / (frac * s)``;
    the tuner tracks EMAs of both and selects the smallest power-of-two
    ladder entry that satisfies it, saturating at the ladder top when the
    device wait vanishes.
    """

    LADDER = (1, 2, 4, 8, 16, 32)

    def __init__(self, target_frac: float = 0.25, ema: float = 0.35, init: int = 2):
        self.k = init
        self.target_frac = target_frac
        self._ema = ema
        self._h: float | None = None
        self._s: float | None = None

    def observe(self, host_s: float, wait_s: float, chunk: int):
        per_step = wait_s / max(chunk, 1)
        a = self._ema
        self._h = host_s if self._h is None else (1 - a) * self._h + a * host_s
        self._s = per_step if self._s is None else (1 - a) * self._s + a * per_step
        if self._s <= 1e-9:
            self.k = self.LADDER[-1]
            return
        want = self._h / (self.target_frac * self._s)
        for c in self.LADDER:
            if c >= want:
                self.k = c
                return
        self.k = self.LADDER[-1]


class ContinuousBatchingEngine:
    """Slot-based continuous batching for :class:`TransformerLM`.

    Args:
        model: the language model; its weights must be on ``device``.
        n_slots: concurrent sequences on the device (the decode batch).
        block_size: tokens per KV block.
        n_blocks: pool size (block 0 is reserved scratch).
        max_seq_len: per-sequence cap (defines the block-table width).
        prompt_buckets: the prefill prompt ladder.
        buckets: a :class:`ShapeBuckets` (supersedes ``prompt_buckets``).
        eos_id: stop token (None = run every request to max_new_tokens).
        temperature / greedy: sampling controls.
        seed: seeds the engine's ``torch.Generator`` (on ``device``),
            which draws the sampling noise.
        decode_chunk: K decode steps per host round trip, or ``"auto"``
            to tune K from measured chunk time vs host overhead. Token
            output is identical for every K (the stop rule is applied on
            the device per step); sampled output depends on K only
            through the order of the generator's draws.
        device: where the engine runs; default the CUDA card (no card:
            raises). ``"cpu"`` runs the kernels' plain versions.
        prefix_cache: the prefix-aware KV tier (:mod:`rl_tpu_torch.kvmem`):
            prompts share resident blocks, fork at most one block
            copy-on-write, and prefill only their uncached suffix.
            Finished sequences donate their blocks to the tree;
            unreferenced blocks are evicted LRU under pressure. Greedy
            output equals the engine without it.
        registry: a :class:`~rl_tpu_torch.compile.ProgramRegistry`; with
            one the decode chunks and the admission programs run as its
            programs (CUDA graphs on the card). ``None`` (the default) runs
            eagerly, unless ``warmup`` asks for the process registry.
        warmup: ``True`` captures the whole program ladder (the decode
            chunks: the fixed chunk, or the tuner's whole ladder; every
            prefill of the admit and prompt ladders; the copy ladder and
            the merge) before construction returns;
            ``"background"`` does it on a thread (handle at
            ``self._warmup_handle``) and :meth:`step`, :meth:`set_model`
            and :meth:`reset` wait for it first, since the capture works
            on the engine's buffers and generator.
        speculative: draft up to ``spec_lookahead`` tokens per slot from
            ``draft_source`` and verify them in one dispatch
            (``serving.verify.k{K}``, K on the decode ladder). Acceptance
            is exact equality with what sequential decode samples, so the
            output is ``slot_rng=True`` vanilla decode's from the same
            seed, up to the rounding of the two attention reads (verify
            reads the cache through the gather route, decode through the
            paged-decode kernel). Implies ``slot_rng=True``.
        slot_rng: sample with per-request streams, response token n of
            request rid keyed ``fold_in(fold_in(key(seed), rid), n)``,
            instead of the engine's generator: the sampled sequence
            depends only on (seed, rid). Off by default; the generator's
            stream is then untouched.
        spec_lookahead: the most drafted tokens verified per dispatch.
        draft_source: ``"prefix_tree"`` (the radix tree; needs
            ``prefix_cache=True``), ``"ngram"`` (host prompt-lookup), a
            :class:`~rl_tpu_torch.models.speculative.DraftSource`, or
            None for the best available.
        params_sharding, kv_handoff: the reference's options, accepted at
            their defaults. Any other value raises ``NotImplementedError``
            naming ROADMAP A7 (sharded params, the KV handoff);
            ``kv_handoff`` with ``speculative`` raises ``ValueError``, as
            in the reference.
    """

    def __init__(
        self,
        model: Any,
        *,
        n_slots: int = 8,
        block_size: int = 16,
        n_blocks: int = 257,
        max_seq_len: int | None = None,
        prompt_buckets: tuple = (32, 128, 512),
        buckets: ShapeBuckets | None = None,
        eos_id: int | None = None,
        temperature: float = 1.0,
        greedy: bool = False,
        seed: int = 0,
        decode_chunk: int | str = 1,
        device=None,
        prefix_cache: bool = False,
        params_sharding: Any = None,
        registry: Any = None,
        warmup: bool | str = False,
        speculative: bool = False,
        slot_rng: bool = False,
        spec_lookahead: int = 7,
        draft_source: Any = None,
        kv_handoff: bool = False,
    ):
        if kv_handoff and speculative:
            raise ValueError("kv_handoff does not compose with speculative decoding")
        refuse_options("ContinuousBatchingEngine", __name__, [
            ("params_sharding", params_sharding, None, "A7"),
            ("kv_handoff", kv_handoff, False, "A7"),
        ])
        want = resolve_device(device)
        if model.device.type != want.type or want.index not in (None, model.device.index):
            raise ValueError(f"model weights are on {model.device}, engine device is {want}")
        self.device = model.device
        self.model = model
        self.n_slots, self.block = n_slots, block_size
        self.max_seq_len = max_seq_len or model.cfg.max_seq_len
        self.max_blocks = -(-self.max_seq_len // block_size)
        if buckets is None:
            buckets = ShapeBuckets(prompt=tuple(sorted(prompt_buckets)))
        self.shape_buckets = buckets
        self.buckets = buckets.prompt
        self.eos_id = eos_id
        self.temperature, self.greedy = temperature, greedy
        self.decode_chunk = decode_chunk
        if decode_chunk == "auto":
            self._fixed_chunk = None
            self._tuner = _ChunkTuner()
        else:
            self._fixed_chunk = max(1, int(decode_chunk))
            self._tuner = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._cuda = self.device.type == "cuda"
        # per-request RNG streams (speculation needs them): every sampling
        # key is derived on the device from this base key and the slot's
        # rid and ntok; the generator above is then never drawn from
        self.speculative = bool(speculative)
        self.slot_rng = bool(slot_rng or speculative)
        self.spec_lookahead = int(spec_lookahead)
        self._base_key = key_from_seed(seed, self.device)

        cache = model.init_paged_cache(n_slots, n_blocks, block_size, self.max_blocks)
        # per layer: (pool_k, pool_v) or, int8, (pool_k, pool_v, scale_k, scale_v)
        self.pools = [tuple(c[f] for f in _POOL_FIELDS if f in c) for c in cache]
        # host mirrors (the allocator's source of truth)
        self.free_blocks = list(range(1, n_blocks))  # 0 = reserved scratch
        self._kvmem: PrefixKVAllocator | None = None
        self._slot_lease: list = [None] * n_slots
        self.prefill_tokens_computed = 0  # suffix tokens actually prefilled
        self.prefill_tokens_cached = 0  # prompt tokens served from the tree
        if prefix_cache:
            self._kvmem = PrefixKVAllocator(n_blocks, block_size)
            # ONE list object: the allocator owns it, the engine aliases it
            self.free_blocks = self._kvmem.free_blocks
        self.table = np.full((n_slots, self.max_blocks), -1, np.int32)
        self.lens = np.zeros(n_slots, np.int64)  # prompt + ACCEPTED tokens
        self.slot_rid = np.full(n_slots, -1, np.int64)  # -1 = free slot
        self.slot_budget = np.zeros(n_slots, np.int64)  # tokens left to emit
        # scheduled upper bounds: cover launches whose tokens are still in
        # flight (== lens/slot_budget whenever nothing is undrained)
        self.sched_lens = np.zeros(n_slots, np.int64)
        self.sched_budget = np.zeros(n_slots, np.int64)
        self.slot_tokens: list[list[np.ndarray]] = [[] for _ in range(n_slots)]
        self.slot_lps: list[list[np.ndarray]] = [[] for _ in range(n_slots)]
        self.slot_prompt: dict[int, np.ndarray] = {}

        # device-resident decode state; the table is kept on the device
        # and updated by one scatter per round, never re-uploaded whole
        dev, i32 = self.device, torch.int32
        self.dev_table = torch.full((n_slots, self.max_blocks), -1, dtype=i32, device=dev)
        self.dev_lens = torch.zeros(n_slots, dtype=i32, device=dev)
        self.dev_active = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.dev_budget = torch.zeros(n_slots, dtype=i32, device=dev)
        self.dev_last = torch.zeros(n_slots, dtype=i32, device=dev)
        # slot-stream state: the rid in each slot and the response tokens
        # it has sampled so far, from which every sampling key derives
        self.dev_rid = torch.full((n_slots,), -1, dtype=i32, device=dev)
        self.dev_ntok = torch.zeros(n_slots, dtype=i32, device=dev)
        self._dev_all_slots = torch.ones(n_slots, dtype=torch.bool, device=dev)
        self._dev_run = torch.ones(n_slots, dtype=torch.bool, device=dev)  # a graph's run mask
        self._pending_table_writes: list[tuple[int, int, int]] = []
        self._inflight: collections.deque[_InFlight] = collections.deque()

        self.queue: list[Request] = []
        self.finished: list[FinishedRequest] = []
        self._next_rid = 0
        self._n_pool_blocks = n_blocks - 1
        # instrumentation for throughput accounting
        self.decode_steps = 0
        self.prefill_rounds = 0
        self.prefill_s = 0.0  # host wall in admission rounds (prefill is synchronous)
        self.admissions = 0
        self.completions: dict[str, int] = {"eos": 0, "length": 0}
        # speculative accounting: verify dispatches, tokens drafted and
        # accepted, the accepted-tokens-per-slot EMA and histogram, and the
        # rounds that ran a plain decode instead (no draft; pool too tight)
        self.spec_dispatches = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_accept_ema = 1.0
        self._spec_accept_counts: dict[int, int] = {}
        self.spec_plain_rounds = {"no_draft": 0, "pool_tight": 0}
        # draft source: explicit instance > named source > best available
        self._draft_source: Any = None
        if self.speculative:
            if draft_source is None:
                draft_source = "prefix_tree" if self._kvmem is not None else "ngram"
            if draft_source == "prefix_tree":
                if self._kvmem is None:
                    raise ValueError("draft_source='prefix_tree' needs prefix_cache=True "
                                     "(the radix tree is the draft index)")
                self._draft_source = PrefixTreeDraft(self._kvmem)
            elif draft_source == "ngram":
                self._draft_source = NGramDraft()
            elif isinstance(draft_source, DraftSource):
                self._draft_source = draft_source
            else:
                raise ValueError(f"unknown draft_source: {draft_source!r}")

        if registry is None and warmup:
            registry = get_program_registry()
        self._registry = registry
        self._graph_pool = GraphPool()  # one memory pool for the engine's graphs
        self._fingerprint = repr((model.cfg, n_slots, block_size, n_blocks, self.max_blocks,
                                  eos_id, temperature, greedy))
        self._programs: dict[str, Any] = {}  # program name -> registered program
        self._warmup_handle = self._warming = None
        if warmup == "background":
            self._warmup_handle = self._warming = self.aot_warmup(background=True)
        elif warmup:
            self.aot_warmup()

    def _join_warmup(self) -> None:
        """Wait for a background warm-up (raising its failure) before
        anything touches the buffers and the generator it captures over."""
        if self._warming is not None:
            handle, self._warming = self._warming, None
            handle.result()

    # -- device work -----------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, queued without waiting:
        a copy from pageable memory would synchronise the stream, and
        with it the in-flight decode chunk. The pinned staging copy is
        the caching host allocator's, held until the transfer is done."""
        t = torch.from_numpy(a)
        if self._cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _caches(self, table, lens, active):
        """Per-layer cache dicts over the engine's pools."""
        return [
            dict(zip(_POOL_FIELDS, bufs), block_table=table, len=lens, active=active)
            for bufs in self.pools
        ]

    def _sample(self, logits, keys=None):
        """(token, behavior log-prob of that token) per row: the shared
        sampling rule, through the fused-sampling kernel on CUDA. ``keys``
        [S, 2]: each row's slot-stream key; None: the engine's generator."""
        return sample_tokens(
            logits, self._gen if keys is None else keys, temperature=self.temperature,
            greedy=self.greedy,
        )

    def _prefill(self, table_rows, tokens, token_mask, start, model=None, keys=None):
        """COMPACT bucketed prefill: only the admitted slots' rows ride
        the forward — tokens [A, B] (pads beyond each prompt), token_mask
        [A, B] marks real prompt tokens, table_rows [A, max_blocks] are the
        admitted slots' block tables. The pools are shared with the decode
        cache, so the writes land in place. ``start`` [A] is each row's
        cached prefix (0 without a prefix cache): the row's first
        ``start`` positions already hold K/V in shared or forked blocks,
        ``tokens`` hold only ``prompt[start:]``, and the cache length
        begins at ``start``, so the writes land at the right positions and
        the suffix attends the prefix through the table. Samples each
        admitted slot's FIRST response token (with ``keys``, each row
        from its own stream)."""
        A = tokens.shape[0]
        cache = self._caches(table_rows, start, token_mask)
        logits, _ = (model or self.model)(tokens, cache=cache)
        last = (token_mask.sum(dim=1) - 1).clamp_min(0)  # [A]
        last_logits = logits[torch.arange(A, device=self.device), last]
        return self._sample(last_logits, keys)

    def _cow_copy(self, cows):
        """Copy-on-write fork: every block-major buffer of every layer
        (pools and, int8, scales) copies its source blocks into the
        writers' fresh private blocks. Queued on the stream before the
        round's partial prefill, which therefore writes after it. With a
        registry, through the copy program of the pair count padded up
        the power-of-two ladder (the last pair repeated: copying it again
        changes nothing)."""
        if self._registry is not None:
            n = pow2ceil(len(cows))
            cows = list(cows) + [cows[-1]] * (n - len(cows))
        src, dst = (self._upload(np.asarray(c, np.int64)) for c in zip(*cows))
        if self._registry is None:
            self._cow_body(src, dst)
        else:
            self._program(f"serving.cowcopy.n{len(cows)}", self._cow_body,
                          self._pool_state)(src, dst)

    def _cow_body(self, src, dst):
        for bufs in self.pools:
            for a in bufs:
                a[dst] = a[src]

    @torch.no_grad()
    def _prefill_body(self, model, table, slots, tokens, token_mask, start=None):
        """A prefill program's body: the admitted rows' table gather, the
        forward and the first token's sample (``start`` 0 without a prefix
        cache)."""
        if start is None:
            start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        return self._prefill(table[slots], tokens, token_mask, start, model=model)

    @torch.no_grad()
    def _sprefill_body(self, model, table, slots, tokens, token_mask, rid, key, start=None):
        """The slot-stream prefill's body: as :meth:`_prefill_body`, each
        row sampling response token 0 of its request ``rid`` (-1 on pad
        rows) under the base key ``key``."""
        if start is None:
            start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        return self._prefill(table[slots], tokens, token_mask, start, model=model,
                             keys=self._slot_keys(key, rid, torch.zeros_like(rid)))

    def _slot_keys(self, key, rid, ntok):
        """The rows' slot-stream keys; None when greedy (no noise is drawn)."""
        return None if self.greedy else slot_keys(key, rid, ntok)

    def _pool_state(self) -> list:
        """What an admission program writes in place beside its arguments:
        every pool (and, int8, scale) buffer, and the generator (which the
        slot-stream family does not draw from)."""
        return [a for bufs in self.pools for a in bufs] + ([] if self.slot_rng else [self._gen])

    def _program(self, name: str, fn, state=None):
        """The engine's registered program ``name`` (made at first use), in
        the engine's graph pool."""
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = self._registry.register(
                name, fn, fingerprint=self._fingerprint, state=state, pool=self._graph_pool)
        return prog

    def _prefill_program(self, a: int, bucket: int):
        """The registered prefill of ``a`` rows of ``bucket`` tokens (the
        partial prefill over the suffix ladder with a prefix cache; the
        slot-stream family with ``slot_rng``)."""
        s = "s" if self.slot_rng else ""
        name = (f"serving.{s}pprefill.a{a}.s{bucket}" if self._kvmem is not None
                else f"serving.{s}prefill.a{a}.b{bucket}")
        body = self._sprefill_body if self.slot_rng else self._prefill_body
        return self._program(name, body, self._pool_state)

    def _merge_program(self):
        """The admission merge: its registered program with a registry,
        else the function."""
        name, fn = (("serving.sadmit_update", _sadmit_update) if self.slot_rng
                    else ("serving.admit_update", _admit_update))
        return fn if self._registry is None else self._program(name, fn)

    def _state_args(self):
        """The model and the device decode state a decode or verify
        program takes first, in order."""
        return (self.model, self.dev_table, self.dev_lens, self.dev_active, self.dev_budget,
                self.dev_last)

    def _stream_args(self):
        """What the slot-stream family takes last: rid, ntok, the base key."""
        return (self.dev_rid, self.dev_ntok, self._base_key) if self.slot_rng else ()

    def _decode_chunk(self, chunk, run_mask):
        """K decode steps with the per-slot stop rule applied ON DEVICE:
        an active slot decrements its budget each step and deactivates
        itself when it samples eos or runs out; inactive slots write to
        scratch and freeze their length. No step reads a value back to the
        host. Returns tokens/log-probs [S, K] (device) and advances the
        engine's device state. With a registry, through the chunk's
        program (its CUDA graph on the card)."""
        if self._registry is None:
            fn = lambda *args: self._decode_body(chunk, *args)  # noqa: E731
        else:
            fn = self._decode_program(chunk)
            self._dev_run.copy_(run_mask)  # the graph's own buffer, filled before the replay
            run_mask = self._dev_run
        out = fn(*self._state_args(), run_mask, *self._stream_args())
        toks, lps, self.dev_lens, self.dev_active, self.dev_budget, self.dev_last = out[:6]
        if self.slot_rng:
            self.dev_ntok = out[6]
        return toks, lps

    @torch.no_grad()
    def _decode_body(self, chunk, model, table, lens, active, budget, last, run_mask, rid=None,
                     ntok=None, key=None):
        """K decode steps; with ``key`` (slot-stream), step j samples slot s
        with the key of (rid[s], ntok[s] + its tokens so far), and the
        advanced ``ntok`` is returned last."""
        S = self.n_slots
        toks = torch.empty((S, chunk), dtype=torch.int32, device=self.device)
        lps = torch.empty((S, chunk), dtype=torch.float32, device=self.device)
        for k in range(chunk):
            eff = active & run_mask
            logits, cache = model(last[:, None], cache=self._caches(table, lens, eff))
            tok, lp = self._sample(logits[:, 0],
                                   None if key is None else self._slot_keys(key, rid, ntok))
            lens = cache[0]["len"]
            if key is not None:
                ntok = ntok + eff.to(ntok.dtype)
            budget = budget - eff.to(budget.dtype)
            stop = budget <= 0
            if self.eos_id is not None:
                stop = stop | (tok == self.eos_id)
            active = active & ~(stop & eff)
            last = torch.where(eff, tok, last)
            toks[:, k] = tok
            lps[:, k] = lp
        out = (toks, lps, lens, active, budget, last)
        return out if key is None else out + (ntok,)

    def _decode_program(self, chunk: int):
        """The registered program of K = ``chunk`` decode steps
        (``serving.sdecode.k{K}`` in slot-stream mode). The model is an
        argument, so a weight swap (:meth:`set_model`) captures anew; the
        pools and the generator are the engine's own (the eager run before
        a capture writes only where the replay writes again, and its draws
        are put back)."""
        s = "s" if self.slot_rng else ""
        return self._program(f"serving.{s}decode.k{chunk}",
                             lambda *args: self._decode_body(chunk, *args),
                             None if self.slot_rng else (lambda: [self._gen]))

    @torch.no_grad()
    def _verify_body(self, K, model, table, lens, active, budget, last, run_mask, drafts, rid,
                     ntok, key):
        """The speculative verify: one forward over K positions per slot,
        the true last token and K - 1 drafts (``drafts`` [S, K-1]), each
        position j sampled with the key of token index ntok + j; then the
        chain acceptance: a slot emits the longest run of samples whose
        every earlier draft equalled the sample before it, cut at eos and
        at the budget. K/V is written only inside the slot's room (its
        budget + 1 positions, and ``max_seq_len``), and the length
        advances by the emitted tokens alone, never by the positions
        written: a rejected position's K/V lies past the length, is never
        attended and is overwritten later. Returns the [S, K] samples and
        log-probs and the advanced state (lens, active, budget, last,
        ntok)."""
        S = lens.shape[0]
        dev = lens.device
        eff = active & run_mask
        x = torch.cat([last[:, None], drafts], dim=1)  # [S, K]
        n_room = torch.minimum(torch.minimum(budget + 1, self.max_seq_len - lens),
                               torch.full_like(budget, K))
        pos = torch.arange(K, device=dev)
        posmask = (pos[None, :] < n_room[:, None]) & eff[:, None]
        logits, _ = model(x, cache=self._caches(table, lens, posmask))
        keys = None if self.greedy else spec_keys(key, rid, ntok, K).reshape(S * K, 2)
        tok, lp = self._sample(logits.reshape(S * K, -1), keys)
        tok, lp = tok.reshape(S, K), lp.reshape(S, K)
        good = (drafts == tok[:, : K - 1]).to(torch.int32)  # [S, K-1]
        chain = 1 + torch.cumprod(good, dim=1).sum(dim=1, dtype=torch.int32)
        if self.eos_id is None:
            eos_pos = torch.full_like(chain, K)
        else:
            is_eos = tok == self.eos_id
            eos_pos = torch.where(is_eos.any(dim=1), is_eos.to(torch.int32).argmax(dim=1),
                                  K).to(torch.int32)
        n_emit = torch.minimum(torch.minimum(chain, eos_pos + 1), budget)
        n_emit = torch.where(eff, n_emit, 0)
        lens = lens + n_emit
        ntok = ntok + n_emit
        budget = budget - n_emit
        stop = budget <= 0
        if self.eos_id is not None:
            stop = stop | (eos_pos < n_emit)
        active = active & ~(stop & eff)
        idx = (n_emit - 1).clamp_min(0).long()
        last = torch.where(eff & (n_emit > 0), torch.gather(tok, 1, idx[:, None])[:, 0], last)
        return tok, lp, lens, active, budget, last, ntok

    def _verify_program(self, K: int):
        """The registered verify of width ``K`` (``serving.verify.k{K}``)."""
        return self._program(f"serving.verify.k{K}",
                             lambda *args: self._verify_body(K, *args))

    def _verify(self, K, run_mask, drafts):
        """One verify dispatch (its program with a registry); advances the
        engine's device state and returns the [S, K] samples and log-probs."""
        if self._registry is None:
            fn = lambda *args: self._verify_body(K, *args)  # noqa: E731
        else:
            fn = self._verify_program(K)
            self._dev_run.copy_(run_mask)
            run_mask = self._dev_run
        out = fn(*self._state_args(), run_mask, drafts, *self._stream_args())
        (toks, lps, self.dev_lens, self.dev_active, self.dev_budget, self.dev_last,
         self.dev_ntok) = out
        return toks, lps

    @torch.no_grad()
    def aot_warmup(self, *, decode_chunks=None, admit_sizes=None, prompt_buckets=None,
                   background: bool = False):
        """Capture the engine's whole program ladder ahead of traffic, as
        the reference's ``aot_warmup`` builds it: the decode chunks
        (``decode_chunks``, default the fixed chunk or the tuner's whole
        ladder); with speculation the verify rungs of the decode ladder
        from 2 up to ``spec_lookahead + 1`` rounded up the ladder; the
        slot-stream family in place of the plain one with ``slot_rng``;
        a prefill for every admit size (default
        ``ShapeBuckets.admit_sizes(n_slots)``) x prompt bucket (default the
        prompt ladder, or the suffix ladder with a prefix cache, whose
        copy ladder up to ``pow2ceil(n_slots)`` pairs comes too); and the
        merge. Under ``no_grad``, as admission and decode call them. The
        prefills' and copies' arguments write nothing but scratch block 0
        (all-False token masks; block 0 onto itself). Returns the
        registry's report, or a handle with ``background``. Call it while
        no request is live."""
        if self._registry is None:
            self._registry = get_program_registry()
        if decode_chunks is None:
            decode_chunks = ((self._fixed_chunk,) if self._fixed_chunk is not None
                             else _ChunkTuner.LADDER)
        progs = []
        S, dev = self.n_slots, self.device
        for chunk in decode_chunks:
            prog = self._decode_program(int(chunk))
            prog.add_signature(*self._state_args(), self._dev_run, *self._stream_args())
            progs.append(prog)
        if self.speculative:
            # the verify rungs ride the decode ladder, up to the widest a
            # round can dispatch (spec_lookahead drafts + the bonus sample)
            k_max = pow2ceil(min(self.spec_lookahead, _ChunkTuner.LADDER[-1] - 1) + 1)
            for k in _ChunkTuner.LADDER:
                if 2 <= k <= k_max:
                    progs.append(self._verify_program(k).add_signature(
                        *self._state_args(), self._dev_run,
                        torch.zeros((S, k - 1), dtype=torch.int32, device=dev),
                        *self._stream_args()))
        if admit_sizes is None:
            admit_sizes = self.shape_buckets.admit_sizes(S)
        if prompt_buckets is None:
            prompt_buckets = (self.buckets if self._kvmem is None
                              else self.shape_buckets.suffix_ladder())

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        for a in map(int, admit_sizes):
            for b in map(int, prompt_buckets):
                prog = self._prefill_program(a, b)
                args = [self.model, self.dev_table, zeros(a, torch.int64),
                        zeros((a, b), torch.int32), zeros((a, b), torch.bool)]
                if self.slot_rng:
                    args += [zeros(a, torch.int32), self._base_key]
                if self._kvmem is not None:
                    args.append(zeros(a, torch.int32))
                progs.append(prog.add_signature(*args))
        if self._kvmem is not None:
            n = 1
            while n <= pow2ceil(S):
                prog = self._program(f"serving.cowcopy.n{n}", self._cow_body, self._pool_state)
                progs.append(prog.add_signature(zeros(n, torch.int64), zeros(n, torch.int64)))
                n *= 2
        state = [self.dev_lens, self.dev_active, self.dev_budget, self.dev_last]
        new = [zeros(S, torch.bool), zeros(S, torch.int32), zeros(S, torch.int32),
               zeros(S, torch.int32)]
        if self.slot_rng:
            state += [self.dev_rid, self.dev_ntok]
            new.append(zeros(S, torch.int32))
        progs.append(self._merge_program().add_signature(*state, *new))
        return self._registry.aot_warmup(programs=progs, background=background)

    # -- allocator -------------------------------------------------------------

    def _blocks_needed(self, length: int) -> int:
        return -(-length // self.block)

    def _ensure_blocks(self, slot: int, new_len: int) -> bool:
        """Grow the slot's table to cover ``new_len`` tokens; False if the
        pool is exhausted (caller defers the work). ``have`` is counted
        from the table itself, so an allocation that already covered
        len+1 is never overwritten (which would leak a block)."""
        have = int((self.table[slot] >= 0).sum())
        need = self._blocks_needed(new_len)
        if self._kvmem is not None:
            # decode growth through the allocator: may evict LRU
            # unreferenced cached blocks to satisfy the request
            got = self._kvmem.alloc(need - have)
            if got is None:
                return False
            for j, b in zip(range(have, need), got):
                self.table[slot, j] = b
                self._pending_table_writes.append((slot, j, b))
            return True
        if need - have > len(self.free_blocks):
            return False
        for j in range(have, need):
            b = self.free_blocks.pop()
            self.table[slot, j] = b
            self._pending_table_writes.append((slot, j, b))
        return True

    def _flush_table_writes(self):
        """Apply the accumulated host table-mirror writes to the device
        table in ONE scatter. It is queued on the stream after every chunk
        already launched, which therefore still reads the old entries."""
        if not self._pending_table_writes:
            return
        rows, cols, vals = np.asarray(self._pending_table_writes, np.int64).T
        self.dev_table[self._upload(rows), self._upload(cols)] = self._upload(
            vals.astype(np.int32)
        )
        self._pending_table_writes.clear()

    def _free_slot(self, slot: int, reason: str):
        self.completions[reason] = self.completions.get(reason, 0) + 1
        rid = int(self.slot_rid[slot])
        chunks = self.slot_tokens[slot]
        self.finished.append(
            FinishedRequest(
                rid=rid,
                prompt=self.slot_prompt.pop(rid),
                tokens=(
                    np.concatenate(chunks).astype(np.int32)
                    if chunks
                    else np.zeros(0, np.int32)
                ),
                log_probs=(
                    np.concatenate(self.slot_lps[slot]).astype(np.float32)
                    if self.slot_lps[slot]
                    else np.zeros(0, np.float32)
                ),
                finished_reason=reason,
            )
        )
        used = self.table[slot]
        if self._kvmem is not None:
            # the lease ends BEFORE the host mirrors reset: lens[slot] still
            # counts exactly the positions with K/V (prompt + accepted
            # tokens minus the final sample, never fed back), so the
            # allocator can extend/donate the generated blocks and free the
            # rest
            fin = self.finished[-1]
            lease, self._slot_lease[slot] = self._slot_lease[slot], None
            self._kvmem.release(
                lease, fin.prompt.tolist() + fin.tokens.tolist(), int(self.lens[slot]),
                [int(b) for b in used if b >= 0],
            )
        else:
            self.free_blocks.extend(int(b) for b in used[used >= 0])
        self.table[slot] = -1
        self.lens[slot] = 0
        self.sched_lens[slot] = 0
        self.slot_budget[slot] = 0
        self.sched_budget[slot] = 0
        self.slot_rid[slot] = -1
        self.slot_tokens[slot] = []
        self.slot_lps[slot] = []
        # no device-side cleanup is needed: the slot deactivated ITSELF on
        # device (that is what finished it), and stale table-row tails are
        # unreachable — every read is gated on the slot's length

    # -- public surface --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always samples one token)")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})"
            )
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest prefill "
                f"bucket {self.buckets[-1]}; raise prompt_buckets"
            )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    @torch.no_grad()
    def _admit(self) -> int:
        """Fill free slots from the queue; one bucketed prefill per
        admission round (requests grouped into the round's max bucket).
        Prefill is synchronous — the host needs the first token to settle
        eos/budget immediately — and its device-state updates are one
        masked write, queued after any in-flight chunk. Returns the number
        of requests admitted."""
        free = [s for s in range(self.n_slots) if self.slot_rid[s] < 0]
        if not free or not self.queue:
            return 0
        t_start = time.perf_counter()
        batch: list[tuple[int, Request]] = []
        starts: list[int] = []  # cached-prefix length per admitted row
        cows: list[tuple[int, int]] = []  # (src, dst) block copies this round
        for s in free:
            if not self.queue:
                break
            req = self.queue[0]
            if self._kvmem is None:
                if not self._ensure_blocks(s, len(req.prompt) + 1):
                    break  # pool exhausted: retry after sequences finish
                starts.append(0)
            else:
                plan = self._kvmem.admit(req.prompt.tolist(), len(req.prompt) + 1)
                # None: pool exhausted. DEFER_ROUND: the match touches blocks
                # published earlier in THIS round, whose prefill is not
                # queued yet; next round the stream orders the share
                if plan is None or plan is DEFER_ROUND:
                    break
                for j, b in enumerate(plan.blocks):
                    self.table[s, j] = b
                    self._pending_table_writes.append((s, j, b))
                self._slot_lease[s] = plan.lease
                starts.append(plan.shared_len)
                if plan.cow is not None:
                    cows.append(plan.cow)
            batch.append((s, self.queue.pop(0)))
        if not batch:
            return 0
        suffix = max(len(r.prompt) - st for (_, r), st in zip(batch, starts))
        if self._kvmem is not None:
            # the ladder buckets the SUFFIX: a 400-token prompt with 384
            # cached prefills like a 16-token cold prompt
            bucket = self.shape_buckets.suffix_bucket(suffix)
        else:
            bucket = self.shape_buckets.prompt_bucket(suffix)
        A = len(batch)
        self.admissions += A
        # pad rows carry an all-False token mask, so their writes go to the
        # reserved scratch block and the host never reads their rows
        pad_a = self.shape_buckets.admit_bucket(A, self.n_slots)
        tokens = np.zeros((pad_a, bucket), np.int32)
        mask = np.zeros((pad_a, bucket), bool)
        for i, ((s, req), st) in enumerate(zip(batch, starts)):
            P = len(req.prompt)
            tokens[i, : P - st] = req.prompt[st:]
            mask[i, : P - st] = True
            self.slot_rid[s] = req.rid
            self.slot_prompt[req.rid] = req.prompt
            self.slot_tokens[s] = []
            self.slot_lps[s] = []
        # pad rows gather slot 0's table row — harmless, since an inactive
        # row never writes through its table and its reads are discarded
        slots = np.zeros(pad_a, np.int64)
        slots[:A] = [s for s, _ in batch]
        start = np.zeros(pad_a, np.int32)
        start[:A] = starts
        self._flush_table_writes()  # prefill reads the new rows on device
        if cows:
            self._cow_copy(cows)
        stream = []  # the slot-stream prefill's rids (-1 on pad rows) and base key
        if self.slot_rng:
            rid = np.full(pad_a, -1, np.int32)
            rid[:A] = [req.rid for _, req in batch]
            stream = [self._upload(rid), self._base_key]
        if self._registry is None:
            keys = (self._slot_keys(stream[1], stream[0], torch.zeros_like(stream[0]))
                    if self.slot_rng else None)
            tok, lp = self._prefill(
                self.dev_table[self._upload(slots)], self._upload(tokens),
                self._upload(mask), self._upload(start), None, keys,
            )
        else:
            args = [self.model, self.dev_table, self._upload(slots), self._upload(tokens),
                    self._upload(mask), *stream]
            if self._kvmem is not None:
                args.append(self._upload(start))
            tok, lp = self._prefill_program(pad_a, bucket)(*args)
        if self._kvmem is not None:
            # the round's published blocks are now behind a queued prefill:
            # safe for the next round's admissions to share
            self._kvmem.end_round()
        self.prefill_tokens_computed += sum(len(r.prompt) - st for (_, r), st in zip(batch, starts))
        self.prefill_tokens_cached += sum(starts)
        self.prefill_rounds += 1
        tok_host, lp_host = tok.cpu().numpy(), lp.cpu().numpy()
        surv = np.zeros(self.n_slots, bool)
        new_lens = np.zeros(self.n_slots, np.int32)
        new_budget = np.zeros(self.n_slots, np.int32)
        new_last = np.zeros(self.n_slots, np.int32)
        new_rid = np.zeros(self.n_slots, np.int32)
        for i, (s, req) in enumerate(batch):
            P = len(req.prompt)
            t0, l0 = int(tok_host[i]), float(lp_host[i])
            self.lens[s] = P
            self.sched_lens[s] = P
            self.slot_tokens[s] = [np.asarray([t0], np.int32)]
            self.slot_lps[s] = [np.asarray([l0], np.float32)]
            b = req.max_new_tokens - 1  # prefill emitted the first token
            self.slot_budget[s] = b
            self.sched_budget[s] = b
            if self.eos_id is not None and t0 == self.eos_id:
                self._free_slot(s, "eos")
            elif b <= 0:
                self._free_slot(s, "length")
            else:
                surv[s] = True
                new_lens[s], new_budget[s], new_last[s], new_rid[s] = P, b, t0, req.rid
        if surv.any():
            state = [self.dev_lens, self.dev_active, self.dev_budget, self.dev_last]
            new = [self._upload(surv), self._upload(new_lens), self._upload(new_budget),
                   self._upload(new_last)]
            if self.slot_rng:
                state += [self.dev_rid, self.dev_ntok]
                new.append(self._upload(new_rid))
            out = self._merge_program()(*state, *new)
            self.dev_lens, self.dev_active, self.dev_budget, self.dev_last = out[:4]
            if self.slot_rng:
                self.dev_rid, self.dev_ntok = out[4:]
        self.prefill_s += time.perf_counter() - t_start
        return A

    # -- the de-synced decode loop ---------------------------------------------

    def _choose_chunk(self, run: np.ndarray) -> int:
        base = self._fixed_chunk if self._fixed_chunk is not None else self._tuner.k
        if self._fixed_chunk is not None:
            return base
        rem = self.sched_budget[run]
        # no point scanning past the longest remaining budget; with queued
        # admissions waiting, stop just past the EARLIEST finisher so its
        # slot refills promptly (bounds the idle-slot ride-along waste)
        cap = int(rem.max())
        if self.queue:
            cap = min(cap, pow2ceil(int(rem.min())))
        k = 1
        for c in _ChunkTuner.LADDER:
            if c <= min(base, max(cap, 1)):
                k = c
        return k

    @torch.no_grad()
    def _launch(self) -> bool:
        """Dispatch one decode chunk without waiting for its result.
        Returns False when there is nothing to advance."""
        host_active = self.slot_rid >= 0
        run = host_active & (self.sched_budget > 0)
        if not run.any():
            return False
        chunk = self._choose_chunk(run)
        while True:
            failed = [
                s
                for s in map(int, np.nonzero(run)[0])
                if not self._ensure_blocks(
                    s,
                    int(self.sched_lens[s]) + min(chunk, int(self.sched_budget[s])),
                )
            ]
            if not failed:
                break
            if self._inflight:
                # in-flight completions may free blocks: settle them first
                while self._inflight:
                    self._drain_one()
                host_active = self.slot_rid >= 0
                run = host_active & (self.sched_budget > 0)
                if not run.any():
                    return False
                continue
            if chunk > 1:
                chunk = 1  # pool tight: single-step this round
                continue
            for s in failed:
                run[s] = False
            if not run.any():
                # every in-flight sequence needs a block and none can
                # decode: no completion can ever free one — fail loudly
                raise RuntimeError(
                    f"block pool exhausted with all {len(failed)} in-flight "
                    f"sequences stalled ({len(self.free_blocks)} free "
                    f"blocks); the pool cannot hold this working set"
                )
            break
        self._flush_table_writes()
        run_dev = self._dev_all_slots if run.all() else self._upload(run)
        t0 = time.perf_counter()
        toks, lps = self._decode_chunk(chunk, run_dev)
        toks_h, lps_h, done = self._to_host(toks, lps)
        dispatch_s = time.perf_counter() - t0
        want = np.minimum(chunk, self.sched_budget) * run
        self.sched_lens += want
        self.sched_budget -= want
        self._inflight.append(
            _InFlight(toks_h, lps_h, done, self.slot_rid.copy(), run.copy(), chunk, dispatch_s)
        )
        self.decode_steps += chunk
        return True

    def _to_host(self, toks, lps):
        """Start the device->host copy of a dispatch's tokens and log-probs
        now; the drain only waits for it (the event, None on the CPU)."""
        if not self._cuda:
            return toks, lps, None
        toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        lps_h = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
        toks_h.copy_(toks, non_blocking=True)
        lps_h.copy_(lps, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return toks_h, lps_h, done

    @torch.no_grad()
    def _launch_spec(self) -> bool:
        """Dispatch one speculative verify round: the host drafts for every
        running slot, padded into ONE [S, K-1] batch at the smallest
        decode-ladder rung covering the longest draft, and all K positions
        scored in one forward (``serving.verify.k{K}``). A slot without a
        draft rides along on zeros: a coincidental match is still the true
        sample, since acceptance is equality. Runs the plain slot-stream
        decode instead when no slot has a draft or the pool is too tight
        for width K (each counted in ``spec_plain_rounds``)."""
        run = (self.slot_rid >= 0) & (self.sched_budget > 0)
        if not run.any():
            return False
        drafts: dict[int, list] = {}
        ladder_cap = _ChunkTuner.LADDER[-1] - 1
        for s in map(int, np.nonzero(run)[0]):
            cap = min(self.spec_lookahead,
                      int(self.slot_budget[s]) - 1,  # the +1 is the bonus sample
                      self.max_seq_len - int(self.lens[s]) - 1, ladder_cap)
            if cap <= 0:
                continue
            rid = int(self.slot_rid[s])
            context = self.slot_prompt[rid].tolist()
            for ch in self.slot_tokens[s]:
                context.extend(int(t) for t in ch)
            d = self._draft_source.propose(context, cap)
            if d:
                drafts[s] = list(d)[:cap]
        if not drafts:
            self.spec_plain_rounds["no_draft"] += 1
            return self._launch()
        max_d = max(len(d) for d in drafts.values())
        K = next(c for c in _ChunkTuner.LADDER if c >= max_d + 1)
        for s in map(int, np.nonzero(run)[0]):
            need = int(self.lens[s]) + min(K, int(self.slot_budget[s]) + 1,
                                           self.max_seq_len - int(self.lens[s]))
            if not self._ensure_blocks(s, need):
                # the plain launch has its own degrade ladder
                self.spec_plain_rounds["pool_tight"] += 1
                return self._launch()
        draft_np = np.zeros((self.n_slots, K - 1), np.int32)
        for s, d in drafts.items():
            draft_np[s, : len(d)] = d
        self._flush_table_writes()
        run_dev = self._dev_all_slots if run.all() else self._upload(run)
        t0 = time.perf_counter()
        toks, lps = self._verify(K, run_dev, self._upload(draft_np))
        toks_h, lps_h, done = self._to_host(toks, lps)
        dispatch_s = time.perf_counter() - t0
        # the scheduled UPPER bound (the chain length is on the device);
        # the verify's drain resyncs sched_* to what was accepted
        want = np.minimum(K, self.sched_budget) * run
        self.sched_lens += want
        self.sched_budget -= want
        self._inflight.append(_InFlight(toks_h, lps_h, done, self.slot_rid.copy(), run.copy(), K,
                                        dispatch_s, kind="verify", draft=draft_np))
        self.spec_dispatches += 1
        self.spec_draft_tokens += sum(len(d) for d in drafts.values())
        self.decode_steps += 1  # one forward, however many positions
        return True

    def _drain_one(self):
        """Accept the OLDEST in-flight chunk: wait for its copy, then one
        vectorized pass over all S slots (the device stop rule re-derived
        in numpy: accept min(first-eos+1, budget, K) tokens)."""
        fl = self._inflight.popleft()
        t0 = time.perf_counter()
        if fl.done is not None:
            fl.done.synchronize()
        tok = fl.toks.numpy().copy()
        lp = fl.lps.numpy().copy()
        wait_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        K = fl.chunk
        # a slot's tokens count only while the SAME request still owns it
        # (a slot freed by an earlier drain — and possibly re-admitted —
        # ran this chunk deactivated on device; its rows are garbage)
        valid = fl.run_mask & (self.slot_rid == fl.rid0) & (fl.rid0 >= 0)
        if fl.kind == "verify":
            # the device's chain acceptance from the same inputs: drafts
            # 1..j accepted iff each equalled the sample before it
            good = (tok[:, : K - 1] == fl.draft).astype(np.int64)
            chain = 1 + np.cumprod(good, axis=1).sum(axis=1)
        else:
            chain = np.full(self.n_slots, K, np.int64)
        if self.eos_id is None:
            eos_pos = np.full(self.n_slots, K, np.int64)
        else:
            is_eos = tok == self.eos_id
            has = is_eos.any(axis=1)
            eos_pos = np.where(has, is_eos.argmax(axis=1), K)
        n_emit = np.minimum(np.minimum(eos_pos + 1, self.slot_budget), chain)
        n_emit = np.where(valid, n_emit, 0)
        self.lens += n_emit
        self.slot_budget -= n_emit
        for s in map(int, np.nonzero(n_emit)[0]):
            n = int(n_emit[s])
            self.slot_tokens[s].append(tok[s, :n])
            self.slot_lps[s].append(lp[s, :n])
        fin_eos = valid & (eos_pos < n_emit)
        fin_len = valid & ~fin_eos & (self.slot_budget <= 0)
        if fl.kind == "verify":
            emitted, n_valid = int(n_emit.sum()), int(valid.sum())
            self.spec_accepted_tokens += emitted
            if n_valid:
                self.spec_accept_ema = 0.8 * self.spec_accept_ema + 0.2 * (emitted / n_valid)
                for n in n_emit[valid].tolist():
                    self._spec_accept_counts[n] = self._spec_accept_counts.get(n, 0) + 1
        for s in map(int, np.nonzero(fin_eos)[0]):
            self._free_slot(s, "eos")
        for s in map(int, np.nonzero(fin_len)[0]):
            self._free_slot(s, "length")
        if fl.kind == "verify":
            # a chain break emits fewer tokens than were scheduled without
            # finishing the slot: resync the scheduled bounds (speculative
            # mode drains before every launch)
            self.sched_lens[:] = self.lens
            self.sched_budget[:] = self.slot_budget
        elif self._tuner is not None:
            host_s = (time.perf_counter() - t1) + fl.dispatch_s
            self._tuner.observe(host_s, wait_s, K)

    def _inflight_ready(self) -> bool:
        done = self._inflight[0].done
        return done is None or done.query()

    def step(self) -> bool:
        """Admit + dispatch one decode chunk, then accept the PREVIOUS
        chunk's tokens while the new one runs (double buffering). Returns
        False when all work is done."""
        self._join_warmup()
        if self.speculative:
            return self._step_spec()
        # if the previous chunk already finished on device, settle it
        # first — admissions and the next launch then see fresh slots
        if self._inflight and self._inflight_ready():
            self._drain_one()
        admitted = self._admit()
        launched = self._launch()
        if not launched:
            if self._inflight:
                while self._inflight:
                    self._drain_one()
                admitted = self._admit()
                launched = self._launch()
            if not launched:
                # a round whose requests all finished at prefill (or that
                # deferred the rest behind its own publications) leaves
                # nothing to decode: the next step admits again
                if self.queue and not admitted and not (self.slot_rid >= 0).any():
                    # nothing in flight, yet admission failed: the pool
                    # cannot hold the front request at all
                    raise RuntimeError(
                        f"block pool too small: request rid="
                        f"{self.queue[0].rid} needs "
                        f"{self._blocks_needed(len(self.queue[0].prompt) + 1)} "
                        f"blocks, pool has {len(self.free_blocks)} free"
                    )
                return bool(self.queue) or bool((self.slot_rid >= 0).any())
        while len(self._inflight) > 1:
            self._drain_one()
        return True

    def _step_spec(self) -> bool:
        """The speculative step: drafting reads each slot's full context on
        the host, so every dispatch is drained before the next launch (the
        double buffering of :meth:`step` traded for several tokens a
        dispatch)."""
        while self._inflight:
            self._drain_one()
        admitted = self._admit()
        if not self._launch_spec():
            if self.queue and not admitted and not (self.slot_rid >= 0).any():
                raise RuntimeError(
                    f"block pool too small: request rid={self.queue[0].rid} needs "
                    f"{self._blocks_needed(len(self.queue[0].prompt) + 1)} blocks, pool has "
                    f"{len(self.free_blocks)} free"
                )
            return bool(self.queue) or bool((self.slot_rid >= 0).any())
        while self._inflight:
            self._drain_one()
        return True

    def harvest(self) -> dict[int, FinishedRequest]:
        """Pop the requests finished SO FAR without blocking on the rest
        (interleave with ``step()`` to consume completions while the other
        slots keep decoding)."""
        if not self.finished:
            return {}
        out = {f.rid: f for f in self.finished}
        self.finished.clear()
        return out

    def run(self) -> dict[int, FinishedRequest]:
        """Drain the queue; returns THIS run's {rid: FinishedRequest} and
        clears the internal finished list."""
        while self.step():
            pass
        out = {f.rid: f for f in self.finished}
        self.finished.clear()
        return out

    def stats(self) -> dict:
        """Host counters of the engine (no device read): admissions,
        prefill and decode counts, KV block use; with speculation the
        reference's ``spec_*`` counters, the draft source's and the rounds
        that ran a plain decode (``spec_plain_rounds_no_draft``,
        ``_pool_tight``); with the prefix cache the allocator's hit, fork,
        eviction and draft counters."""
        used = self._n_pool_blocks - len(self.free_blocks)
        snap = {
            "admissions": self.admissions,
            "prefill_rounds": self.prefill_rounds,
            "prefill_s": self.prefill_s,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_cached": self.prefill_tokens_cached,
            "decode_steps": self.decode_steps,
            "completions_eos": self.completions.get("eos", 0),
            "completions_length": self.completions.get("length", 0),
            "kv_blocks_used": used,
            "kv_blocks_total": self._n_pool_blocks,
            "kv_utilization": used / max(self._n_pool_blocks, 1),
        }
        if self.speculative:
            snap["spec_dispatches"] = self.spec_dispatches
            snap["spec_draft_tokens"] = self.spec_draft_tokens
            snap["spec_accepted_tokens"] = self.spec_accepted_tokens
            snap["spec_accept_ema"] = self.spec_accept_ema
            snap["spec_accepted_per_dispatch"] = (
                self.spec_accepted_tokens / self.spec_dispatches if self.spec_dispatches else 0.0)
            snap["spec_accept_counts"] = dict(self._spec_accept_counts)
            for k, v in self.spec_plain_rounds.items():
                snap[f"spec_plain_rounds_{k}"] = v
            for k, v in self._draft_source.stats().items():
                snap[f"spec_draft_{k}"] = v
        if self._kvmem is not None:
            snap.update(self._kvmem.stats())
            # resident blocks no live sequence references are one
            # eviction from free, so they do not count as used
            free_adj = self._kvmem.free_adjusted()
            snap["kv_free_blocks_adjusted"] = free_adj
            snap["kv_utilization"] = 1.0 - free_adj / max(self._n_pool_blocks, 1)
        return snap

    def set_model(self, model: Any) -> None:
        """Serve ``model`` from now on, keeping the pools, the allocator
        and the generator (the reference's ``eng.params = params``).
        ``model`` must have the same config and device, and no request may
        be queued, live or in flight. The engine derives nothing from the
        weights at construction (the pools follow the config), so nothing
        else changes; a prefix cache's resident blocks hold the old
        weights' K/V, so a caller that swaps weights resets the engine
        first."""
        self._join_warmup()
        if model is self.model:
            return
        if model.cfg != self.model.cfg or model.device != self.device:
            raise ValueError("set_model: the new model's config or device differs")
        if self.queue or self._inflight or (self.slot_rid >= 0).any():
            raise RuntimeError("set_model: requests are still queued, live or in flight")
        self.model = model

    def reset(self) -> None:
        """Return the engine to an empty state IN PLACE: every slot freed,
        every block back in the pool, the prefix tree dropped,
        queue/finished/in-flight dropped. The pools (stale contents are
        unreachable once every table row is cleared), the generator and
        the monotone counters survive."""
        self._join_warmup()
        n = self.n_slots
        if self._kvmem is not None:
            # in place: self.free_blocks stays the allocator's list object
            self._kvmem.reset()
            self._slot_lease = [None] * n
        else:
            self.free_blocks = list(range(1, self._n_pool_blocks + 1))
        self.table[:] = -1
        self.lens[:] = 0
        self.slot_rid[:] = -1
        self.slot_budget[:] = 0
        self.sched_lens[:] = 0
        self.sched_budget[:] = 0
        self.slot_tokens = [[] for _ in range(n)]
        self.slot_lps = [[] for _ in range(n)]
        self.slot_prompt.clear()
        self.dev_table.fill_(-1)
        self.dev_lens = torch.zeros_like(self.dev_lens)
        self.dev_active = torch.zeros_like(self.dev_active)
        self.dev_budget = torch.zeros_like(self.dev_budget)
        self.dev_last = torch.zeros_like(self.dev_last)
        self.dev_rid = torch.full_like(self.dev_rid, -1)
        self.dev_ntok = torch.zeros_like(self.dev_ntok)
        self._pending_table_writes.clear()
        self._inflight.clear()
        self.queue.clear()
        self.finished.clear()
