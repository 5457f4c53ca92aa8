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

**KV handoff** (``kv_handoff=True``, the fleet's prefill/decode
disaggregation). :meth:`~ContinuousBatchingEngine.prefill_detached` runs
one admission-ladder prefill and returns a :class:`KVHandoff`: the first
token and host copies of the written KV blocks, block-major per layer
field (int8 pools carry their scales), the layout of the reference's
handoff, so one package adopts the other's;
:meth:`~ContinuousBatchingEngine.adopt_handoff` scatters them into fresh
blocks and joins the slot through the admission merge.

**Threads and streams.** An engine is not thread-safe: its owner (the
:class:`LoadBalancer`, :class:`ServingService` or
:class:`~rl_tpu_torch.models.fleet.ServingFleet`) serialises calls with a
lock. On the card :meth:`~ContinuousBatchingEngine.own_stream` gives the
engine a CUDA stream of its own; every entry point then queues its work
there, after the work the calling thread has queued so far, whichever
thread calls. So an adopt's scatter precedes the next decode chunk, a
weight load (:meth:`~ContinuousBatchingEngine.load_weights`) lands
between two chunks, and several engines on one card overlap.

:class:`LoadBalancer`, :class:`ServingService` and :class:`RemoteEngine`
(the engine behind the reference's line-JSON TCP wire) follow the engine.
Parameter sharding waits for ``parallel/`` (ROADMAP A7).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
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

__all__ = ["ContinuousBatchingEngine", "FinishedRequest", "KVHandoff", "LoadBalancer",
           "RemoteEngine", "Request", "ServiceSaturated", "ServingService"]

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
class KVHandoff:
    """A detached prefill's transferable result: the prompt, the first
    sampled token, the remaining budget and host copies of the KV blocks
    that hold positions ``[0, lens)``. Self-contained: the prefill engine
    frees its blocks before returning it, so dropping a handoff leaks
    nothing."""

    prompt: np.ndarray  # [P] int32
    first_token: int
    first_lp: float
    budget: int  # tokens still to emit (max_new_tokens - 1)
    lens: int  # KV-valid positions (== len(prompt))
    block_size: int
    # per layer: the pool-field tuple (2 fields, or 4 with int8 scales) of
    # host arrays, each [n_blocks_used, ...] block-major; numpy arrays, or
    # CPU tensors for bfloat16 pools (numpy has no bfloat16)
    kv: tuple = ()
    # set when the prefill already finished the request (eos as the first
    # token, or a one-token budget): nothing to adopt, deliver it directly
    finished: FinishedRequest | None = None


def _host_array(t: torch.Tensor):
    """A CPU tensor as the handoff holds it: numpy where numpy has the
    dtype, else the tensor."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A handoff field as a CPU tensor of the pool's ``dtype``: a tensor,
    or a numpy array (a bfloat16 one, as the reference's handoff holds, is
    reinterpreted through its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a, copy=True, order="C")  # a reference handoff's arrays are read-only
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"handoff field of dtype {t.dtype} for a pool of {dtype}")
    return t


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
        kv_handoff: allow :meth:`prefill_detached` and
            :meth:`adopt_handoff` (plain engines only: with
            ``speculative`` or ``prefix_cache`` it raises ``ValueError``,
            as in the reference).
        params_sharding: the reference's option, accepted at its default
            (None); any other value raises ``NotImplementedError`` naming
            ROADMAP A7.

    ``on_admit``, when set, is called with each admitted rid right after
    its prefill sampled the first token (on the thread that steps the
    engine; the fleet's TTFT hook).
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
        if kv_handoff and prefix_cache:
            raise ValueError("kv_handoff needs prefix_cache=False (a prefix lease "
                             "cannot follow the sequence to another engine)")
        refuse_options("ContinuousBatchingEngine", __name__, [
            ("params_sharding", params_sharding, None, "A7"),
        ])
        self.kv_handoff = bool(kv_handoff)
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
        self._stream = None  # the engine's own CUDA stream (own_stream)
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
        # ``submit`` may run on another thread than ``step`` (a fleet's
        # dispatcher): it takes a rid under this lock and appends (one
        # atomic list append), while the stepping thread alone pops the
        # front
        self._rid_lock = threading.Lock()
        # set by ``_admit`` when the pool refused the front request with
        # nothing admitted, so a request queued meanwhile by another
        # thread is never mistaken for one the pool cannot hold
        self._refused = False
        self.finished: list[FinishedRequest] = []
        self._next_rid = 0
        self._n_pool_blocks = n_blocks - 1
        # fleet hook: called with each admitted rid right after its prefill
        # sampled the first token
        self.on_admit: Any = None
        # instrumentation for throughput and host-sync accounting
        self.tokens_generated = 0  # decode tokens accepted (host count)
        self.decode_launches = 0
        self.decode_drains = 0
        self.host_transfers = 0  # blocking device->host reads
        self.prefill_token_slots = 0
        self.decode_chunk_last = 1
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

    def own_stream(self) -> None:
        """Queue this engine's device work on a CUDA stream of its own from
        now on (nothing on the CPU). Each entry point (:meth:`step`,
        :meth:`prefill_detached`, :meth:`adopt_handoff`,
        :meth:`load_weights`, :meth:`set_model`, :meth:`reset`,
        :meth:`aot_warmup`) then makes the stream wait for the work queued
        so far on the calling thread's stream and runs on it, so the calls
        of several threads into one engine keep one order on the card. The
        device state the engine replaces as it runs is made anew on the
        stream, so its memory is freed in the stream's order."""
        if not self._cuda or self._stream is not None:
            return
        self._join_warmup()
        stream = torch.cuda.Stream(device=self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for name in ("dev_lens", "dev_active", "dev_budget", "dev_last", "dev_rid",
                         "dev_ntok"):
                setattr(self, name, getattr(self, name).clone())
        self._stream = stream

    @contextlib.contextmanager
    def _on_stream(self):
        """The block's device work on the engine's own stream, after the
        caller's queued work (a no-op without :meth:`own_stream`)."""
        stream = self._stream
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            yield

    def synchronize(self) -> None:
        """Wait until the engine's queued device work has run."""
        if self._cuda:
            (self._stream or torch.cuda.current_stream(self.device)).synchronize()

    # -- device work -----------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, queued without waiting:
        a copy from pageable memory would synchronise the stream, and
        with it the in-flight decode chunk. The pinned staging copy is
        the caching host allocator's, held until the transfer is done."""
        return self._upload_tensor(torch.from_numpy(a))

    def _upload_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """A CPU tensor on the engine's device, as :meth:`_upload`."""
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

    def aot_warmup(self, *, decode_chunks=None, admit_sizes=None, prompt_buckets=None,
                   background: bool = False):
        """Capture the engine's whole program ladder (see
        :meth:`_aot_warmup`), on the engine's stream."""
        with self._on_stream():
            return self._aot_warmup(decode_chunks=decode_chunks, admit_sizes=admit_sizes,
                                    prompt_buckets=prompt_buckets, background=background)

    @torch.no_grad()
    def _aot_warmup(self, *, decode_chunks=None, admit_sizes=None, prompt_buckets=None,
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
        rid = self._new_rid()
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    def _new_rid(self) -> int:
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        return rid

    @torch.no_grad()
    def _admit(self) -> int:
        """Fill free slots from the queue; one bucketed prefill per
        admission round (requests grouped into the round's max bucket).
        Prefill is synchronous — the host needs the first token to settle
        eos/budget immediately — and its device-state updates are one
        masked write, queued after any in-flight chunk. Returns the number
        of requests admitted."""
        self._refused = False
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
                    self._refused = not batch
                    break  # pool exhausted: retry after sequences finish
                starts.append(0)
            else:
                plan = self._kvmem.admit(req.prompt.tolist(), len(req.prompt) + 1)
                # None: pool exhausted. DEFER_ROUND: the match touches blocks
                # published earlier in THIS round, whose prefill is not
                # queued yet; next round the stream orders the share
                if plan is None or plan is DEFER_ROUND:
                    self._refused = plan is None and not batch
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
        rid = np.full(pad_a, -1, np.int32)
        rid[:A] = [req.rid for _, req in batch]
        tok, lp = self._dispatch_prefill(bucket, slots, tokens, mask, start, rid)
        if self._kvmem is not None:
            # the round's published blocks are now behind a queued prefill:
            # safe for the next round's admissions to share
            self._kvmem.end_round()
        self.prefill_tokens_computed += sum(len(r.prompt) - st for (_, r), st in zip(batch, starts))
        self.prefill_tokens_cached += sum(starts)
        self.prefill_token_slots += A * bucket
        self.prefill_rounds += 1
        tok_host, lp_host = tok.cpu().numpy(), lp.cpu().numpy()
        self.host_transfers += 1
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
        if self.on_admit is not None:
            for _s, req in batch:
                self.on_admit(req.rid)
        if surv.any():
            self._merge(surv, new_lens, new_budget, new_last, new_rid)
        self.prefill_s += time.perf_counter() - t_start
        return A

    def _dispatch_prefill(self, bucket, slots, tokens, mask, start, rid):
        """One bucketed prefill of the rows ``slots`` (pad rows: all-False
        ``mask``, rid -1), through its program with a registry; returns
        the first tokens and log-probs on the device."""
        stream = []  # the slot-stream prefill's rids and base key
        if self.slot_rng:
            stream = [self._upload(rid), self._base_key]
        if self._registry is None:
            keys = (self._slot_keys(stream[1], stream[0], torch.zeros_like(stream[0]))
                    if self.slot_rng else None)
            return self._prefill(
                self.dev_table[self._upload(slots)], self._upload(tokens),
                self._upload(mask), self._upload(start), None, keys,
            )
        args = [self.model, self.dev_table, self._upload(slots), self._upload(tokens),
                self._upload(mask), *stream]
        if self._kvmem is not None:
            args.append(self._upload(start))
        return self._prefill_program(len(slots), bucket)(*args)

    def _merge(self, surv, new_lens, new_budget, new_last, new_rid):
        """The masked merge of the ``surv`` slots into the device decode
        state (one program however many)."""
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
        self.decode_launches += 1
        self.decode_chunk_last = chunk
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
        self.decode_launches += 1
        self.decode_chunk_last = K
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
        self.host_transfers += 1
        self.decode_drains += 1
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
        self.tokens_generated += int(n_emit.sum())
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
        with self._on_stream():
            return self._step()

    def _step(self) -> bool:
        if self.speculative:
            return self._step_spec()
        # if the previous chunk already finished on device, settle it
        # first — admissions and the next launch then see fresh slots
        if self._inflight and self._inflight_ready():
            self._drain_one()
        self._admit()
        launched = self._launch()
        if not launched:
            if self._inflight:
                while self._inflight:
                    self._drain_one()
                self._admit()
                launched = self._launch()
            if not launched:
                # a round whose requests all finished at prefill (or that
                # deferred the rest behind its own publications) leaves
                # nothing to decode: the next step admits again
                if self._refused and not (self.slot_rid >= 0).any():
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
        self._admit()
        if not self._launch_spec():
            if self._refused and not (self.slot_rid >= 0).any():
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

    def metrics_snapshot(self) -> dict:
        """Flat host dict of the engine's telemetry, a superset of
        :meth:`stats` (the reference's keys). No device read:
        ``tokens_generated`` counts the decode tokens the host accepted
        (the reference reads an on-device counter of the same tokens)."""
        snap = self.stats()
        snap.update({
            "tokens_generated": float(self.tokens_generated),
            "decode_launches": self.decode_launches,
            "decode_drains": self.decode_drains,
            "host_transfers": self.host_transfers,
            "prefill_token_slots": self.prefill_token_slots,
            "decode_chunk": self.decode_chunk_last,
            "tuner_k": self._tuner.k if self._tuner is not None else None,
            "queue_depth": len(self.queue),
            "active_slots": int((self.slot_rid >= 0).sum()),
            "pending": self.pending(),
        })
        return snap

    def kv_free_blocks(self) -> int:
        """Sharing-adjusted free capacity for fleet admission: the free
        list plus, with a prefix cache, resident blocks no live sequence
        references."""
        if self._kvmem is not None:
            return self._kvmem.free_adjusted()
        return len(self.free_blocks)

    def kv_admission_probe(self, prompt, max_new_tokens: int = 1):
        """``(shared_len, new_blocks_needed)`` if ``prompt`` were admitted
        now; reads only (nothing allocated, no refs taken)."""
        seq = prompt.tolist() if hasattr(prompt, "tolist") else list(prompt)
        want = len(seq) + max(1, max_new_tokens)
        if self._kvmem is None:
            return 0, self._blocks_needed(want)
        return self._kvmem.probe(seq, want)

    def pending(self) -> int:
        """Outstanding work: queued + live requests."""
        return len(self.queue) + int((self.slot_rid >= 0).sum())

    # -- prefill/decode disaggregation (kv_handoff) ----------------------------

    @torch.no_grad()
    def prefill_detached(self, prompt, max_new_tokens: int) -> KVHandoff | None:
        """Run ONE bucketed prefill and return a :class:`KVHandoff` instead
        of occupying a slot: the written KV blocks are read back to host
        memory, the borrowed blocks return to the free list, and a
        decode-role engine continues through :meth:`adopt_handoff`. The
        prefill is the admission ladder's admit-size-1 rung, so a warmed
        engine hands off without a capture. Returns ``None`` when no slot
        or blocks are free this instant (the caller retries). The host
        copies are complete when it returns."""
        if not self.kv_handoff:
            raise RuntimeError("engine built without kv_handoff=True")
        self._join_warmup()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = len(prompt)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if P + max_new_tokens > self.max_seq_len:
            raise ValueError(f"prompt ({P}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds max_seq_len ({self.max_seq_len})")
        if P > self.buckets[-1]:
            raise ValueError(f"prompt length {P} exceeds the largest prefill "
                             f"bucket {self.buckets[-1]}")
        free = [s for s in range(self.n_slots) if self.slot_rid[s] < 0]
        if not free:
            return None
        s = free[0]
        if not self._ensure_blocks(s, P + 1):
            return None
        blocks = [int(b) for b in self.table[s] if b >= 0]
        bucket = self.shape_buckets.prompt_bucket(P)
        pad_a = self.shape_buckets.admit_bucket(1, self.n_slots)
        tokens = np.zeros((pad_a, bucket), np.int32)
        mask = np.zeros((pad_a, bucket), bool)
        tokens[0, :P] = prompt
        mask[0, :P] = True
        slots = np.zeros(pad_a, np.int64)
        slots[0] = s
        rid = self._new_rid()
        rid_v = np.full(pad_a, -1, np.int32)
        rid_v[0] = rid
        with self._on_stream():
            self._flush_table_writes()
            tok, lp = self._dispatch_prefill(bucket, slots, tokens, mask,
                                             np.zeros(pad_a, np.int32), rid_v)
            self.admissions += 1
            self.prefill_rounds += 1
            self.prefill_token_slots += pad_a * bucket
            self.prefill_tokens_computed += P
            t0, l0 = int(tok[0].item()), float(lp[0].item())
            self.host_transfers += 1
            budget = max_new_tokens - 1
            hit_eos = self.eos_id is not None and t0 == self.eos_id
            kv: tuple = ()
            if not hit_eos and budget > 0:
                # a device-to-pageable copy waits for the stream, so the
                # host arrays are whole when the handoff is returned
                idx = self._upload(np.asarray(blocks, np.int64))
                kv = tuple(tuple(_host_array(buf[idx].cpu()) for buf in bufs)
                           for bufs in self.pools)
                self.host_transfers += 1
        # the borrowed slot returns at once: the handoff owns host copies
        self.free_blocks.extend(blocks)
        self.table[s] = -1
        if hit_eos or budget <= 0:
            reason = "eos" if hit_eos else "length"
            self.completions[reason] = self.completions.get(reason, 0) + 1
            fin = FinishedRequest(rid=rid, prompt=prompt, tokens=np.asarray([t0], np.int32),
                                  log_probs=np.asarray([l0], np.float32),
                                  finished_reason=reason)
            return KVHandoff(prompt=prompt, first_token=t0, first_lp=l0, budget=0, lens=P,
                             block_size=self.block, finished=fin)
        return KVHandoff(prompt=prompt, first_token=t0, first_lp=l0, budget=budget, lens=P,
                         block_size=self.block, kv=kv)

    @torch.no_grad()
    def adopt_handoff(self, ho: KVHandoff) -> int | None:
        """Adopt a :class:`KVHandoff` (this package's or the reference's):
        take a slot and fresh blocks, scatter the handed-off KV into this
        engine's pools and join the slot through the admission merge;
        decode continues from the first token as if the prefill had run
        here. The scatter is queued before any later decode chunk. Returns
        the engine rid, or ``None`` when no slot or blocks are free this
        instant. ``on_admit`` is not fired (the caller records the
        handoff's first token)."""
        if not self.kv_handoff:
            raise RuntimeError("engine built without kv_handoff=True")
        if ho.finished is not None:
            raise ValueError("handoff already finished; nothing to adopt")
        if ho.block_size != self.block:
            raise ValueError(f"handoff block_size {ho.block_size} != engine block size "
                             f"{self.block}")
        if len(ho.kv) != len(self.pools) or any(len(h) != len(b)
                                                  for h, b in zip(ho.kv, self.pools)):
            raise ValueError("handoff layers or pool fields differ from this engine's")
        self._join_warmup()
        n = len(ho.kv[0][0])
        free = [s for s in range(self.n_slots) if self.slot_rid[s] < 0]
        if not free or n > len(self.free_blocks):
            return None
        s = free[0]
        blocks = [self.free_blocks.pop() for _ in range(n)]
        for j, b in enumerate(blocks):
            self.table[s, j] = b
            self._pending_table_writes.append((s, j, b))
        rid = self._new_rid()
        P = int(ho.lens)
        self.slot_rid[s] = rid
        self.slot_prompt[rid] = np.asarray(ho.prompt, np.int32)
        self.slot_tokens[s] = [np.asarray([ho.first_token], np.int32)]
        self.slot_lps[s] = [np.asarray([ho.first_lp], np.float32)]
        self.lens[s] = self.sched_lens[s] = P
        self.slot_budget[s] = self.sched_budget[s] = ho.budget
        self.admissions += 1
        surv = np.zeros(self.n_slots, bool)
        surv[s] = True
        new_lens, new_budget, new_last, new_rid = (np.zeros(self.n_slots, np.int32)
                                                   for _ in range(4))
        new_lens[s], new_budget[s], new_last[s], new_rid[s] = P, ho.budget, ho.first_token, rid
        with self._on_stream():
            idx = self._upload(np.asarray(blocks, np.int64))
            for bufs, fields in zip(self.pools, ho.kv):
                for buf, host in zip(bufs, fields):
                    buf[idx] = self._upload_tensor(_host_tensor(host, buf.dtype))
            self._flush_table_writes()
            self._merge(surv, new_lens, new_budget, new_last, new_rid)
        return rid

    @torch.no_grad()
    def load_weights(self, model: Any) -> None:
        """Copy ``model``'s weights into the engine's own model in place,
        cast to its dtype (the fleet's weight push; the reference's
        ``eng.params = params`` while requests are live). Queued on the engine's stream, so a
        chunk already queued reads the old weights whole and the next
        one the new; the captured graphs, which read the engine's model,
        stay valid. The caller's stream waits for the copies, so it may
        write ``model`` again right after."""
        self._join_warmup()
        if model is self.model:
            return
        if dataclasses.replace(model.cfg, dtype=self.model.cfg.dtype) != self.model.cfg:
            raise ValueError("load_weights: the new model's config differs (but for dtype)")
        src = dict(model.state_dict(keep_vars=True))
        dst = dict(self.model.state_dict(keep_vars=True))
        if src.keys() != dst.keys():
            raise ValueError("load_weights: the models' tensors differ")
        caller = torch.cuda.current_stream(self.device) if self._cuda else None
        with self._on_stream():
            torch._foreach_copy_([dst[k] for k in dst], [src[k] for k in dst])
            if caller is not None and self._stream is not None:
                caller.wait_stream(self._stream)

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
        if self._stream is not None:
            # the new model's weights may still be written on the caller's
            # stream; this engine reads them on its own
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.queue or self._inflight or (self.slot_rid >= 0).any():
            raise RuntimeError("set_model: requests are still queued, live or in flight")
        self.model = model

    def reset(self) -> None:
        """Return the engine to an empty state IN PLACE: every slot freed,
        every block back in the pool, the prefix tree dropped,
        queue/finished/in-flight dropped. The pools (stale contents are
        unreachable once every table row is cleared), the generator and
        the monotone counters survive. It first waits for the engine's
        queued device work (a chunk in flight still writes the blocks
        this frees), so a fleet may reset a crashed member from another
        thread."""
        self._join_warmup()
        self.synchronize()
        with self._on_stream():
            self._reset()

    def _reset(self) -> None:
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


class LoadBalancer:
    """Route requests across engine replicas with a strategy hierarchy
    (counterpart of the reference's ``LoadBalancer``, a copy of it: host
    code over :class:`ContinuousBatchingEngine` instances).

    Strategies, tried in order until one yields a pick:

    - ``"prefix-aware"``: hash the prompt's first ``prefix_length`` tokens
      to a replica (KV/prefix cache locality) — skipped when the chosen
      replica is overloaded (> ``overload_threshold`` x mean load, with
      the mean FLOORED AT 1.0 so single stray requests at near-idle
      traffic don't defeat stickiness) or no prompt is given;
    - ``"requests"``: fewest pending requests (queue + in-flight);
    - ``"kv-cache"``: lowest KV block-pool utilization;
    - ``"round-robin"``: next index.

    ``submit`` forwards to the chosen replica and returns
    ``(replica_index, rid)``; ``run_all`` drains every replica.

    Membership may change at runtime (the fleet swaps ``engines`` as
    replicas sicken and recover). Losing the LAST engine is a degraded
    service, not a programming error: ``select_engine``/``submit`` on an
    empty replica set raise :class:`ServiceSaturated` with
    ``retry_after_s``, an explicit shed the routing thread survives.
    Constructing with zero engines still raises unless ``allow_empty``.
    """

    STRATEGIES = ("prefix-aware", "requests", "kv-cache", "round-robin")

    def __init__(
        self,
        engines,
        strategy="prefix-aware",
        prefix_length: int = 8,
        overload_threshold: float = 1.5,
        retry_after_s: float = 0.25,
        allow_empty: bool = False,
    ):
        self.engines = list(engines)
        if not self.engines and not allow_empty:
            raise ValueError("LoadBalancer needs at least one engine")
        self.retry_after_s = retry_after_s
        strategies = [strategy] if isinstance(strategy, str) else list(strategy)
        for st in strategies:
            if st not in self.STRATEGIES:
                raise ValueError(f"unknown strategy {st!r}; want one of {self.STRATEGIES}")
        # round-robin is the unconditional terminal fallback
        if "round-robin" not in strategies:
            strategies.append("round-robin")
        self.strategies = strategies
        self.prefix_length = prefix_length
        self.overload_threshold = overload_threshold
        self._rr = 0

    # -- per-replica load signals ---------------------------------------------

    def _pending(self, eng) -> int:
        return eng.pending()

    def _kv_utilization(self, eng) -> float:
        # O(1) from the engine's free-list accounting (select_engine runs
        # per submit). Prefix-cache engines report sharing-ADJUSTED free
        # capacity, so a pool full of reusable prefixes is not pressure
        probe = getattr(eng, "kv_free_blocks", None)
        free = probe() if probe is not None else len(eng.free_blocks)
        used = eng._n_pool_blocks - free
        return used / max(eng._n_pool_blocks, 1)

    # -- selection -------------------------------------------------------------

    def select_engine(self, prompt=None) -> int:
        if not self.engines:
            raise ServiceSaturated(self.retry_after_s)
        loads = [self._pending(e) for e in self.engines]
        mean_load = sum(loads) / len(loads)
        for st in self.strategies:
            if st == "prefix-aware":
                if prompt is None:
                    continue
                prefix = tuple(np.asarray(prompt).reshape(-1)[: self.prefix_length].tolist())
                idx = hash(prefix) % len(self.engines)
                if loads[idx] <= self.overload_threshold * max(mean_load, 1.0):
                    return idx
                continue  # overloaded: fall through to the next strategy
            if st == "requests":
                return int(np.argmin(loads))
            if st == "kv-cache":
                return int(np.argmin([self._kv_utilization(e) for e in self.engines]))
            if st == "round-robin":
                idx = self._rr % len(self.engines)
                self._rr += 1
                return idx
        raise AssertionError("unreachable: round-robin always selects")

    # -- request surface --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> tuple[int, int]:
        idx = self.select_engine(prompt)
        return idx, self.engines[idx].submit(prompt, max_new_tokens)

    def run_all(self) -> dict[tuple[int, int], FinishedRequest]:
        """Drain every replica; keys are (replica_index, rid)."""
        out = {}
        for i, eng in enumerate(self.engines):
            for rid, f in eng.run().items():
                out[(i, rid)] = f
        return out


class ServingService:
    """The engine behind a TCP endpoint (counterpart of the reference's
    ``ServingService``): the transport is the line-delimited JSON control
    plane of :class:`rl_tpu_torch.comm.TCPCommandServer`, the reference's
    wire, so a reference :class:`RemoteEngine` talks to it and the
    reverse.

    A background thread drives ``engine.step()`` whenever work is
    pending; handlers and the stepper share one lock (the engine is not
    thread-safe). Commands:

    - ``submit`` {"prompt": [ids], "max_new_tokens": n} -> rid
    - ``collect`` -> {rid: {"tokens": [...], "log_probs": [...],
      "finished_reason": ...}} — finished since the last collect
    - ``stats`` -> {"pending": ..., "free_blocks": ..., "decode_steps": ...}

    Alongside the command port, a stdlib HTTP server exposes the engine's
    telemetry as Prometheus text on ``GET /metrics`` (``metrics_port=0``
    binds an ephemeral port, read back from ``metrics_address``; ``None``
    disables it). The service owns its registry by default so replica
    services never cross-publish.

    Resilience: ``max_queue`` caps admission — a submit past the cap gets
    an explicit ``{"saturated": true, "retry_after": s}`` shed reply
    instead of silently deepening the queue (clients back off and retry);
    passing a ``supervisor`` (:class:`rl_tpu_torch.resilience.Supervisor`)
    puts the stepper thread under supervision, so an engine crash restarts
    the stepper within budget instead of wedging the service. The stepper
    passes the ``serving.stepper`` chaos site each iteration.
    """

    def __init__(self, engine: ContinuousBatchingEngine, host: str = "127.0.0.1",
                 port: int = 0, metrics_port: int | None = 0, registry=None,
                 max_queue: int | None = None, retry_after_s: float = 0.25,
                 supervisor=None):
        from ..comm import TCPCommandServer

        self.engine = engine
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        self._supervisor = supervisor
        self._stepper_child = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._done: dict[int, FinishedRequest] = {}
        self._error: str | None = None  # fatal stepper error, surfaced to clients
        self._server = TCPCommandServer(host=host, port=port)
        self._server.register_handler("submit", self._h_submit)
        self._server.register_handler("collect", self._h_collect)
        self._server.register_handler("stats", self._h_stats)
        from ..obs.trace import carry_context

        self._thread = threading.Thread(target=carry_context(self._loop), daemon=True)
        self._metrics_server = None
        self.registry = registry
        if metrics_port is not None:
            from ..obs import MetricsHTTPServer, MetricsRegistry

            if self.registry is None:
                self.registry = MetricsRegistry()
            # the sidecar also serves /healthz and /debug/state (the
            # engine's snapshot, bounded)
            self._metrics_server = MetricsHTTPServer(
                self.registry, host=host, port=metrics_port,
                state_fn=self._debug_state,
            )
        if self.registry is not None:
            self._init_metrics(self.registry)

    def _debug_state(self) -> dict:
        """``GET /debug/state`` payload: the engine snapshot plus the
        service-side queue view — the first thing to curl on a replica
        that is scraping fine but serving slowly."""
        with self._lock:
            snap = self.engine.metrics_snapshot()
            done = len(self._done)
            error = self._error
        return {"engine": snap, "finished_unclaimed": done, "error": error}

    def _init_metrics(self, reg):
        p = "rl_tpu_serving"
        self._m_tokens = reg.counter(f"{p}_tokens_total", "decode tokens generated")
        self._m_counters = {
            name: reg.counter(f"{p}_{name}_total", help_)
            for name, help_ in (
                ("decode_steps", "decode steps dispatched"),
                ("decode_launches", "decode chunk launches"),
                ("decode_drains", "decode chunk drains"),
                ("host_transfers", "blocking device->host transfers"),
                ("prefill_token_slots", "prefill token-slots computed"),
                ("admissions", "requests admitted to slots"),
            )
        }
        self._m_completions = reg.counter(
            f"{p}_completions_total", "finished requests", labels=("reason",)
        )
        self._m_shed = reg.counter(
            f"{p}_shed_total", "submits shed with retry-after (queue saturated)"
        )
        self._m_kv_cow = reg.counter(
            f"{p}_kv_cow_copies_total", "copy-on-write KV block forks"
        )
        self._m_kv_evictions = reg.counter(
            f"{p}_kv_evictions_total", "prefix-cache blocks evicted",
            labels=("reason",),
        )
        self._m_gauges = {
            name: reg.gauge(f"{p}_{name}", help_)
            for name, help_ in (
                ("kv_utilization", "fraction of KV pool blocks in use"),
                ("kv_prefix_hit_rate", "prompt tokens served from the prefix cache"),
                ("kv_shared_blocks", "resident KV blocks referenced by live sequences"),
                ("queue_depth", "requests waiting for a slot"),
                ("active_slots", "slots decoding"),
                ("pending", "queued + in-flight requests"),
                ("decode_chunk", "last decode chunk size K"),
                ("tuner_k", "chunk auto-tuner's current K"),
                ("tokens_per_second", "decode throughput since last scrape"),
                ("spec_accept_ema", "accepted tokens per verify dispatch (EMA)"),
                ("spec_draft_hit_rate", "draft-source queries that proposed"),
            )
        }
        self._m_spec = {
            name: reg.counter(f"{p}_{name}_total", help_)
            for name, help_ in (
                ("spec_dispatches", "speculative verify dispatches"),
                ("spec_draft_tokens", "tokens proposed by the draft source"),
                ("spec_accepted_tokens", "drafted tokens accepted by verify"),
            )
        }
        self._m_spec_accepted = reg.histogram(
            f"{p}_spec_accepted_per_dispatch",
            "tokens emitted per verify dispatch (chain length incl. bonus)",
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0),
        )
        self._spec_counts_seen: dict[int, int] = {}
        self._tps_last: tuple[float, float] | None = None
        reg.register_collector(self._update_metrics)

    def _update_metrics(self):
        with self._lock:
            snap = self.engine.metrics_snapshot()
        for name, c in self._m_counters.items():
            c.set_total(snap[name])
        self._m_tokens.set_total(snap["tokens_generated"])
        self._m_completions.set_total(snap["completions_eos"], {"reason": "eos"})
        self._m_completions.set_total(snap["completions_length"], {"reason": "length"})
        for name in ("kv_utilization", "queue_depth", "active_slots", "pending",
                     "decode_chunk"):
            self._m_gauges[name].set(float(snap[name]))
        if "kv_prefix_hit_rate" in snap:  # engine runs the prefix tier
            self._m_gauges["kv_prefix_hit_rate"].set(float(snap["kv_prefix_hit_rate"]))
            self._m_gauges["kv_shared_blocks"].set(float(snap["kv_shared_blocks"]))
            self._m_kv_cow.set_total(snap["kv_cow_copies_total"])
            for reason, n in snap["kv_evictions"].items():
                self._m_kv_evictions.set_total(n, {"reason": reason})
        if snap["tuner_k"] is not None:
            self._m_gauges["tuner_k"].set(float(snap["tuner_k"]))
        if "spec_dispatches" in snap:  # engine runs speculative decoding
            for name, c in self._m_spec.items():
                c.set_total(snap[name])
            self._m_gauges["spec_accept_ema"].set(float(snap["spec_accept_ema"]))
            self._m_gauges["spec_draft_hit_rate"].set(
                float(snap.get("spec_draft_hit_rate", 0.0))
            )
            # the engine keeps {chain length -> dispatch count}; observe
            # only the delta since the last scrape
            for n, total in snap["spec_accept_counts"].items():
                seen = self._spec_counts_seen.get(n, 0)
                for _ in range(total - seen):
                    self._m_spec_accepted.observe(float(n))
                self._spec_counts_seen[n] = total
        now = time.monotonic()
        if self._tps_last is not None:
            t0, tok0 = self._tps_last
            dt = now - t0
            if dt > 0:
                self._m_gauges["tokens_per_second"].set(
                    (snap["tokens_generated"] - tok0) / dt
                )
        self._tps_last = (now, snap["tokens_generated"])

    # -- lifecycle -------------------------------------------------------------

    @property
    def address(self):
        return self._server.address

    @property
    def metrics_address(self):
        if self._metrics_server is None:
            return None
        return self._metrics_server.address

    def start(self) -> "ServingService":
        self._server.start()
        if self._supervisor is not None:
            self._stepper_child = self._supervisor.spawn(
                "serving-stepper", self._loop_supervised,
                on_giveup=self._on_stepper_giveup,
            )
        else:
            self._thread.start()
        if self._metrics_server is not None:
            self._metrics_server.start(supervisor=self._supervisor)
        return self

    def shutdown(self):
        self._stop.set()
        if self._stepper_child is not None:
            self._stepper_child.stop(timeout=10)
        else:
            self._thread.join(timeout=10)
        self._server.shutdown()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
        if self.registry is not None:
            self.registry.unregister_collector(self._update_metrics)

    # -- stepper ---------------------------------------------------------------

    def _loop(self):
        import time as _time
        import traceback as _tb

        from ..resilience.faults import fault_point

        while not self._stop.is_set():
            fault_point("serving.stepper")  # chaos site, outside the lock
            with self._lock:
                busy = self.engine.pending() > 0
                if busy:
                    try:
                        self.engine.step()
                    except Exception:
                        # a dead stepper must not look like a healthy
                        # service: record and refuse further work
                        self._error = _tb.format_exc(limit=5)
                        return
                    self._done.update(
                        {f.rid: f for f in self.engine.finished}
                    )
                    self.engine.finished.clear()
            if not busy:
                _time.sleep(0.005)

    def _loop_supervised(self):
        """Supervised variant: let exceptions escape so the supervisor
        restarts the stepper instead of recording-and-wedging."""
        import time as _time

        from ..resilience.faults import fault_point

        while not self._stop.is_set():
            fault_point("serving.stepper")
            with self._lock:
                busy = self.engine.pending() > 0
                if busy:
                    self.engine.step()
                    self._done.update({f.rid: f for f in self.engine.finished})
                    self.engine.finished.clear()
            if not busy:
                _time.sleep(0.005)

    def _on_stepper_giveup(self, exc: BaseException) -> None:
        import traceback as _tb

        self._error = "".join(
            _tb.format_exception(type(exc), exc, exc.__traceback__, limit=5)
        )

    # -- handlers --------------------------------------------------------------

    def _h_submit(self, payload):
        with self._lock:
            if self._error is not None:
                raise RuntimeError(f"serving stepper died:\n{self._error}")
            if self.max_queue is not None and self.engine.pending() >= self.max_queue:
                # shed, don't hang: an explicit retry-after beats a queue
                # that grows until every caller times out
                if getattr(self, "_m_shed", None) is not None:
                    self._m_shed.inc()
                from ..obs import get_tracer

                get_tracer().instant(
                    "load_shed",
                    {"pending": self.engine.pending(), "max_queue": self.max_queue},
                )
                return {"saturated": True, "retry_after": self.retry_after_s}
            return self.engine.submit(
                np.asarray(payload["prompt"], np.int32),
                int(payload["max_new_tokens"]),
            )

    def _h_collect(self, payload):
        """Return (and remove) finished requests. ``payload`` may carry
        {"rids": [...]} to take ONLY those — concurrent waiters must not
        drain each other's results; with no rids, takes everything."""
        with self._lock:
            if self._error is not None and not self._done:
                raise RuntimeError(f"serving stepper died:\n{self._error}")
            want = payload.get("rids") if isinstance(payload, dict) else None
            rids = list(self._done) if want is None else [
                r for r in map(int, want) if r in self._done
            ]
            out = {
                str(rid): {
                    "tokens": self._done[rid].tokens.tolist(),
                    "log_probs": self._done[rid].log_probs.tolist(),
                    "finished_reason": self._done[rid].finished_reason,
                }
                for rid in rids
            }
            for rid in rids:
                del self._done[rid]
        return out

    def _h_stats(self, _payload):
        with self._lock:
            return {
                "pending": self.engine.pending(),
                "free_blocks": len(self.engine.free_blocks),
                "decode_steps": self.engine.decode_steps,
                "error": self._error,
            }


class ServiceSaturated(RuntimeError):
    """The service shed the submit; retry after ``retry_after`` seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"service saturated, retry after {retry_after}s")
        self.retry_after = retry_after


class RemoteEngine:
    """Client for :class:`ServingService`: the same submit surface over
    TCP (counterpart of the reference's ``RemoteEngine``, a copy of it).

    ``retry`` (a :class:`rl_tpu_torch.resilience.RetryPolicy`) makes the
    transport survivable. ``submit`` is NOT transport-idempotent (a dropped
    reply would re-enqueue the prompt), so it never retries on transport
    errors — but it DOES honor the service's explicit shed replies:
    ``max_shed_retries`` waits ``retry_after`` and resubmits (the shed
    reply proves the request was rejected, so resubmitting is safe).
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0, retry=None,
                 max_shed_retries: int = 8):
        from ..comm import TCPCommandClient

        self._client = TCPCommandClient(host, port, timeout=timeout, retry=retry)
        self._retry = retry
        self.max_shed_retries = max_shed_retries

    def submit(self, prompt, max_new_tokens: int) -> int:
        import time as _time

        payload = {"prompt": np.asarray(prompt, np.int32).tolist(),
                   "max_new_tokens": int(max_new_tokens)}
        for _ in range(self.max_shed_retries + 1):
            out = self._client.call("submit", payload, idempotent=False)
            if isinstance(out, dict) and out.get("saturated"):
                retry_after = float(out.get("retry_after", 0.25))
                _time.sleep(retry_after)
                continue
            return int(out)
        raise ServiceSaturated(retry_after)

    def collect(self, rids=None) -> dict[int, dict]:
        # collect REMOVES results server-side: a reply dropped after the
        # handler ran loses them for good, so never auto-retry it
        payload = None if rids is None else {"rids": [int(r) for r in rids]}
        return {
            int(k): v
            for k, v in self._client.call("collect", payload, idempotent=False).items()
        }

    def stats(self) -> dict:
        return self._client.call("stats")

    def wait_all(self, rids, poll_s: float = 0.05, timeout: float = 120.0) -> dict:
        """Poll ``collect`` until every rid finished. The poll interval
        doubles from ``poll_s`` up to a 1 s cap (long generations don't
        deserve a 50 ms busy-poll), charged against one shared deadline."""
        import time as _time

        from ..resilience.retry import Deadline

        dl = (
            self._retry.deadline(timeout)
            if self._retry is not None
            else Deadline(timeout)
        )
        want = set(rids)
        got: dict[int, dict] = {}
        delay = poll_s
        while want - set(got) and not dl.expired:
            got.update(self.collect(sorted(want - set(got))))
            if want - set(got):
                _time.sleep(min(delay, max(dl.remaining(), 0.0)))
                delay = min(delay * 2.0, 1.0)
        missing = want - set(got)
        if missing:
            raise TimeoutError(f"requests {sorted(missing)} not finished in {timeout}s")
        return {r: got[r] for r in want}
