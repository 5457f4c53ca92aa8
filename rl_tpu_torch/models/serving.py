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

Left for later slices: the prefix cache (``kvmem``), speculative decoding
and per-slot RNG streams, KV handoff, the program registry and AOT
warm-up, tracing and metrics, parameter sharding, and the load balancer,
service and fleet layers.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..compile import ShapeBuckets, pow2ceil
from .speculative import sample_tokens

__all__ = ["ContinuousBatchingEngine", "FinishedRequest", "Request"]


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
    ):
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

        cache = model.init_paged_cache(n_slots, n_blocks, block_size, self.max_blocks)
        self.pools = [(c["pool_k"], c["pool_v"]) for c in cache]
        # host mirrors (the allocator's source of truth)
        self.free_blocks = list(range(1, n_blocks))  # 0 = reserved scratch
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
        self._dev_all_slots = torch.ones(n_slots, dtype=torch.bool, device=dev)
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
            {"pool_k": pk, "pool_v": pv, "block_table": table, "len": lens,
             "active": active}
            for pk, pv in self.pools
        ]

    def _sample(self, logits):
        """(token, behavior log-prob of that token) per row: the shared
        sampling rule, through the fused-sampling kernel on CUDA."""
        return sample_tokens(
            logits, self._gen, temperature=self.temperature, greedy=self.greedy
        )

    def _prefill(self, table_rows, tokens, token_mask):
        """COMPACT bucketed prefill: only the admitted slots' rows ride
        the forward — tokens [A, B] (pads beyond each prompt), token_mask
        [A, B] marks real prompt tokens, table_rows [A, max_blocks] are the
        admitted slots' block tables. The pools are shared with the decode
        cache, so the writes land in place. Samples each admitted slot's
        FIRST response token."""
        A = tokens.shape[0]
        cache = self._caches(
            table_rows, torch.zeros(A, dtype=torch.int32, device=self.device), token_mask
        )
        logits, _ = self.model(tokens, cache=cache)
        last = (token_mask.sum(dim=1) - 1).clamp_min(0)  # [A]
        last_logits = logits[torch.arange(A, device=self.device), last]
        return self._sample(last_logits)

    def _decode_chunk(self, chunk, run_mask):
        """K decode steps with the per-slot stop rule applied ON DEVICE:
        an active slot decrements its budget each step and deactivates
        itself when it samples eos or runs out; inactive slots write to
        scratch and freeze their length. No step reads a value back to the
        host. Returns tokens/log-probs [S, K] (device) and advances the
        engine's device state."""
        S = self.n_slots
        toks = torch.empty((S, chunk), dtype=torch.int32, device=self.device)
        lps = torch.empty((S, chunk), dtype=torch.float32, device=self.device)
        table = self.dev_table
        lens, active = self.dev_lens, self.dev_active
        budget, last = self.dev_budget, self.dev_last
        for k in range(chunk):
            eff = active & run_mask
            logits, cache = self.model(
                last[:, None], cache=self._caches(table, lens, eff)
            )
            tok, lp = self._sample(logits[:, 0])
            lens = cache[0]["len"]
            budget = budget - eff.to(budget.dtype)
            stop = budget <= 0
            if self.eos_id is not None:
                stop = stop | (tok == self.eos_id)
            active = active & ~(stop & eff)
            last = torch.where(eff, tok, last)
            toks[:, k] = tok
            lps[:, k] = lp
        self.dev_lens, self.dev_active = lens, active
        self.dev_budget, self.dev_last = budget, last
        return toks, lps

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
    def _admit(self):
        """Fill free slots from the queue; one bucketed prefill per
        admission round (requests grouped into the round's max bucket).
        Prefill is synchronous — the host needs the first token to settle
        eos/budget immediately — and its device-state updates are one
        masked write, queued after any in-flight chunk."""
        free = [s for s in range(self.n_slots) if self.slot_rid[s] < 0]
        if not free or not self.queue:
            return
        t_start = time.perf_counter()
        batch: list[tuple[int, Request]] = []
        for s in free:
            if not self.queue:
                break
            req = self.queue[0]
            if not self._ensure_blocks(s, len(req.prompt) + 1):
                break  # pool exhausted: retry after sequences finish
            batch.append((s, self.queue.pop(0)))
        if not batch:
            return
        bucket = self.shape_buckets.prompt_bucket(max(len(r.prompt) for _, r in batch))
        A = len(batch)
        self.admissions += A
        # pad rows carry an all-False token mask, so their writes go to the
        # reserved scratch block and the host never reads their rows
        pad_a = self.shape_buckets.admit_bucket(A, self.n_slots)
        tokens = np.zeros((pad_a, bucket), np.int32)
        mask = np.zeros((pad_a, bucket), bool)
        for i, (s, req) in enumerate(batch):
            P = len(req.prompt)
            tokens[i, :P] = req.prompt
            mask[i, :P] = True
            self.slot_rid[s] = req.rid
            self.slot_prompt[req.rid] = req.prompt
            self.slot_tokens[s] = []
            self.slot_lps[s] = []
        # pad rows gather slot 0's table row — harmless, since an inactive
        # row never writes through its table and its reads are discarded
        slots = np.zeros(pad_a, np.int64)
        slots[:A] = [s for s, _ in batch]
        self._flush_table_writes()  # prefill reads the new rows on device
        tok, lp = self._prefill(
            self.dev_table[self._upload(slots)], self._upload(tokens), self._upload(mask)
        )
        self.prefill_rounds += 1
        tok_host, lp_host = tok.cpu().numpy(), lp.cpu().numpy()
        surv = np.zeros(self.n_slots, bool)
        new_lens = np.zeros(self.n_slots, np.int32)
        new_budget = np.zeros(self.n_slots, np.int32)
        new_last = np.zeros(self.n_slots, np.int32)
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
                new_lens[s], new_budget[s], new_last[s] = P, b, t0
        if surv.any():
            m = self._upload(surv)
            self.dev_lens = torch.where(m, self._upload(new_lens), self.dev_lens)
            self.dev_active = self.dev_active | m
            self.dev_budget = torch.where(m, self._upload(new_budget), self.dev_budget)
            self.dev_last = torch.where(m, self._upload(new_last), self.dev_last)
        self.prefill_s += time.perf_counter() - t_start

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
        # start the device->host copy now; the drain only waits for it
        if self._cuda:
            toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            lps_h = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
            toks_h.copy_(toks, non_blocking=True)
            lps_h.copy_(lps, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            toks_h, lps_h, done = toks, lps, None
        dispatch_s = time.perf_counter() - t0
        want = np.minimum(chunk, self.sched_budget) * run
        self.sched_lens += want
        self.sched_budget -= want
        self._inflight.append(
            _InFlight(toks_h, lps_h, done, self.slot_rid.copy(), run.copy(), chunk, dispatch_s)
        )
        self.decode_steps += chunk
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
        if self.eos_id is None:
            eos_pos = np.full(self.n_slots, K, np.int64)
        else:
            is_eos = tok == self.eos_id
            has = is_eos.any(axis=1)
            eos_pos = np.where(has, is_eos.argmax(axis=1), K)
        n_emit = np.minimum(np.minimum(eos_pos + 1, self.slot_budget), K)
        n_emit = np.where(valid, n_emit, 0)
        self.lens += n_emit
        self.slot_budget -= n_emit
        for s in map(int, np.nonzero(n_emit)[0]):
            n = int(n_emit[s])
            self.slot_tokens[s].append(tok[s, :n])
            self.slot_lps[s].append(lp[s, :n])
        fin_eos = valid & (eos_pos < n_emit)
        fin_len = valid & ~fin_eos & (self.slot_budget <= 0)
        for s in map(int, np.nonzero(fin_eos)[0]):
            self._free_slot(s, "eos")
        for s in map(int, np.nonzero(fin_len)[0]):
            self._free_slot(s, "length")
        if self._tuner is not None:
            host_s = (time.perf_counter() - t1) + fl.dispatch_s
            self._tuner.observe(host_s, wait_s, K)

    def _inflight_ready(self) -> bool:
        done = self._inflight[0].done
        return done is None or done.query()

    def step(self) -> bool:
        """Admit + dispatch one decode chunk, then accept the PREVIOUS
        chunk's tokens while the new one runs (double buffering). Returns
        False when all work is done."""
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
                if self.queue and not (self.slot_rid >= 0).any():
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

    def reset(self) -> None:
        """Return the engine to an empty state IN PLACE: every slot freed,
        every block back in the pool, queue/finished/in-flight dropped. The
        pools (stale contents are unreachable once every table row is
        cleared), the generator and the monotone counters survive."""
        n = self.n_slots
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
        self._pending_table_writes.clear()
        self._inflight.clear()
        self.queue.clear()
        self.finished.clear()
