"""Copy-on-write paged KV allocation over the prefix tree (a copy of
:mod:`rl_tpu.kvmem.allocator`).

:class:`PrefixKVAllocator` owns the engine's free-block list and the
:class:`~rl_tpu_torch.kvmem.radix.PrefixTree`, and turns them into the
prefix-aware admission protocol the serving engine speaks:

- :meth:`admit` — match a prompt against the tree, take refs on the
  shared whole-block chain, fork a copy-on-write block when the match
  ends mid-block, allocate the private remainder (evicting LRU
  unreferenced blocks under pressure), and PUBLISH the prompt's private
  blocks as new tree nodes so the next identical/extending prompt shares
  them.  A request is charged only the blocks it actually adds.
- :meth:`alloc` — private blocks for decode growth, same eviction path.
- :meth:`release` — end of a sequence: extend the owned tail node over
  the generated tokens (multi-turn reuse), donate the generated blocks
  to the tree as ``refs == 0`` nodes, drop the lease's refs, free the
  rest.
- :meth:`draft` — up to k continuation tokens of a context read from
  the tree, the speculative decoder's drafts (counted in ``stats()`` as
  ``kv_draft_*``).
- :meth:`free_adjusted` — sharing-adjusted free capacity:
  ``len(free) + reclaimable`` (a resident block nobody references is one
  eviction away from free).

Why publishing at ADMISSION is safe: the published blocks' K/V is
written by the same round's prefill, and the engine queues every later
reader (the next round's copy-on-write copies and prefills, every decode
step) on the same CUDA stream after it, so the stream's order makes
next-round readers see the writes without any host sync.  The one
hazard is a reader admitted in the SAME round (its copy-on-write copy
would read the block before the writes): :meth:`admit` returns
:data:`DEFER_ROUND` for such requests and the engine re-tries them next
round.

Eviction is a sequence of single-block steps, each of which leaves the
refcounts and the free list consistent.  The reference's tracer events
and fault-injection points on the eviction path have no counterpart yet
(the port has neither a tracer nor a fault injector).
"""

from __future__ import annotations

import dataclasses
import threading

from .radix import PrefixTree

__all__ = ["AdmitPlan", "PrefixKVAllocator", "DEFER_ROUND"]


class _DeferRound:
    """Sentinel: the prompt's match touches blocks published THIS
    admission round (their prefill has not been queued yet) — admit it
    next round, when stream order puts the writes before any read."""

    __slots__ = ()

    def __repr__(self):
        return "DEFER_ROUND"


DEFER_ROUND = _DeferRound()


@dataclasses.dataclass
class AdmitPlan:
    """Everything an admission resolved, atomically, under the lock."""

    lease: int  # handle for release()
    shared_len: int  # prompt tokens served from the cache (suffix starts here)
    blocks: list  # table-row block ids in slot order: shared chain + private
    cow: tuple | None  # (src_block, dst_block) device copy to schedule
    n_shared: int  # leading entries of ``blocks`` owned by the tree


class _Lease:
    __slots__ = ("nodes", "pubs")

    def __init__(self, nodes, pubs):
        self.nodes = nodes  # every node this sequence holds a ref on
        self.pubs = pubs  # the subset it published (and may extend)


class PrefixKVAllocator:
    """Host-side prefix-aware block allocator (one per engine).

    ``free_blocks`` is a plain list the engine aliases directly; the
    allocator mutates it only in place.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.block = block_size
        self.n_blocks = n_blocks
        self.free_blocks = list(range(1, n_blocks))  # block 0 = engine scratch
        self.tree = PrefixTree(block_size)
        self._lock = threading.Lock()
        self._lent: set = set()  # blocks held privately by slot tables
        self._leases: dict = {}
        self._next_lease = 0
        self._round_pending: set = set()  # id(node) published this round
        # telemetry (read under the lock via stats())
        self.hits = 0
        self.misses = 0
        self.exact_hits = 0
        self.tokens_cached = 0
        self.tokens_computed = 0
        self.cow_copies = 0
        self.blocks_charged = 0
        self.draft_hits = 0
        self.draft_misses = 0
        self.draft_tokens = 0
        self.evictions: dict = {}

    # -- admission -------------------------------------------------------------

    def admit(self, tokens, want_len: int):
        """Resolve one admission: returns an :class:`AdmitPlan`, ``None``
        when the pool (even after eviction) cannot cover the new blocks,
        or :data:`DEFER_ROUND` when the match touches this round's
        still-unqueued blocks.  ``want_len`` is the table coverage the
        engine needs now (prompt + 1 for the first decode token)."""
        t = tuple(tokens)
        P = len(t)
        block = self.block
        with self._lock:
            chain, cow_node, cow_lcp, exact = self.tree.match(t)
            if self._round_pending:
                pend = self._round_pending
                if (cow_node is not None and id(cow_node) in pend) or any(
                    id(n) in pend for n in chain
                ):
                    return DEFER_ROUND
            base = sum(len(n.key) for n in chain)
            shared_len = base + cow_lcp
            need_total = -(-want_len // block)
            n_new = need_total - len(chain)
            # pin the match before eviction can run: the chain is about to
            # be referenced, and the COW source must survive until its
            # block is read by this round's copy
            pinned = list(chain)
            if cow_node is not None:
                pinned.append(cow_node)
            for n in pinned:
                self.tree.incref(n)
            try:
                fresh = self._take_blocks_locked(n_new)
            except BaseException:
                for n in pinned:
                    self.tree.decref(n)
                raise
            if fresh is None:
                for n in pinned:
                    self.tree.decref(n)
                return None
            if cow_node is not None:
                # the fork: only the block the writer would share-write is
                # copied; whole shared blocks are never written (writes
                # land at positions >= shared_len, which all fall in
                # private blocks)
                self.tree.decref(cow_node)  # pinned for eviction only
                cow = (cow_node.block, fresh[0])
                self.cow_copies += 1
            else:
                cow = None
            lease_id = self._next_lease
            self._next_lease += 1
            nodes = list(chain)
            # publish the prompt's private blocks right away: their K/V is
            # written by this round's prefill, and every later reader is
            # queued after it — the GRPO group-shared prompt hits from the
            # second round on.  Blocks holding no prompt token (the +1
            # decode block) stay private.
            pubs: list = []
            parent = chain[-1] if chain else self.tree.root
            pos = base
            j = 0
            while pos < P:
                node = self.tree.attach(
                    parent, t[pos:pos + block], fresh[j], owner=lease_id
                )
                self.tree.incref(node)
                self._lent.discard(node.block)  # the tree owns it now
                self._round_pending.add(id(node))
                nodes.append(node)
                pubs.append(node)
                parent = node
                pos += block
                j += 1
            self.tree.register_exact(t, pubs[-1])
            self._leases[lease_id] = _Lease(nodes, pubs)
            if shared_len:
                self.hits += 1
            else:
                self.misses += 1
            if exact:
                self.exact_hits += 1
            self.tokens_cached += shared_len
            self.tokens_computed += P - shared_len
            return AdmitPlan(
                lease_id, shared_len, [n.block for n in chain] + fresh,
                cow, len(chain),
            )

    def end_round(self) -> None:
        """The admission round's prefill is queued: its published blocks
        are now safely shareable (stream order)."""
        with self._lock:
            self._round_pending.clear()

    # -- plain allocation ------------------------------------------------------

    def alloc(self, k: int):
        """``k`` fresh private blocks for decode growth, evicting LRU
        unreferenced tree blocks as needed; ``None`` when even eviction
        cannot cover it."""
        if k <= 0:
            return []
        with self._lock:
            return self._take_blocks_locked(k)

    def _take_blocks_locked(self, k: int, reason: str = "capacity"):
        free = self.free_blocks
        while len(free) < k:
            # one block per step: an abandoned allocation leaves the
            # refcounts and the free list consistent
            node = self.tree.pop_lru()
            if node is None:
                return None
            free.append(node.block)
            self.evictions[reason] = self.evictions.get(reason, 0) + 1
        out = [free.pop() for _ in range(k)]
        self._lent.update(out)
        self.blocks_charged += k
        return out

    # -- release ---------------------------------------------------------------

    def release(self, lease_id: int, tokens, n_valid: int, blocks) -> None:
        """End a sequence's lease.  ``tokens`` is the full prompt +
        generated id list, ``n_valid`` the count with K/V actually in the
        pool (the final sampled token was never fed back, so its K/V does
        not exist), ``blocks`` the slot's table row in order.  Extends the
        owned tail node over the generated tokens, donates whole
        generated blocks to the tree for multi-turn reuse, drops every
        ref, and frees the remainder."""
        t = tuple(tokens[:n_valid])
        block = self.block
        with self._lock:
            lease = self._leases.pop(lease_id)
            donated: set = set()
            last = lease.pubs[-1]
            if last.parent is not None and last.owner == lease_id:
                s = self.tree.start_of(last)
                end = min(s + block, n_valid)
                if end - s > len(last.key):
                    self.tree.extend_key(last, t[s:end])
                pos = s + len(last.key)
                bi = pos // block
                parent = last
                while (
                    len(parent.key) == block
                    and pos < n_valid
                    and bi < len(blocks)
                    and blocks[bi] in self._lent
                ):
                    node = self.tree.attach(parent, t[pos:pos + block], blocks[bi])
                    donated.add(node.block)
                    self._lent.discard(node.block)
                    parent = node
                    pos += block
                    bi += 1
                if pos >= n_valid:
                    self.tree.register_exact(t, parent)
            for n in lease.pubs:
                n.owner = None
            tree_blocks = {n.block for n in lease.nodes}
            for n in lease.nodes:
                self.tree.decref(n)
            for b in blocks:
                if b in tree_blocks or b in donated:
                    continue
                if b not in self._lent:
                    raise RuntimeError(
                        f"KV block {b} freed while not lent (double free?)"
                    )
                self._lent.discard(b)
                self.free_blocks.append(b)

    # -- speculative drafts ----------------------------------------------------

    def draft(self, tokens, k: int) -> list:
        """Up to ``k`` draft tokens continuing ``tokens`` from the tree
        (the SGLang-style lookahead the speculative decoder verifies).
        No refs taken and nothing allocated (a hit refreshes the LRU
        stamps of the nodes it read, :meth:`PrefixTree.lookahead`) —
        blocks the proposal came from may be evicted before the verify
        dispatches, which is fine because the exactness gate makes a
        stale draft merely unproductive, never wrong."""
        with self._lock:
            out = self.tree.lookahead(tuple(tokens), k)
            if out:
                self.draft_hits += 1
                self.draft_tokens += len(out)
            else:
                self.draft_misses += 1
            return out

    # -- capacity / probes -----------------------------------------------------

    def free_adjusted(self) -> int:
        """Sharing-adjusted free capacity: the free list plus resident
        blocks no live sequence references (one eviction from free)."""
        with self._lock:
            return len(self.free_blocks) + self.tree.reclaimable

    def probe(self, tokens, total_len: int):
        """``(shared_len, new_blocks_needed)`` for a hypothetical
        admission covering ``total_len`` tokens — no refs taken, nothing
        allocated."""
        t = tuple(tokens)
        with self._lock:
            chain, _cow, cow_lcp, _ = self.tree.match(t)
            base = sum(len(n.key) for n in chain)
            need = -(-total_len // self.block) - len(chain)
            return base + cow_lcp, need

    # -- lifecycle / telemetry -------------------------------------------------

    def reset(self) -> None:
        """Drop every lease and resident block IN PLACE (engine reset:
        pool contents become unreachable).  ``free_blocks`` keeps its
        identity — the engine aliases the list."""
        with self._lock:
            n = self.tree.n_nodes
            if n:
                self.evictions["reset"] = self.evictions.get("reset", 0) + n
            self.tree = PrefixTree(self.block)
            self._leases.clear()
            self._round_pending.clear()
            self._lent.clear()
            fb = self.free_blocks
            fb.clear()
            fb.extend(range(1, self.n_blocks))

    def stats(self) -> dict:
        with self._lock:
            total = self.tokens_cached + self.tokens_computed
            shared = 0
            for node in self.tree.walk():
                if node.refs > 0:
                    shared += 1
            ev = dict(self.evictions)
            return {
                "kv_prefix_hit_rate": (self.tokens_cached / total) if total else 0.0,
                "kv_prefix_hits": self.hits,
                "kv_prefix_misses": self.misses,
                "kv_prefix_exact_hits": self.exact_hits,
                "kv_prefill_tokens_cached": self.tokens_cached,
                "kv_prefill_tokens_computed": self.tokens_computed,
                "kv_shared_blocks": shared,
                "kv_cached_blocks": self.tree.n_nodes,
                "kv_reclaimable_blocks": self.tree.reclaimable,
                "kv_cow_copies_total": self.cow_copies,
                "kv_blocks_charged_total": self.blocks_charged,
                "kv_draft_hits": self.draft_hits,
                "kv_draft_misses": self.draft_misses,
                "kv_draft_tokens": self.draft_tokens,
                "kv_evictions": ev,
                "kv_evictions_total": sum(ev.values()),
            }

    def audit(self) -> dict:
        """Validate every structural invariant (tests; O(pool)).  Raises
        ``AssertionError`` on the first violation."""
        with self._lock:
            blocks_seen: set = set()
            ref0 = 0
            for node in self.tree.walk():
                assert node.key, "empty node key"
                assert len(node.key) <= self.block, "oversize node key"
                if node.children:
                    assert len(node.key) == self.block, (
                        "partial-key node with children"
                    )
                assert node.refs >= 0, f"negative refcount on block {node.block}"
                if node.parent is not self.tree.root:
                    assert node.refs <= node.parent.refs, (
                        "child referenced more than its parent: a reader's "
                        "node set must be a root path"
                    )
                assert node.block not in blocks_seen, (
                    f"block {node.block} resident twice"
                )
                blocks_seen.add(node.block)
                if node.refs == 0:
                    ref0 += 1
                held = sum(
                    1
                    for lease in self._leases.values()
                    if any(n is node for n in lease.nodes)
                )
                assert node.refs == held, (
                    f"block {node.block}: refs={node.refs} but {held} live leases"
                )
            assert ref0 == self.tree.reclaimable, (
                f"reclaimable counter {self.tree.reclaimable} != {ref0} ref-0 nodes"
            )
            free = self.free_blocks
            assert len(free) == len(set(free)), "duplicate entries in free list"
            assert not (set(free) & blocks_seen), "free block also resident"
            assert not (set(free) & self._lent), "free block also lent"
            assert not (self._lent & blocks_seen), "lent block also resident"
            every = set(free) | self._lent | blocks_seen
            assert every == set(range(1, self.n_blocks)), (
                f"pool not partitioned: {len(every)} of {self.n_blocks - 1} "
                "blocks accounted for"
            )
            return {
                "free": len(free),
                "lent": len(self._lent),
                "resident": len(blocks_seen),
                "reclaimable": self.tree.reclaimable,
                "leases": len(self._leases),
            }
