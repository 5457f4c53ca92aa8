"""Radix tree over token-block sequences -> refcounted KV pool blocks.

The serving engine's KV pool is paged: a sequence's cache lives in
fixed-size blocks named by a per-slot block table
(``transformer._paged_attention``).  Two sequences that share a token
prefix compute IDENTICAL K/V for the shared positions — so the shared
blocks can be shared physically.  This module holds the host-side index
that makes that safe:

- **One node per physical block.** A node's ``key`` is the token content
  its block holds (at most ``block_size`` tokens; interior nodes are
  always full blocks — a partial key can only appear on a leaf, the
  growing tail of the sequence that owns it).  Children are keyed by
  first token, with longest-common-prefix selection among candidates.
- **Refcounts = live readers.** Every sequence whose table references a
  node holds one ref on it (and, because a reader's node set is a path
  from the root, refs are monotone non-increasing with depth).  A node
  with ``refs > 0`` can never be evicted.
- **LRU eviction over unreferenced leaves.** ``pop_lru`` detaches the
  least-recently-touched ``refs == 0`` leaf via a lazily-invalidated
  heap; evicting a leaf may expose its parent as the next candidate.
- **Exact-match fast path.** Published sequences register their full
  token tuple in a dict, so the repeated-rollout-prompt case (a GRPO
  group shares ONE prompt) resolves without walking the tree.

The tree never touches the device: it maps token prefixes to block ids
and reference counts.  Copy-on-write forking, allocation, and the lock
live in :mod:`rl_tpu_torch.kvmem.allocator`.

A copy of :mod:`rl_tpu.kvmem.radix` (plain Python), with its
speculative-decoding draft query :meth:`PrefixTree.lookahead`.
"""

from __future__ import annotations

import heapq

__all__ = ["RadixNode", "PrefixTree"]


class RadixNode:
    """One physical KV block: ``key`` is the token content it holds."""

    __slots__ = (
        "key", "block", "parent", "children", "refs", "stamp", "owner",
        "exact_keys",
    )

    def __init__(self, key, block, parent):
        self.key = tuple(key)
        self.block = block
        self.parent = parent
        self.children: dict = {}  # first token -> [candidate nodes]
        self.refs = 0  # live sequences whose tables reference this block
        self.stamp = 0  # LRU clock value of the last touch
        self.owner = None  # lease id allowed to write/extend this block
        self.exact_keys: list = []  # exact-index tuples pointing at this node

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"RadixNode(block={self.block}, n_key={len(self.key)}, "
            f"refs={self.refs}, children={sum(len(v) for v in self.children.values())})"
        )


def _lcp(key, tokens, pos):
    """Longest common prefix of ``key`` and ``tokens[pos:]``."""
    n = min(len(key), len(tokens) - pos)
    i = 0
    while i < n and key[i] == tokens[pos + i]:
        i += 1
    return i


class PrefixTree:
    """Block-granular radix tree with refcounts and LRU leaf eviction."""

    def __init__(self, block_size: int):
        self.block = block_size
        self.root = RadixNode((), -1, None)
        self.n_nodes = 0  # resident (block-backed) nodes, root excluded
        self.reclaimable = 0  # nodes with refs == 0 (eventually evictable)
        self._clock = 0
        self._heap: list = []  # (stamp, seq, node) min-heap, lazily invalidated
        self._hseq = 0
        self._exact: dict = {}  # full token tuple -> deepest covering node

    # -- clock / heap ----------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push(self, node: RadixNode) -> None:
        self._hseq += 1
        heapq.heappush(self._heap, (node.stamp, self._hseq, node))

    # -- matching --------------------------------------------------------------

    def match(self, tokens: tuple):
        """Longest cached prefix of ``tokens`` — never the whole prompt:
        the last position must be recomputed so its logits can sample the
        first response token.

        Returns ``(chain, cow_node, cow_lcp, exact)``: ``chain`` is the
        path of fully-shared whole-block nodes (their blocks may go
        straight into a reader's block table), and ``cow_node``/``cow_lcp``
        name a block whose first ``cow_lcp`` tokens match but which the
        reader would have to WRITE into — it must fork a private copy
        (copy-on-write) instead of referencing it.  Touches the LRU stamp
        of every node on the path.
        """
        P = len(tokens)
        block = self.block
        chain: list = []
        cow_node, cow_lcp = None, 0
        exact = False
        node = self._exact.get(tokens)
        if node is not None:
            # exact fast path: rebuild the chain from parent pointers, no
            # per-block token comparisons (repeated rollout prompts)
            exact = True
            while node.parent is not None:
                chain.append(node)
                node = node.parent
            chain.reverse()
        else:
            node, pos = self.root, 0
            while pos < P:
                best, best_l = None, 0
                for c in node.children.get(tokens[pos], ()):
                    l = _lcp(c.key, tokens, pos)
                    if l > best_l:
                        best, best_l = c, l
                if best is None:
                    break
                if best_l == block and len(best.key) == block:
                    chain.append(best)
                    node = best
                    pos += block
                    continue
                # divergence mid-block, prompt exhaustion mid-block, or a
                # partial tail leaf: shareable only by forking a copy
                cow_node, cow_lcp = best, best_l
                break
        base = sum(len(n.key) for n in chain)
        if chain and base >= P:
            # the chain covers position P-1 (or beyond — an exact-index
            # entry whose tail was later extended): surrender the tail to
            # a COW fork so the last prompt position is recomputed in a
            # writable block
            cow_node = chain.pop()
            base -= len(cow_node.key)
            cow_lcp = P - 1 - base
        elif cow_node is not None and base + cow_lcp > P - 1:
            cow_lcp = P - 1 - base
        if cow_lcp <= 0:
            cow_node, cow_lcp = None, 0
        t = self._tick()
        for n in chain:
            n.stamp = t
        if cow_node is not None:
            cow_node.stamp = t
        return chain, cow_node, cow_lcp, exact

    # -- refcounts -------------------------------------------------------------

    def incref(self, node: RadixNode) -> None:
        if node.refs == 0:
            self.reclaimable -= 1
        node.refs += 1

    def decref(self, node: RadixNode) -> None:
        node.refs -= 1
        if node.refs == 0:
            self.reclaimable += 1
            if not node.children:
                self._push(node)

    # -- structure -------------------------------------------------------------

    def attach(self, parent: RadixNode, key, block: int, owner=None) -> RadixNode:
        """New node under ``parent`` (born with ``refs == 0``; callers
        incref readers).  ``owner`` marks the lease allowed to keep
        writing the block (the live sequence it belongs to)."""
        node = RadixNode(key, block, parent)
        node.owner = owner
        node.stamp = self._tick()
        parent.children.setdefault(node.key[0], []).append(node)
        self.n_nodes += 1
        self.reclaimable += 1
        self._push(node)
        return node

    def extend_key(self, node: RadixNode, key) -> None:
        """Grow an owned tail node's key in place — same block, more of
        its positions now hold valid K/V (the owner wrote them)."""
        node.key = tuple(key)

    def register_exact(self, tokens: tuple, node: RadixNode) -> None:
        old = self._exact.get(tokens)
        if old is not None and old is not node and tokens in old.exact_keys:
            old.exact_keys.remove(tokens)
        self._exact[tokens] = node
        if tokens not in node.exact_keys:
            node.exact_keys.append(tokens)

    def pop_lru(self):
        """Detach and return the least-recently-used ``refs == 0`` leaf
        (its block may be reused), or ``None`` when nothing is evictable.
        Exposing the parent as a new leaf queues it as a candidate."""
        while self._heap:
            stamp, _, node = heapq.heappop(self._heap)
            if node.parent is None or node.refs != 0 or node.children:
                continue  # stale entry: detached, re-referenced, or interior
            if stamp != node.stamp:
                self._push(node)  # touched since queued: re-rank, keep looking
                continue
            self._detach(node)
            return node
        return None

    def _detach(self, node: RadixNode) -> None:
        sibs = node.parent.children[node.key[0]]
        sibs.remove(node)
        if not sibs:
            del node.parent.children[node.key[0]]
        parent, node.parent = node.parent, None
        for t in node.exact_keys:
            if self._exact.get(t) is node:
                del self._exact[t]
        node.exact_keys = []
        self.n_nodes -= 1
        self.reclaimable -= 1  # only refs == 0 nodes are ever detached
        if parent is not self.root and parent.refs == 0 and not parent.children:
            self._push(parent)

    # -- speculative draft query -----------------------------------------------

    def lookahead(self, tokens, k: int) -> list:
        """Up to ``k`` cached continuation tokens for ``tokens`` — the
        speculative-decoding draft query.  Descends the live tree along
        the FULL context (prompt + emitted tokens); when the context is
        resident, the proposal reads ahead along the hottest descendant
        chain (most recently touched, then most referenced).  Takes no
        refs — a draft probe must not keep blocks alive that no sequence
        references, and a wrong draft costs nothing (the verify step's
        exactness gate rejects it) — but a HIT refreshes the LRU stamp
        of every node it read: speculative reuse is reuse.  Donated
        continuations are only reachable through this query (``match``
        touches the prompt path, never the continuation), so without the
        refresh they age to the bottom of the LRU under churn and get
        evicted while still hot, collapsing the draft hit rate exactly
        when the fleet is busiest.  Re-ranking never blocks allocation:
        ``pop_lru`` still evicts the oldest ``refs == 0`` leaf the
        moment capacity demands one.

        Guard: every step of the walk re-checks that the node it is
        about to consume is still ATTACHED (``parent`` linkage intact).
        A ``refs == 0`` node is fair game while resident — donated
        continuations are the whole point — but once ``pop_lru`` has
        detached it (pending eviction resolved), the proposal must stop
        rather than read past it through a stale candidate reference
        (``tests/test_torch_speculative.py`` holds both rules to the
        reference's tree).
        """
        if k <= 0:
            return []
        P = len(tokens)
        node, pos, used = self.root, 0, 0
        path: list = []
        while pos < P:
            best, best_l = None, 0
            for c in node.children.get(tokens[pos], ()):
                if c.parent is not node:  # detached mid-walk: never propose past it
                    continue
                l = _lcp(c.key, tokens, pos)
                if l > best_l:
                    best, best_l = c, l
            if best is None or (best_l < len(best.key) and pos + best_l < P):
                return []  # context diverges from everything resident
            node, used = best, best_l
            path.append(best)
            pos += best_l
        out: list = [] if node is self.root else list(node.key[used:])[:k]
        while len(out) < k:
            cands = [
                c
                for cs in node.children.values()
                for c in cs
                if c.parent is node  # the pending-eviction guard, again
            ]
            if not cands:
                break
            node = max(cands, key=lambda c: (c.stamp, c.refs, c.block))
            path.append(node)
            out.extend(node.key[: k - len(out)])
        if out:
            t = self._tick()
            for n in path:
                n.stamp = t
        return out

    # -- introspection ---------------------------------------------------------

    def start_of(self, node: RadixNode) -> int:
        """Token position where ``node``'s block begins.  Every ancestor
        is a full block (partial keys are leaves), so this is just
        depth * block_size."""
        d = 0
        p = node.parent
        while p is not None:
            d += 1
            p = p.parent
        return (d - 1) * self.block

    def walk(self):
        """Yield every resident node (pre-order)."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            for cands in n.children.values():
                stack.extend(cands)
