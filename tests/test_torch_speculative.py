"""Speculative decoding against the JAX package, on the CPU (mirrors the
reference's ``tests/test_speculative.py``, model and engine included:
vocab 97, d_model 64, 2 layers, float32, flax weights through
``params_from_flax``; 2 slots, blocks of 8, seed 7).

- Draft sources: ``NGramDraft`` on the reference's cases; the radix
  tree's ``lookahead`` and the allocator's ``draft`` against the
  reference's tree under the same random attach, ref, unref, match and
  eviction churn (proposals and every node's LRU stamp equal after each
  operation), a hit's LRU refresh and the stop at a node ``pop_lru``
  detached.
- Exactness: the speculative engine's tokens equal the vanilla engine's
  (greedy: the default engine; at temperature 0.7: the ``slot_rng``
  engine from the same seed) with an oracle draft source, n-gram drafts,
  eos inside a draft, a draft longer than the budget, and a prefix-cache
  replay drafting from the tree. Verify reads the cache through the
  gather route and decode through the paged-decode kernel's plain
  version, whose logits differ by rounding; on these shapes and seeds the
  tokens are equal without a margin, and log-probs agree within 1e-5 as
  in the reference.
- The port's speculative engine against the JAX speculative engine:
  tokens equal, log-probs within 1e-4, greedy and sampled, and the same
  verify dispatches.
- The registry: the engine's ``aot_warmup`` names equal the reference's
  ladder (formats read from the reference engine's source, never by
  running its ``aot_warmup``), and the registry engine equals the eager
  one bit for bit; the verify body under the host-read guard of
  ``test_torch_registry.py`` (on the card the speculative engine's
  replays are held to its eager run in ``test_torch_graph_programs.py``,
  which imports no JAX).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_registry import _NoHostReads

from rl_tpu.compile import ShapeBuckets as JaxBuckets
from rl_tpu.kernels import registry as jax_kernel_registry
from rl_tpu.kvmem.radix import PrefixTree as JaxTree
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry, ShapeBuckets, pow2ceil
from rl_tpu_torch.kvmem.radix import PrefixTree
from rl_tpu_torch.models import (ContinuousBatchingEngine, DraftSource, NGramDraft,
                                 PrefixTreeDraft, TransformerConfig, TransformerLM,
                                 params_from_flax)

torch.set_num_threads(1)

CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128)
ENGINE = dict(n_slots=2, block_size=8, n_blocks=65, prompt_buckets=(16,), greedy=True, seed=7)
PROMPTS = [np.arange(3, 15) % 97, np.arange(60, 72) % 97]


@pytest.fixture(autouse=True)
def _reference_xla_read(monkeypatch):
    monkeypatch.delenv(jax_kernel_registry.ENV_INTERPRET, raising=False)
    monkeypatch.delenv(jax_kernel_registry.ENV_NO_KERNELS, raising=False)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(JaxConfig(**CFG, dtype=jnp.float32))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**CFG, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


class OracleDraft:
    """Replays reference continuations: proposes the rest of whichever
    sequence the context is a prefix of (the reference test's source), so
    verify accepts long chains."""

    def __init__(self, seqs):
        self.seqs = [list(map(int, s)) for s in seqs]
        self.hits = self.misses = self.proposed_tokens = 0

    def propose(self, context, k):
        c = list(map(int, context))
        for s in self.seqs:
            if len(s) > len(c) and s[: len(c)] == c:
                out = s[len(c): len(c) + k]
                self.hits += 1
                self.proposed_tokens += len(out)
                return out
        self.misses += 1
        return []

    def stats(self):
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "proposed_tokens": self.proposed_tokens}


def _engine(models, **kw):
    return ContinuousBatchingEngine(models[2], device="cpu", **dict(ENGINE, **kw))


def _complete(eng, prompts, max_new):
    rids = [eng.submit(p, max_new) for p in prompts]
    if isinstance(eng, JaxEngine):
        while eng.step():
            jax.block_until_ready(eng.dev_lens)
        out = {f.rid: f for f in eng.finished}
        eng.finished.clear()
    else:
        out = eng.run()
    return [out[r] for r in rids]


def _assert_same(got, want, lp_atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finished_reason == w.finished_reason
        np.testing.assert_allclose(g.log_probs, w.log_probs, rtol=0, atol=lp_atol)


def _oracle(prompts, ref):
    return OracleDraft([list(p) + list(r.tokens) for p, r in zip(prompts, ref)])


# -- draft sources -------------------------------------------------------------


def test_ngram_drafts_as_the_reference():
    assert isinstance(NGramDraft(), DraftSource) and isinstance(OracleDraft([]), DraftSource)
    d = NGramDraft(n=2)
    ctx = [1, 2, 3, 4, 5, 8, 9, 6, 7, 0, 8, 9]
    assert d.propose(ctx, 3) == [6, 7, 0] and d.propose(ctx, 1) == [6]
    assert d.stats()["hits"] == 2 and d.stats()["proposed_tokens"] == 4
    d = NGramDraft(n=3)
    assert d.propose([1, 2, 3, 4, 5, 6], 4) == [] and d.propose([1, 2], 4) == []
    assert d.propose([1, 2, 3, 4], 0) == []
    assert d.stats() == {"hits": 0, "misses": 3, "hit_rate": 0.0, "proposed_tokens": 0}
    with pytest.raises(ValueError):
        NGramDraft(n=0)


def _tree_state(t):
    """Every resident node, pre-order: (key, block, refs, stamp)."""
    return [(n.key, n.block, n.refs, n.stamp) for n in t.walk()]


def test_lookahead_matches_the_reference_tree_under_churn():
    """The same random attach/incref/decref/match/pop_lru churn on the
    port's tree and the reference's: after every operation, random probes
    propose the same tokens and leave every node's stamp equal (a hit
    refreshes the stamps of the nodes it read, a miss none)."""
    rng = np.random.default_rng(6)
    trees = (PrefixTree(4), JaxTree(4))
    nodes: list = []  # pairs (ours, reference's)
    held: list = []
    proposals = 0
    for step in range(400):
        op = rng.random()
        if op < 0.45 or not nodes:
            full = [p for p in nodes if p[0].parent is not None and len(p[0].key) == 4]
            parent = (None if not full or rng.random() < 0.3 else full[rng.integers(len(full))])
            klen = 4 if rng.random() < 0.8 else int(rng.integers(1, 4))
            key = tuple(int(v) for v in rng.integers(0, 6, klen))
            nodes.append(tuple(t.attach(t.root if parent is None else p, key, block=step)
                               for t, p in zip(trees, parent or (None, None))))
        elif op < 0.55:
            pair = nodes[rng.integers(len(nodes))]
            if pair[0].parent is not None:
                for t, n in zip(trees, pair):
                    t.incref(n)
                held.append(pair)
        elif op < 0.65 and held:
            pair = held.pop(rng.integers(len(held)))
            for t, n in zip(trees, pair):
                t.decref(n)
        elif op < 0.75:
            ctx = tuple(int(v) for v in rng.integers(0, 6, int(rng.integers(1, 10))))
            (c0, n0, l0, e0), (c1, n1, l1, e1) = (t.match(ctx) for t in trees)
            assert [n.block for n in c0] == [n.block for n in c1] and (l0, e0) == (l1, e1)
            assert (n0 and n0.block) == (n1 and n1.block)
        else:
            out = [t.pop_lru() for t in trees]
            assert (out[0] is None) == (out[1] is None)
            if out[0] is not None:
                assert (out[0].key, out[0].block) == (out[1].key, out[1].block)
        for _ in range(3):
            ctx = tuple(int(v) for v in rng.integers(0, 6, int(rng.integers(0, 9))))
            k = int(rng.integers(0, 8))
            ours, ref = (t.lookahead(ctx, k) for t in trees)
            assert ours == ref, (ctx, k)
            proposals += bool(ours)
        assert _tree_state(trees[0]) == _tree_state(trees[1])
    assert proposals > 50


def test_lookahead_refreshes_lru_and_stops_at_a_detached_node():
    for Tree in (PrefixTree, JaxTree):
        t = Tree(4)
        a = t.attach(t.root, (1, 2, 3, 4), block=10)
        b = t.attach(a, (5, 6, 7, 8), block=11)
        cold = t.attach(t.root, (9, 9, 9, 9), block=12)  # attached last
        assert t.lookahead((1, 2, 3, 4), 4) == [5, 6, 7, 8]
        assert b.refs == 0 and a.refs == 0  # no refs taken
        assert t.pop_lru() is cold  # the hit re-ranked the donor chain
        assert t.lookahead((7, 7), 4) == []  # a miss refreshes nothing
        assert t.pop_lru() is b  # detached, pending block reuse
        a.children.setdefault(5, []).append(b)  # a stale alias to it
        assert b.parent is None
        assert t.lookahead((1, 2, 3, 4), 4) == []  # read-ahead guard
        assert t.lookahead((1, 2, 3, 4, 5, 6), 4) == []  # descent guard


def test_prefix_tree_draft_replays_the_donated_continuation(models):
    eng = _engine(models, prefix_cache=True)
    prompt = np.arange(30, 42) % 97
    ref = _complete(eng, [prompt], 10)[0]
    src = PrefixTreeDraft(eng._kvmem)
    ctx = list(map(int, prompt)) + list(map(int, ref.tokens[:2]))
    out = src.propose(ctx, 5)
    assert out and out == list(map(int, ref.tokens[2:]))[: len(out)]
    s = src.stats()
    assert s["hits"] >= 1 and s["proposed_tokens"] == len(out) and 0.0 < s["hit_rate"] <= 1.0
    kv = eng.stats()
    assert kv["kv_draft_hits"] == s["hits"] and kv["kv_draft_tokens"] == len(out)
    assert src.propose([96, 95, 94], 4) == [] and eng.stats()["kv_draft_misses"] == 1


# -- exactness -----------------------------------------------------------------


def test_greedy_spec_matches_the_plain_engine(models):
    ref = _complete(_engine(models), PROMPTS, 12)
    spec = _engine(models, speculative=True, draft_source=_oracle(PROMPTS, ref),
                   spec_lookahead=7)
    _assert_same(_complete(spec, PROMPTS, 12), ref)
    assert spec.spec_dispatches >= 1 and spec.spec_accepted_tokens > spec.spec_dispatches
    # n-gram drafts on repetitive prompts: right or wrong, the same tokens
    prompts = [np.tile([5, 6, 7, 8], 4), np.tile([40, 41], 8)]
    ngram = _engine(models, speculative=True, draft_source="ngram")
    _assert_same(_complete(ngram, prompts, 12), _complete(_engine(models), prompts, 12))
    assert ngram.spec_dispatches >= 1


def test_temperature_spec_matches_the_vanilla_slot_stream(models):
    kw = dict(greedy=False, temperature=0.7, seed=11)
    ref = _complete(_engine(models, slot_rng=True, **kw), PROMPTS, 12)
    spec = _engine(models, speculative=True, draft_source=_oracle(PROMPTS, ref),
                   spec_lookahead=7, **kw)
    _assert_same(_complete(spec, PROMPTS, 12), ref)
    assert spec.spec_dispatches >= 1 and spec.spec_accepted_tokens > spec.spec_dispatches
    # the legacy stream (the engine's generator) samples other tokens
    legacy = _complete(_engine(models, **kw), PROMPTS, 12)
    assert any(not np.array_equal(a.tokens, b.tokens) for a, b in zip(legacy, ref))


def test_eos_inside_a_draft_and_a_draft_longer_than_the_budget(models):
    prompt = np.arange(11, 23) % 97
    ref = _complete(_engine(models), [prompt], 16)[0]
    eos = int(ref.tokens[3])
    stop = int(np.flatnonzero(ref.tokens == eos)[0])
    van = _complete(_engine(models, eos_id=eos), [prompt], 16)[0]
    out = _complete(_engine(models, eos_id=eos, speculative=True, spec_lookahead=7,
                            draft_source=_oracle([prompt], [ref])), [prompt], 16)[0]
    _assert_same([out], [van])
    assert out.finished_reason == "eos" and np.array_equal(out.tokens, ref.tokens[: stop + 1])
    prompt = np.arange(17, 29) % 97
    ref = _complete(_engine(models), [prompt], 12)[0]
    spec = _engine(models, speculative=True, spec_lookahead=7,
                   draft_source=_oracle([prompt], [ref]))
    out = _complete(spec, [prompt], 3)[0]  # budget 3 << lookahead 7
    assert out.finished_reason == "length" and np.array_equal(out.tokens, ref.tokens[:3])
    _assert_same([out], _complete(_engine(models), [prompt], 3))


def test_prefix_cache_replay_drafts_from_the_tree(models):
    ref = _complete(_engine(models), PROMPTS, 12)
    eng = _engine(models, prefix_cache=True, speculative=True, spec_lookahead=7)
    _assert_same(_complete(eng, PROMPTS, 12), ref)  # cold: donates to the tree
    _assert_same(_complete(eng, PROMPTS, 12), ref)  # replay: real tree drafts
    snap = eng.stats()
    assert eng.spec_dispatches >= 1 and snap["spec_accepted_per_dispatch"] > 1.0
    assert snap["spec_draft_hits"] >= 1 and 0.0 < snap["spec_draft_hit_rate"] <= 1.0
    assert snap["kv_draft_hits"] == snap["spec_draft_hits"]
    # one histogram entry per live slot per verify
    assert sum(snap["spec_accept_counts"].values()) >= eng.spec_dispatches
    assert snap["spec_plain_rounds_no_draft"] >= 1  # the cold round had nothing to draft
    assert snap["spec_plain_rounds_pool_tight"] == 0
    eng._kvmem.audit()


def test_options_and_the_off_path(models):
    eng = _engine(models)
    assert not eng.speculative and not eng.slot_rng and eng._draft_source is None
    _complete(eng, [PROMPTS[0]], 4)
    assert not any(k.startswith("spec_") for k in eng.stats())
    assert "kv_draft_hits" not in eng.stats()
    assert _engine(models, speculative=True).slot_rng  # speculation implies slot streams
    assert isinstance(_engine(models, speculative=True)._draft_source, NGramDraft)
    assert isinstance(_engine(models, speculative=True, prefix_cache=True)._draft_source,
                      PrefixTreeDraft)
    with pytest.raises(ValueError, match="kv_handoff does not compose"):
        _engine(models, speculative=True, kv_handoff=True)
    assert _engine(models, kv_handoff=True).kv_handoff
    with pytest.raises(ValueError, match="needs prefix_cache=True"):
        _engine(models, speculative=True, draft_source="prefix_tree")
    with pytest.raises(ValueError, match="unknown draft_source"):
        _engine(models, speculative=True, draft_source="psychic")


# -- against the JAX speculative engine ----------------------------------------


def _sampled_oracle(models, seed, **kw):
    """An oracle over the vanilla slot stream's samples (a sampled replay
    has new rids, whose streams the tree's continuations do not follow)."""
    van = _complete(_engine(models, slot_rng=True, seed=seed, **kw), PROMPTS, 12)
    return lambda: _oracle(PROMPTS, van)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "t0.7"])
def test_spec_engine_matches_the_jax_spec_engine(models, greedy):
    """Greedy: a cold round, then a replay drafting from the tree;
    sampled: one round drafting from an oracle over the slot stream."""
    jm, params, _ = models
    kw = dict(ENGINE, greedy=greedy, temperature=0.7, prefix_cache=True, speculative=True,
              spec_lookahead=7)
    drafts = ({}, {}) if greedy else tuple(
        dict(draft_source=make()) for make in [_sampled_oracle(
            models, 7, greedy=False, temperature=0.7, prefix_cache=True)] * 2)
    ours, theirs = _engine(models, **kw, **drafts[0]), JaxEngine(jm, params, **kw, **drafts[1])
    for _ in range(2 if greedy else 1):
        for a, r in zip(_complete(ours, PROMPTS, 12), _complete(theirs, PROMPTS, 12)):
            np.testing.assert_array_equal(a.tokens, r.tokens)
            assert a.finished_reason == r.finished_reason
            np.testing.assert_allclose(a.log_probs, r.log_probs, atol=1e-4, rtol=0)
    assert ours.spec_dispatches == theirs.spec_dispatches >= 1
    assert ours.spec_accepted_tokens == theirs.spec_accepted_tokens
    assert ours.stats()["spec_accept_counts"] == theirs.metrics_snapshot()["spec_accept_counts"]


# -- programs ------------------------------------------------------------------


def reference_formats() -> dict:
    """The slot-stream and verify program-name formats of the reference
    engine, read from its source."""
    out = {}
    for key, method in (("sdecode", "_get_sdecode_prog"), ("verify", "_get_verify_prog"),
                        ("sprefill", "_get_sprefill_prog"), ("spprefill", "_get_spprefill_prog"),
                        ("cow", "_get_cow_prog")):
        src = inspect.getsource(getattr(JaxEngine, method))
        (out[key],) = re.findall(r'f"(serving\.[^"]+)"', src)
    assert '"serving.sadmit_update"' in inspect.getsource(JaxEngine.__init__)
    return out


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_aot_warmup_registers_the_reference_spec_ladder(models, prefix):
    fmt = reference_formats()
    jb = JaxBuckets(prompt=(16, 32), suffix=(8,))
    registry = ProgramRegistry(ExecutableStore())
    eng = _engine(models, prompt_buckets=None, buckets=ShapeBuckets(prompt=(16, 32), suffix=(8,)),
                  n_slots=3, decode_chunk=4, prefix_cache=prefix, speculative=True,
                  spec_lookahead=15, registry=registry)
    report = eng.aot_warmup()
    kind, rungs = ("spprefill", jb.suffix_ladder()) if prefix else ("sprefill", jb.prompt)
    # the reference's names: locals of its f-strings
    want = {fmt["sdecode"].format(chunk=4), "serving.sadmit_update"}
    want |= {fmt["verify"].format(K=k) for k in (2, 4, 8, 16)}  # spec_lookahead 15 -> K <= 16
    want |= {fmt[kind].format(a=a, bucket=b) for a in jb.admit_sizes(3) for b in rungs}
    if prefix:
        want |= {fmt["cow"].format(n=n) for n in (1, 2, 4) if n <= pow2ceil(3)}
    assert set(registry.names()) == set(report) == want


def test_spec_registry_engine_equals_the_eager_engine(models):
    kw = dict(prefix_cache=True, greedy=False, temperature=0.8, decode_chunk=2)
    oracle = _sampled_oracle(models, 7, **kw)
    kw.update(speculative=True, spec_lookahead=7)
    registry = ProgramRegistry(ExecutableStore())
    eager = _engine(models, draft_source=oracle(), **kw)
    graphed = _engine(models, registry=registry, warmup=True, draft_source=oracle(), **kw)
    for a, b in zip(_complete(eager, PROMPTS, 12), _complete(graphed, PROMPTS, 12)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.log_probs, b.log_probs)
    assert graphed.spec_dispatches == eager.spec_dispatches >= 1
    stats = registry.stats()
    assert sum(s["calls"] for n, s in stats.items() if n.startswith("serving.verify.")) == \
        graphed.spec_dispatches


def test_verify_body_reads_nothing_on_the_host(models):
    eng = _engine(models, speculative=True, eos_id=5)
    eng.dev_table[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    eng.dev_table[1, :2] = torch.tensor([4, 5], dtype=torch.int32)
    eng.dev_lens[:] = torch.tensor([9, 4], dtype=torch.int32)
    eng.dev_active[:] = True
    eng.dev_budget[:] = torch.tensor([6, 2], dtype=torch.int32)
    eng.dev_rid[:] = torch.tensor([0, 1], dtype=torch.int32)
    drafts = torch.randint(1, 97, (2, 3), dtype=torch.int32)
    with _NoHostReads():
        tok, lp, lens, active, budget, last, ntok = eng._verify_body(
            4, *eng._state_args(), eng._dev_run, drafts, *eng._stream_args())
    n_emit = (lens - torch.tensor([9, 4], dtype=torch.int32))
    assert ((n_emit >= 1) & (n_emit <= torch.tensor([4, 2]))).all()
    assert torch.equal(ntok, n_emit) and torch.equal(budget, torch.tensor([6, 2]) - n_emit)
