"""The port's prefix cache (``kvmem`` and the engine's ``prefix_cache``)
against the JAX package, on the CPU.

- The radix tree and the allocator are copies of plain Python: one seeded
  sequence of admit, end_round, alloc, release and reset calls goes to
  both packages' allocators, under pool pressure (evictions) and with
  same-round shares (``DEFER_ROUND``). Every plan, the free list,
  ``stats()`` and ``audit()`` are equal after every call.
- ``ContinuousBatchingEngine(prefix_cache=True)`` (small float32 model,
  same flax weights): greedy tokens identical to ``prefix_cache=False``
  and to ``rl_tpu``'s engine with ``prefix_cache=True``, with equal hit,
  exact-hit, fork and cached-token counts.
- Under ``kv_int8``, a copy-on-write fork copies the scales with the
  pools.
- ``LLMCollector(engine_prefix_cache=True)``: a GRPO group's shared
  prompt hits the tree's exact path, and a collect after a weight push
  does not read K/V cached under the old weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kvmem import DEFER_ROUND as JAX_DEFER
from rl_tpu.kvmem import PrefixKVAllocator as JaxAllocator
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.collectors import LLMCollector
from rl_tpu_torch.compile import ShapeBuckets
from rl_tpu_torch.kvmem import DEFER_ROUND, PrefixKVAllocator
from rl_tpu_torch.models import (
    ContinuousBatchingEngine,
    TransformerConfig,
    TransformerLM,
    params_from_flax,
)

torch.set_num_threads(1)


def _plan(p):
    if p is None or p is DEFER_ROUND or p is JAX_DEFER:
        return "defer" if p is not None else None
    return (p.lease, p.shared_len, list(p.blocks), p.cow, p.n_shared)


def _prompt(rng, seen, block):
    """A prompt that extends, cuts or repeats one seen before, or a fresh one."""
    if seen and rng.random() < 0.7:
        base = seen[int(rng.integers(0, len(seen)))]
        r = rng.random()
        if r < 0.3:
            return list(base)  # exact repeat
        cut = int(rng.integers(1, len(base) + 1))
        return base[:cut] + [int(v) for v in rng.integers(0, 30, int(rng.integers(1, 2 * block)))]
    return [int(v) for v in rng.integers(0, 30, int(rng.integers(2, 4 * block)))]


@pytest.mark.parametrize("n_blocks", [24, 4096])
def test_allocator_matches_reference_call_for_call(n_blocks):
    rng = np.random.default_rng(n_blocks)
    block = 4
    ours, ref = PrefixKVAllocator(n_blocks, block), JaxAllocator(n_blocks, block)
    live, seen = {}, []
    for step in range(400):
        r = rng.random()
        if step == 250:
            ours.reset()
            ref.reset()
            live.clear()
        elif live and r < 0.35:
            lease = sorted(live)[int(rng.integers(0, len(live)))]
            prompt, blocks = live.pop(lease)
            seq = prompt + [int(v) for v in rng.integers(30, 60, int(rng.integers(1, 9)))]
            need = -(-len(seq) // block) - len(blocks)
            got = ours.alloc(need)
            assert got == ref.alloc(need)
            if got is not None:
                blocks = blocks + got
            for kv in (ours, ref):
                kv.release(lease, seq, len(seq) - 1, blocks)
        else:
            prompt = _prompt(rng, seen, block)
            a, b = ours.admit(prompt, len(prompt) + 1), ref.admit(prompt, len(prompt) + 1)
            assert _plan(a) == _plan(b), step
            if a is not None and a is not DEFER_ROUND:
                live[a.lease] = (prompt, list(a.blocks))
                seen.append(prompt)
            if r > 0.8:  # leave the round open: the next admission may defer
                continue
            ours.end_round()
            ref.end_round()
        assert ours.free_blocks == ref.free_blocks, step
        theirs = ref.stats()
        mine = ours.stats()
        assert mine == {k: theirs[k] for k in mine}, step
        assert ours.audit() == ref.audit(), step
    stats = ours.stats()
    assert stats["kv_prefix_exact_hits"] > 0 and stats["kv_cow_copies_total"] > 0
    if n_blocks == 24:
        assert stats["kv_evictions_total"] > 0


def test_probe_and_suffix_ladder_match():
    from rl_tpu.compile import ShapeBuckets as JaxBuckets

    ours, ref = PrefixKVAllocator(64, 4), JaxAllocator(64, 4)
    for kv in (ours, ref):
        kv.admit(list(range(10)), 11)
        kv.end_round()
    for toks in ([0, 1, 2, 3, 4, 5, 6], list(range(12)), [9, 9]):
        assert ours.probe(toks, len(toks) + 5) == ref.probe(toks, len(toks) + 5)
    assert ours.free_adjusted() == ref.free_adjusted()
    sb, jb = ShapeBuckets(prompt=(16, 64), suffix=(4, 8)), JaxBuckets(prompt=(16, 64), suffix=(4, 8))
    assert sb.suffix_ladder() == jb.suffix_ladder() == (4, 8, 16, 64)
    assert [sb.suffix_bucket(n) for n in range(1, 65)] == [jb.suffix_bucket(n) for n in range(1, 65)]
    with pytest.raises(ValueError):
        sb.suffix_bucket(65)


CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=65, prompt_buckets=(32, 64), eos_id=0,
              greedy=True)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(JaxConfig(**CFG, dtype=jnp.float32))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**CFG, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def shared_prompts():
    """Six prompts behind one 21-token system prompt, and two exact repeats
    of it (the exact-match path), as the reference's engine test has them."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 97, size=21)
    prompts = [np.concatenate([sysp, rng.integers(1, 97, size=5)]) for _ in range(6)]
    return prompts + [sysp.copy(), sysp.copy()]


def serve(engine, prompts, budget=12):
    rids = [engine.submit(p, budget) for p in prompts]
    while engine.step():
        if isinstance(engine, JaxEngine):  # the schedule the port has on the CPU
            jax.block_until_ready(engine.dev_lens)
    out = {f.rid: f for f in engine.finished}
    engine.finished.clear()
    return [out[r] for r in rids]


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_prefix_engine_matches_plain_engine_and_reference(models, decode_chunk):
    jm, params, tm = models
    kw = dict(ENGINE, decode_chunk=decode_chunk)
    prompts = shared_prompts()
    plain = serve(ContinuousBatchingEngine(tm, device="cpu", **kw), prompts)
    eng = ContinuousBatchingEngine(tm, device="cpu", prefix_cache=True, **kw)
    ours = serve(eng, prompts)
    jeng = JaxEngine(jm, params, prefix_cache=True, **kw)
    ref = serve(jeng, prompts)
    for a, b, r in zip(ours, plain, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, r.tokens)
        assert a.finished_reason == b.finished_reason == r.finished_reason
        np.testing.assert_allclose(a.log_probs, r.log_probs, atol=1e-4, rtol=0)
    st, jst = eng.stats(), jeng.metrics_snapshot()
    for k in ("kv_prefix_hits", "kv_prefix_exact_hits", "kv_cow_copies_total",
              "kv_prefill_tokens_cached", "kv_blocks_charged_total", "prefill_tokens_computed"):
        assert st[k] == jst[k], k
    assert st["kv_prefix_hit_rate"] > 0.5 and st["kv_prefix_exact_hits"] >= 1
    assert st["kv_cow_copies_total"] >= 1
    assert eng.prefill_tokens_computed < sum(len(p) for p in prompts)
    eng._kvmem.audit()


def test_suffix_bucket_and_reset(models):
    _, _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", prefix_cache=True,
                                   buckets=ShapeBuckets(prompt=(32, 64), suffix=(8,)),
                                   **{k: v for k, v in ENGINE.items() if k != "prompt_buckets"})
    shapes = []
    orig = eng._prefill
    eng._prefill = lambda *a: shapes.append(tuple(a[1].shape)) or orig(*a)
    serve(eng, shared_prompts()[:3])
    assert shapes[0][1] == 32 and any(s[1] == 8 for s in shapes[1:])  # cold, then suffixes
    assert eng.stats()["kv_cached_blocks"] > 0
    eng.reset()
    assert eng.free_blocks is eng._kvmem.free_blocks
    assert len(eng.free_blocks) == ENGINE["n_blocks"] - 1
    assert eng.stats()["kv_cached_blocks"] == 0


def test_int8_fork_carries_scales(models):
    _, _, tm = models
    qm = TransformerLM(TransformerConfig(**CFG, dtype=torch.float32, kv_int8=True), device="cpu")
    qm.load_state_dict(tm.state_dict())
    eng = ContinuousBatchingEngine(qm, device="cpu", prefix_cache=True, **ENGINE)
    forks = []
    orig = eng._cow_copy

    def spy(cows):
        orig(cows)
        for src, dst in cows:
            for bufs in eng.pools:
                assert len(bufs) == 4  # pools and scales
                for a in bufs:
                    assert torch.equal(a[dst], a[src])
            forks.append((src, dst, eng.pools[0][2][src].clone()))

    eng._cow_copy = spy
    out = serve(eng, shared_prompts())
    assert forks and all(bool((s > 0).all()) for *_, s in forks)
    assert all(len(f.tokens) == 12 or f.finished_reason == "eos" for f in out)
    eng._kvmem.audit()


def test_requests_finished_at_prefill_do_not_stall_the_queue(models):
    """Every request of a round can finish at its prefill (one new token):
    the port's next step admits again. The reference's step raises "block
    pool too small" here with free blocks left (ROADMAP queue C)."""
    jm, params, tm = models
    prompts = shared_prompts()[:6]
    kw = dict(ENGINE, n_slots=2)
    out = serve(ContinuousBatchingEngine(tm, device="cpu", **kw), prompts, budget=1)
    assert [len(f.tokens) for f in out] == [1] * 6
    with pytest.raises(RuntimeError, match="block pool too small"):
        serve(JaxEngine(jm, params, **kw), prompts, budget=1)


def small_collector(**kw):
    from rl_tpu_torch.data.llm import SimpleTokenizer
    from rl_tpu_torch.envs.llm import DatasetChatEnv, arithmetic_dataset

    ds = arithmetic_dataset(32, max_operand=4)
    tok = SimpleTokenizer(ds.corpus())
    env = DatasetChatEnv(ds.prompts, tok, reward_fn=lambda h, t: 0.0, group_repeats=4,
                         max_prompt_len=16, seed=3)
    model = TransformerLM(TransformerConfig(vocab_size=max(tok.vocab_size, 64), d_model=32,
                                            n_layers=2, n_heads=4, d_ff=64, max_seq_len=32,
                                            dtype=torch.float32), device="cpu", seed=1)
    return LLMCollector(env, model, num_prompts=2, max_new_tokens=8, continuous_batching=True,
                        engine_slots=4, **kw), model


def test_collector_prefix_cache_hits_the_group_prompt():
    col, model = small_collector(engine_prefix_cache=True)
    batch = col.collect(seed=5)
    st = col._engine.stats()
    # 2 groups of 4 rows: every row after its group's first is an exact hit
    assert st["kv_prefix_exact_hits"] >= 4 and st["kv_prefix_hits"] >= 4
    assert batch["tokens"].shape[0] == 8 and bool(batch["assistant_mask"].any())


def test_collector_prefix_cache_matches_reference(monkeypatch):
    """One first collect through both packages' ``LLMCollector(
    engine_prefix_cache=True)``: the same env draw and flax weights, both
    engines greedy (the collectors build their engines without a greedy
    option, so the engines' constructors get it). Equal tokens, log-probs
    within 1e-4 (float32 summation order), and equal hit, exact-hit, fork,
    cached-token and charged-block counts."""
    import functools

    from rl_tpu.collectors import LLMCollector as JaxCollector
    from rl_tpu.data.llm.tokenizer import SimpleTokenizer as JaxTokenizer
    from rl_tpu.envs.llm import DatasetChatEnv as JaxChatEnv
    from rl_tpu.envs.llm import arithmetic_dataset as jax_arithmetic
    from rl_tpu_torch.data.llm import SimpleTokenizer
    from rl_tpu_torch.envs.llm import DatasetChatEnv, arithmetic_dataset

    for cls in (JaxEngine, ContinuousBatchingEngine):
        monkeypatch.setattr(cls, "__init__", functools.partialmethod(cls.__init__, greedy=True))
    jax_step = JaxEngine.step

    def synced_step(self):  # the schedule the port has on the CPU
        more = jax_step(self)
        jax.block_until_ready(self.dev_lens)
        return more

    monkeypatch.setattr(JaxEngine, "step", synced_step)

    env_kw = dict(reward_fn=lambda h, t: 0.0, group_repeats=4, max_prompt_len=16, seed=3)
    jds, ds = jax_arithmetic(32, max_operand=4), arithmetic_dataset(32, max_operand=4)
    jtok, tok = JaxTokenizer(jds.corpus()), SimpleTokenizer(ds.corpus())
    cfg = dict(vocab_size=max(tok.vocab_size, 64), d_model=32, n_layers=2, n_heads=4, d_ff=64,
               max_seq_len=32)
    jm = JaxLM(JaxConfig(**cfg, dtype=jnp.float32))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**cfg, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    col_kw = dict(num_prompts=2, max_new_tokens=8, continuous_batching=True, engine_slots=4,
                  engine_prefix_cache=True)
    jcol = JaxCollector(JaxChatEnv(jds.prompts, jtok, **env_kw), jm, **col_kw)
    col = LLMCollector(DatasetChatEnv(ds.prompts, tok, **env_kw), tm, **col_kw)
    ref = jcol.collect(params, jax.random.key(5))
    ours = col.collect(seed=5)
    assert jcol._engine.greedy and col._engine.greedy
    np.testing.assert_array_equal(ours["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(ours["assistant_mask"].numpy(),
                                  np.asarray(ref["assistant_mask"]))
    np.testing.assert_allclose(ours["sample_log_prob"].numpy(),
                               np.asarray(ref["sample_log_prob"]), atol=1e-4, rtol=0)
    st, jst = col._engine.stats(), jcol._engine.metrics_snapshot()
    for k in ("kv_prefix_hits", "kv_prefix_exact_hits", "kv_cow_copies_total",
              "kv_prefill_tokens_cached", "kv_blocks_charged_total", "prefill_tokens_computed"):
        assert st[k] == jst[k], k
    assert st["kv_prefix_exact_hits"] >= 4


def test_collector_prefix_cache_drops_stale_blocks_after_a_push():
    """A collect after the weights change equals a fresh collector's on the
    new weights: the tree from the earlier collect is not read."""
    col, model = small_collector(engine_prefix_cache=True)
    col.collect(seed=5)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    a = col.collect(seed=6)
    fresh, fm = small_collector(engine_prefix_cache=True)
    fm.load_state_dict(model.state_dict())
    fresh.env._rng = np.random.default_rng(3)
    fresh.env.sample_batch(2)  # the same env draw as the first collect
    b = fresh.collect(seed=6)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["sample_log_prob"], b["sample_log_prob"])
