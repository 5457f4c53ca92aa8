"""The port's continuous-batching engine against the JAX engine, on the CPU.

Same flax-initialized weights (``params_from_flax``), same prompts, float32,
greedy decoding: 6 requests of mixed lengths through 4 slots (so slots are
refilled), an ``eos_id`` that some requests hit, ``decode_chunk`` 1 and 4,
and once with grouped KV heads (GQA).
Tokens and ``finished_reason`` must be identical, log-probs within 1e-4
(the two read the paged cache with different summation orders). Sampled
decoding draws from torch's generator, not threefry, so it is held to its
own seed: the same seed reproduces a run exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.models import (
    ContinuousBatchingEngine,
    TransformerConfig,
    TransformerLM,
    params_from_flax,
)

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16))
LENGTHS = [3, 8, 12, 16, 5, 9]
BUDGETS = [9, 6, 12, 4, 10, 7]


def make_models(n_kv_heads=None):
    jcfg = JaxConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=jnp.float32)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return make_models()


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SMALL["vocab_size"], n).astype(np.int32) for n in LENGTHS]


def serve(engine):
    rids = [engine.submit(p, b) for p, b in zip(prompts(), BUDGETS)]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def eos_id(models):
    """A token the greedy run emits mid-sequence, so some requests stop on
    eos and the others on length."""
    _, _, tm = models
    out = serve(ContinuousBatchingEngine(tm, greedy=True, device="cpu", **ENGINE))
    return int(out[0].tokens[3])


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_greedy_matches_jax_engine(models, eos_id, decode_chunk):
    jm, params, tm = models
    kw = dict(ENGINE, eos_id=eos_id, greedy=True, decode_chunk=decode_chunk)
    ref = serve(JaxEngine(jm, params, **kw))
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    out = serve(eng)
    reasons = [f.finished_reason for f in out]
    assert "eos" in reasons and "length" in reasons
    assert eng.admissions == len(LENGTHS) > ENGINE["n_slots"]  # slots were refilled
    for f, r in zip(out, ref):
        np.testing.assert_array_equal(f.tokens, r.tokens)
        assert f.finished_reason == r.finished_reason
        np.testing.assert_allclose(f.log_probs, r.log_probs, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(f.prompt, r.prompt)


def test_greedy_gqa_matches_jax_engine():
    jm, params, tm = make_models(n_kv_heads=2)
    kw = dict(ENGINE, greedy=True, decode_chunk=4)
    ref = serve(JaxEngine(jm, params, **kw))
    out = serve(ContinuousBatchingEngine(tm, device="cpu", **kw))
    for f, r in zip(out, ref):
        np.testing.assert_array_equal(f.tokens, r.tokens)
        np.testing.assert_allclose(f.log_probs, r.log_probs, atol=1e-4, rtol=0)


def test_auto_chunk_matches_fixed_chunk(models, eos_id):
    _, _, tm = models
    kw = dict(ENGINE, eos_id=eos_id, greedy=True, device="cpu")
    fixed = serve(ContinuousBatchingEngine(tm, decode_chunk=1, **kw))
    auto = serve(ContinuousBatchingEngine(tm, decode_chunk="auto", **kw))
    for a, b in zip(auto, fixed):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.log_probs, b.log_probs)


def test_sampled_run_is_reproducible_from_its_seed(models):
    _, _, tm = models

    def run(seed):
        eng = ContinuousBatchingEngine(
            tm, greedy=False, temperature=0.8, seed=seed, decode_chunk=4,
            device="cpu", **ENGINE,
        )
        return serve(eng)

    a, b, c = run(5), run(5), run(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        np.testing.assert_array_equal(x.log_probs, y.log_probs)
    assert any(not np.array_equal(x.tokens, z.tokens) for x, z in zip(a, c))
    for f, budget in zip(a, BUDGETS):
        assert len(f.tokens) == budget
        assert np.all(np.isfinite(f.log_probs)) and np.all(f.log_probs <= 0)


def test_reset_and_harvest(models):
    _, _, tm = models
    eng = ContinuousBatchingEngine(tm, greedy=True, decode_chunk=2, device="cpu", **ENGINE)
    first = serve(eng)
    for p, b in zip(prompts(), BUDGETS):
        eng.submit(p, b)
    eng.step()
    eng.reset()
    assert eng.queue == [] and (eng.slot_rid == -1).all()
    assert len(eng.free_blocks) == ENGINE["n_blocks"] - 1
    rids = [eng.submit(p, b) for p, b in zip(prompts(), BUDGETS)]
    got = {}
    while eng.step():
        got.update(eng.harvest())
    got.update(eng.harvest())
    for r, f in zip(rids, first):
        np.testing.assert_array_equal(got[r].tokens, f.tokens)


def test_engine_never_moves_to_the_cpu_by_itself(models):
    """The default device is the card: without one (or with the weights
    elsewhere) the engine raises instead of running on the CPU."""
    _, _, tm = models
    with pytest.raises((RuntimeError, ValueError)):
        ContinuousBatchingEngine(tm, **ENGINE)
    with pytest.raises((RuntimeError, ValueError)):
        ContinuousBatchingEngine(tm, device="cuda", **ENGINE)


def test_shape_buckets_match_the_reference():
    from rl_tpu.compile import ShapeBuckets as JaxBuckets
    from rl_tpu_torch.compile import ShapeBuckets, pow2ceil

    ours, ref = ShapeBuckets(prompt=(8, 16, 64)), JaxBuckets(prompt=(8, 16, 64))
    for n in range(1, 65):
        assert ours.prompt_bucket(n) == ref.prompt_bucket(n)
    for cap in (1, 3, 4, 8):
        for n in range(1, cap + 1):
            assert ours.admit_bucket(n, cap) == ref.admit_bucket(n, cap)
    assert [pow2ceil(n) for n in range(6)] == [1, 1, 2, 4, 4, 8]
    for bad in (lambda: ours.prompt_bucket(65), lambda: ours.admit_bucket(0, 4),
                lambda: ShapeBuckets(prompt=(16, 8))):
        with pytest.raises(ValueError):
            bad()
