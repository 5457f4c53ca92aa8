"""Per-slot RNG streams (``slot_rng=True``) against the JAX package, on the CPU.

- The port's threefry (``rl_tpu_torch.models.speculative``): the key words
  of ``key(seed)``, ``fold_in`` and the reference's ``slot_keys`` and
  ``spec_keys``, the raw bits and the uniforms equal JAX's bit for bit;
  each of the gumbel noise's two logs is within 1 ulp of XLA's float32
  log, so the noise is within 2 eps * max(1, |g|) of
  ``jax.random.gumbel``'s.
- ``sample_tokens`` with per-row keys against the reference's per-row-key
  sampler on the same logits: equal tokens, log-probs within 1e-6.
- The engine with ``slot_rng=True`` against the JAX engine with
  ``slot_rng=True`` (the reference test's small model: vocab 97, d_model
  64, 2 layers, float32, flax weights through ``params_from_flax``),
  greedy and at temperature 0.7, with and without the prefix cache:
  equal tokens, log-probs within 1e-4. Sampled output depends only on
  (seed, rid): the same with other chunk sizes and slot counts, and the
  engine's generator is never drawn from.
- The slot-stream merge against the reference's ``_sadmit_update_fn``,
  and the slot-stream bodies under the host-read guard of
  ``test_torch_registry.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_registry import _NoHostReads

from rl_tpu.kernels import registry as jax_kernel_registry
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu.models.serving import _sadmit_update_fn
from rl_tpu.models.speculative import sample_tokens as jax_sample_tokens
from rl_tpu.models.speculative import slot_keys as jax_slot_keys
from rl_tpu.models.speculative import spec_keys as jax_spec_keys
from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
from rl_tpu_torch.models import (ContinuousBatchingEngine, TransformerConfig, TransformerLM,
                                 params_from_flax)
from rl_tpu_torch.models.serving import _sadmit_update
from rl_tpu_torch.models.speculative import (fold_in, key_from_seed, random_bits, row_gumbel,
                                             sample_tokens, slot_keys, spec_keys,
                                             uniform_from_bits)

torch.set_num_threads(1)

CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128)
ENGINE = dict(n_slots=2, block_size=8, n_blocks=65, prompt_buckets=(16,), seed=7)
EPS32 = float(np.finfo(np.float32).eps)
RIDS = np.array([0, 5, -1, 123456, 2**31 - 1, 3], np.int32)
NTOKS = np.array([0, 3, 0, 77, 1000, 65535], np.int32)


@pytest.fixture(autouse=True)
def _reference_xla_read(monkeypatch):
    """The reference's stock paths on the CPU, whatever the ambient kernel
    switches say."""
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


def _words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("seed", [0, 11, -1])
def test_key_words_equal_jax_bit_for_bit(seed):
    base = jax.random.key(seed)
    ours = key_from_seed(seed)
    np.testing.assert_array_equal(ours.numpy(), _words(base))
    rids, ntoks = torch.from_numpy(RIDS), torch.from_numpy(NTOKS)
    np.testing.assert_array_equal(
        fold_in(ours, rids).numpy(),
        _words(jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.asarray(RIDS))))
    np.testing.assert_array_equal(
        slot_keys(ours, rids, ntoks).numpy(),
        _words(jax_slot_keys(base, jnp.asarray(RIDS), jnp.asarray(NTOKS))))
    np.testing.assert_array_equal(
        spec_keys(ours, rids, ntoks, 5).numpy(),
        _words(jax_spec_keys(base, jnp.asarray(RIDS), jnp.asarray(NTOKS), 5)))


@pytest.mark.parametrize("n", [97, 32768])
def test_raw_bits_and_uniforms_equal_jax_bit_for_bit(n):
    base = jax.random.key(7)
    jkeys = jax_slot_keys(base, jnp.asarray(RIDS), jnp.asarray(NTOKS))
    keys = torch.from_numpy(_words(jkeys))
    bits = random_bits(keys, n)
    want = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jkeys)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want).astype(np.int64))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), jnp.float32, minval=tiny, maxval=1.0))(jkeys))
    u = uniform_from_bits(bits).numpy()
    np.testing.assert_array_equal(u.view(np.int32), want_u.view(np.int32))


def test_gumbel_noise_within_the_rounding_of_two_logs():
    jkeys = jax_slot_keys(jax.random.key(3), jnp.arange(16, dtype=jnp.int32),
                          jnp.arange(16, dtype=jnp.int32) * 5)
    keys = torch.from_numpy(_words(jkeys))
    u = uniform_from_bits(random_bits(keys, 32768))
    inner = -torch.log(u)
    want_inner = np.array(-jnp.log(jnp.asarray(u.numpy())))
    assert _ulps(inner.numpy(), want_inner) <= 1
    want_outer = np.asarray(-jnp.log(jnp.asarray(want_inner)))
    assert _ulps((-torch.log(torch.from_numpy(want_inner))).numpy(), want_outer) <= 1
    g = row_gumbel(keys, 32768).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (32768,), jnp.float32))(jkeys))
    assert np.isfinite(g).all()
    assert (np.abs(g - want) <= 2 * EPS32 * np.maximum(1.0, np.abs(want))).all()


@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sample_tokens_with_row_keys_matches_the_reference_sampler(temperature):
    logits = np.asarray(jax.random.normal(jax.random.key(5), (6, 97)), np.float32) * 3
    jkeys = jax_slot_keys(jax.random.key(1), jnp.asarray(RIDS), jnp.asarray(NTOKS))
    want_tok, want_lp = jax_sample_tokens(jnp.asarray(logits), jkeys, temperature=temperature,
                                          greedy=False)
    tok, lp = sample_tokens(torch.from_numpy(logits), torch.from_numpy(_words(jkeys)),
                            temperature=temperature, greedy=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-6, rtol=0)
    # each row draws from its own stream: row by row gives the same
    for i in range(6):
        ti, li = sample_tokens(torch.from_numpy(logits[i:i + 1]),
                               torch.from_numpy(_words(jkeys))[i:i + 1],
                               temperature=temperature, greedy=False)
        assert int(ti[0]) == int(tok[i]) and float(li[0]) == float(lp[i])


def test_slot_stream_merge_matches_the_reference():
    rng = np.random.default_rng(0)
    S = 6
    state = [rng.integers(0, 50, S).astype(np.int32), rng.random(S) < 0.5,
             rng.integers(0, 9, S).astype(np.int32), rng.integers(0, 97, S).astype(np.int32),
             rng.integers(-1, 9, S).astype(np.int32), rng.integers(0, 30, S).astype(np.int32)]
    new = [rng.random(S) < 0.5] + [rng.integers(0, 90, S).astype(np.int32) for _ in range(4)]
    want = _sadmit_update_fn(*map(jnp.asarray, state + new))
    args = [torch.from_numpy(a) for a in state + new]
    with _NoHostReads():
        got = _sadmit_update(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[5].numpy()[new[0]] == 1).all()


def _prompts(system=0, n=5):
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 97, system)
    return [np.concatenate([sysp, rng.integers(1, 97, int(k))]).astype(np.int32)
            for k in np.linspace(3, 12, n).astype(int)]


def _serve(engine, prompts, budget=10):
    rids = [engine.submit(p, budget) for p in prompts]
    while engine.step():
        if isinstance(engine, JaxEngine):  # the schedule the port has on the CPU
            jax.block_until_ready(engine.dev_lens)
    out = {f.rid: f for f in engine.finished}
    engine.finished.clear()
    return [out[r] for r in rids]


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "t0.7"])
def test_slot_rng_engine_matches_the_jax_engine(models, greedy, prefix):
    jm, params, tm = models
    kw = dict(ENGINE, greedy=greedy, temperature=0.7, slot_rng=True, prefix_cache=prefix,
              decode_chunk=4)
    prompts = _prompts(system=4 if prefix else 0)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    ref_eng = JaxEngine(jm, params, **kw)
    for _ in range(2):  # the second round behind the first one's tree, and new rids
        ours, ref = _serve(eng, prompts), _serve(ref_eng, prompts)
        for a, r in zip(ours, ref):
            np.testing.assert_array_equal(a.tokens, r.tokens)
            assert a.finished_reason == r.finished_reason
            np.testing.assert_allclose(a.log_probs, r.log_probs, atol=1e-4, rtol=0)
    if prefix:
        assert eng.stats()["kv_prefix_hits"] > 0


def test_sampled_slot_streams_ignore_the_schedule_and_the_generator(models):
    tm = models[2]
    prompts = _prompts(n=6)
    runs = []
    for n_slots, chunk in ((2, 1), (4, 4), (6, 2)):
        eng = ContinuousBatchingEngine(tm, device="cpu", **dict(
            ENGINE, n_slots=n_slots, decode_chunk=chunk, slot_rng=True, temperature=0.9))
        before = eng._gen.get_state()
        runs.append(_serve(eng, prompts))
        assert torch.equal(eng._gen.get_state(), before)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    # the default stream draws from the generator and gives other samples
    plain = ContinuousBatchingEngine(tm, device="cpu", **dict(ENGINE, temperature=0.9))
    before = plain._gen.get_state()
    sampled = _serve(plain, prompts)
    assert not torch.equal(plain._gen.get_state(), before)
    assert any(not np.array_equal(a.tokens, b.tokens) for a, b in zip(runs[0], sampled))


def test_slot_rng_registry_engine_equals_the_eager_engine(models):
    tm = models[2]
    registry = ProgramRegistry(ExecutableStore())
    kw = dict(ENGINE, slot_rng=True, temperature=0.8, decode_chunk=4, prefix_cache=True)
    prompts = _prompts(system=4)
    eager = ContinuousBatchingEngine(tm, device="cpu", **kw)
    graphed = ContinuousBatchingEngine(tm, device="cpu", registry=registry, warmup=True, **kw)
    for _ in range(2):
        for a, b in zip(_serve(eager, prompts), _serve(graphed, prompts)):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.log_probs, b.log_probs)
    names = registry.names()
    assert "serving.sdecode.k4" in names and "serving.sadmit_update" in names
    assert not any(n.startswith(("serving.decode.", "serving.pprefill.", "serving.admit_"))
                   for n in names)
    assert registry.stats()["serving.sdecode.k4"]["calls"] > 0


def test_slot_stream_bodies_read_nothing_on_the_host(models):
    """The slot-stream prefill (with and without a cached prefix) and the
    decode chunk, each body a CUDA graph captures, on the CPU."""
    tm = models[2]
    for prefix in (False, True):
        eng = ContinuousBatchingEngine(tm, device="cpu", slot_rng=True, prefix_cache=prefix,
                                       **ENGINE)
        eng.dev_table[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
        eng.dev_table[1, :2] = torch.tensor([4, 5], dtype=torch.int32)
        tokens = torch.randint(1, 97, (2, 8), dtype=torch.int32)
        mask = torch.ones((2, 8), dtype=torch.bool)
        mask[1, 5:] = False
        args = [eng.model, eng.dev_table, torch.tensor([0, 1]), tokens, mask,
                torch.tensor([4, -1], dtype=torch.int32), eng._base_key]
        if prefix:
            args.append(torch.tensor([4, 0], dtype=torch.int32))
        with _NoHostReads():
            eng._sprefill_body(*args)
        eng.dev_lens[:] = torch.tensor([5, 3], dtype=torch.int32)
        eng.dev_active[:] = True
        eng.dev_budget[:] = 4
        with _NoHostReads():
            out = eng._decode_body(3, *eng._state_args(), eng._dev_run, *eng._stream_args())
        assert out[6].tolist() == [3, 3]
