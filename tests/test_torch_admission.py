"""The engine's admission as registered programs, against the JAX package,
on the CPU.

- The ladder: ``ContinuousBatchingEngine.aot_warmup()`` registers exactly
  the programs the reference's ``aot_warmup`` builds for the same
  configuration, with and without a prefix cache, over float and int8
  pools. The expected names come from ``rl_tpu.compile.ShapeBuckets``
  (``admit_sizes``, ``suffix_ladder``, ``program_count``) and the name
  formats in the reference engine's source; the reference's own
  ``aot_warmup`` is not run (it compiles XLA).
- ``ShapeBuckets.admit_sizes`` and ``program_count`` equal the reference's.
- Greedy parity: the port engine with a registry (on the CPU each program
  runs its body eagerly: the table gather inside the prefill, the padded
  copy ladder, the merge) gives the JAX engine's tokens, log-probs within
  1e-4, over float and int8 pools, with and without the prefix cache
  (whose rounds fork blocks copy-on-write); and the eager port engine's
  tokens and log-probs bit for bit. The JAX engine is synced after every
  step (its schedule otherwise depends on timing).
- A round of three copy-on-write pairs goes through the four-pair program
  (the last pair repeated) and leaves the pools as three eager copies do.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.compile import ShapeBuckets as JaxBuckets
from rl_tpu.kernels import registry as jax_kernel_registry
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry, ShapeBuckets, pow2ceil
from rl_tpu_torch.models import (ContinuousBatchingEngine, TransformerConfig, TransformerLM,
                                 params_from_flax)

torch.set_num_threads(1)

CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=65, prompt_buckets=(32, 64), eos_id=0,
              greedy=True)


@pytest.fixture(autouse=True)
def _reference_xla_read(monkeypatch):
    """The reference's stock read paths on the CPU, whatever the ambient
    kernel switches say."""
    monkeypatch.delenv(jax_kernel_registry.ENV_INTERPRET, raising=False)
    monkeypatch.delenv(jax_kernel_registry.ENV_NO_KERNELS, raising=False)


@pytest.fixture(scope="module")
def models():
    """Per pool type, the reference LM, its params and the port's LM with
    the same flax weights."""
    out = {}
    for kv_int8 in (False, True):
        jm = JaxLM(JaxConfig(**CFG, dtype=jnp.float32, kv_int8=kv_int8))
        params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
        tcfg = TransformerConfig(**CFG, dtype=torch.float32, kv_int8=kv_int8)
        tm = TransformerLM(tcfg, device="cpu")
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
        out[kv_int8] = (jm, params, tm)
    return out


def shared_prompts():
    """Six prompts behind one 21-token system prompt and two exact repeats
    of it: hits, exact hits and copy-on-write forks."""
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


def reference_formats() -> dict:
    """The program-name formats of the reference engine, read from its
    source (``serving.py``: decode, prefill, partial prefill, copy, merge)."""
    out = {}
    for key, method in (("decode", "_get_decode_prog"), ("prefill", "_get_prefill_prog"),
                        ("pprefill", "_get_pprefill_prog"), ("cow", "_get_cow_prog")):
        src = inspect.getsource(getattr(JaxEngine, method))
        (out[key],) = re.findall(r'f"(serving\.[^"]+)"', src)
    assert '"serving.admit_update"' in inspect.getsource(JaxEngine.__init__)
    out["merge"] = "serving.admit_update"
    return out


def expected_ladder(n_slots, prompt, suffix, chunk, prefix) -> set:
    """The reference's ``aot_warmup`` set for this configuration."""
    fmt, jb = reference_formats(), JaxBuckets(prompt=prompt, suffix=suffix)
    names = {fmt["decode"].format(chunk=chunk), fmt["merge"]}
    rungs = jb.suffix_ladder() if prefix else jb.prompt
    kind = "pprefill" if prefix else "prefill"
    prefills = {fmt[kind].format(a=a, bucket=b) for a in jb.admit_sizes(n_slots) for b in rungs}
    if not prefix:
        assert len(prefills) == jb.program_count(n_slots)
    names |= prefills
    if prefix:
        n = 1
        while n <= pow2ceil(n_slots):
            names.add(fmt["cow"].format(n=n))
            n *= 2
    return names


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float", "int8"])
def test_aot_warmup_registers_the_reference_ladder(models, prefix, kv_int8):
    tm = models[kv_int8][2]
    registry = ProgramRegistry(ExecutableStore())
    buckets = ShapeBuckets(prompt=(16, 32, 64), suffix=(4, 8))
    eng = ContinuousBatchingEngine(tm, n_slots=6, block_size=4, n_blocks=65, buckets=buckets,
                                   decode_chunk=4, device="cpu", prefix_cache=prefix,
                                   registry=registry)
    report = eng.aot_warmup()
    want = expected_ladder(6, (16, 32, 64), (4, 8), 4, prefix)
    assert set(registry.names()) == set(report) == want
    assert all(r == [("eager", 0.0)] for r in report.values())  # nothing to capture here
    prefills = [n for n in eng._programs if ".prefill." in n or ".pprefill." in n]
    assert len(prefills) == len(ShapeBuckets().admit_sizes(6)) * len(
        buckets.suffix_ladder() if prefix else buckets.prompt)


@pytest.mark.parametrize("cap", [1, 6, 8])
def test_admit_ladder_matches_the_reference(cap):
    ours = ShapeBuckets(prompt=(32, 128, 512))
    ref = JaxBuckets(prompt=(32, 128, 512))
    assert ours.admit_sizes(cap) == ref.admit_sizes(cap)
    assert ours.program_count(cap) == ref.program_count(cap)
    assert {ours.admit_bucket(n, cap) for n in range(1, cap + 1)} == set(ours.admit_sizes(cap))


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float", "int8"])
def test_registry_engine_matches_reference_and_eager_engine(models, prefix, kv_int8):
    jm, params, tm = models[kv_int8]
    kw = dict(ENGINE, decode_chunk=4, prefix_cache=prefix)
    prompts = shared_prompts()
    registry = ProgramRegistry(ExecutableStore())
    eng = ContinuousBatchingEngine(tm, device="cpu", registry=registry, **kw)
    ours = serve(eng, prompts)
    eager = serve(ContinuousBatchingEngine(tm, device="cpu", **kw), prompts)
    ref = serve(JaxEngine(jm, params, **kw), prompts)
    for a, e, r in zip(ours, eager, ref):
        np.testing.assert_array_equal(a.tokens, e.tokens)
        np.testing.assert_array_equal(a.log_probs, e.log_probs)
        np.testing.assert_array_equal(a.tokens, r.tokens)
        assert a.finished_reason == r.finished_reason
        np.testing.assert_allclose(a.log_probs, r.log_probs, atol=1e-4, rtol=0)
    stats = registry.stats()
    kind = "serving.pprefill" if prefix else "serving.prefill"
    assert sum(s["calls"] for n, s in stats.items() if n.startswith(kind)) == eng.prefill_rounds
    assert stats["serving.admit_update"]["calls"] > 0
    copies = sum(s["calls"] for n, s in stats.items() if n.startswith("serving.cowcopy"))
    if prefix:
        assert copies >= 1 and eng.stats()["kv_cow_copies_total"] >= 1
    else:
        assert copies == 0


def test_copy_ladder_pads_by_repeating_the_last_pair(models):
    tm = models[True][2]  # int8: the scales ride the copies too
    engines = [ContinuousBatchingEngine(tm, device="cpu", **ENGINE, registry=reg)
               for reg in (None, ProgramRegistry(ExecutableStore()))]
    gen = torch.Generator().manual_seed(0)
    for bufs in zip(*(e.pools for e in engines)):
        for a, b in zip(*bufs):
            fill = (torch.randint(-127, 128, a.shape, generator=gen, dtype=torch.int32)
                    .to(a.dtype) if a.dtype == torch.int8 else torch.rand(a.shape, generator=gen))
            a.copy_(fill)
            b.copy_(fill)
    cows = [(3, 9), (5, 11), (7, 13)]
    for e in engines:
        e._cow_copy(cows)
    for bufs in zip(*(e.pools for e in engines)):
        for a, b in zip(*bufs):
            assert torch.equal(a, b)
            assert torch.equal(a[torch.tensor([9, 11, 13])], a[torch.tensor([3, 5, 7])])
    assert list(engines[1]._programs) == ["serving.cowcopy.n4"]
    assert engines[1]._programs["serving.cowcopy.n4"].stats["calls"] == 1
