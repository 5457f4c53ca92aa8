"""The port's KV handoff (``kv_handoff=True``: ``prefill_detached`` and
``adopt_handoff``) against ``rl_tpu``'s, on the CPU.

Same flax weights (``params_from_flax``), float32, greedy, the serving
test's small width. A detached prefill gives the reference's prompt and
first token, its first log-prob within 1e-4 and the KV blocks it read
back within 1e-5 (float32 pools) or, over int8 pools, the int8 codes as
the writes round them: at most one step apart, where the float32 value
lies on a rounding edge. A code one step apart in a layer moves the next
layer's K/V, its scale and the first log-prob (read through the codes) by
more than float32 rounding, so over int8 pools those are held within 1e-3
(relative for the scales). Each
package adopts the other's handoff and decodes the reference's tokens.
A JAX engine is synced after every step, as in the other engine tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.models import (ContinuousBatchingEngine, KVHandoff, TransformerConfig,
                                 TransformerLM, params_from_flax)

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16), greedy=True)
LENGTHS = [3, 8, 12, 16, 5, 9]
BUDGETS = [9, 6, 12, 4, 10, 7]


def make_models(kv_int8=False):
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32, kv_int8=kv_int8)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, dtype=torch.float32, kv_int8=kv_int8)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def int8_models():
    return make_models(kv_int8=True)


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SMALL["vocab_size"], n).astype(np.int32) for n in LENGTHS]


def drain(engine):
    """Step ``engine`` to the end (a JAX engine synced after every step)
    and return its finished requests by rid."""
    while engine.step():
        if isinstance(engine, JaxEngine):
            jax.block_until_ready(engine.dev_lens)
    out = {f.rid: f for f in engine.finished}
    engine.finished.clear()
    return out


def adopt_all(engine, handoffs):
    """Adopt each handoff in order, stepping ``engine`` while it has no
    room; returns the engine rid of each."""
    rids = []
    for h in handoffs:
        rid = engine.adopt_handoff(h)
        while rid is None:
            engine.step()
            if isinstance(engine, JaxEngine):
                jax.block_until_ready(engine.dev_lens)
            rid = engine.adopt_handoff(h)
        rids.append(rid)
    return rids


def reference_tokens(jm, params):
    eng = JaxEngine(jm, params, **ENGINE)
    rids = [eng.submit(p, b) for p, b in zip(prompts(), BUDGETS)]
    out = drain(eng)
    return [out[r] for r in rids]


def port_engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", kv_handoff=True, **ENGINE, **kw)


def jax_engine(jm, params):
    return JaxEngine(jm, params, kv_handoff=True, **ENGINE)


def test_engine_builds_with_kv_handoff_and_keeps_its_refusals(models):
    """The option the port used to refuse: it builds, serves as the plain
    engine, and raises where the reference raises."""
    jm, params, tm = models
    eng = port_engine(tm)
    assert eng.kv_handoff
    rids = [eng.submit(p, b) for p, b in zip(prompts(), BUDGETS)]
    out = drain(eng)
    for rid, ref in zip(rids, reference_tokens(jm, params)):
        np.testing.assert_array_equal(out[rid].tokens, ref.tokens)
    with pytest.raises(ValueError, match="kv_handoff does not compose"):
        port_engine(tm, speculative=True)
    with pytest.raises(ValueError, match="prefix_cache=False"):
        port_engine(tm, prefix_cache=True)
    plain = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(RuntimeError, match="kv_handoff=True"):
        plain.prefill_detached(prompts()[0], 4)
    with pytest.raises(NotImplementedError, match="params_sharding=.*ROADMAP A7"):
        ContinuousBatchingEngine(tm, device="cpu", params_sharding=object(), **ENGINE)


def test_prefill_detached_matches_the_reference_s(models):
    jm, params, tm = models
    ours, ref = port_engine(tm), jax_engine(jm, params)
    for p, b in zip(prompts(), BUDGETS):
        a, r = ours.prefill_detached(p, b), ref.prefill_detached(p, b)
        assert isinstance(a, KVHandoff) and a.finished is None
        np.testing.assert_array_equal(a.prompt, r.prompt)
        assert (a.first_token, a.budget, a.lens, a.block_size) == (
            r.first_token, r.budget, r.lens, r.block_size)
        assert abs(a.first_lp - r.first_lp) <= 1e-4
        assert len(a.kv) == len(r.kv) == SMALL["n_layers"]
        for la, lr in zip(a.kv, r.kv):
            assert len(la) == len(lr) == 2
            for fa, fr in zip(la, lr):
                fr = np.asarray(fr)
                assert fa.shape == fr.shape and fa.dtype == fr.dtype == np.float32
                # positions past the prompt in its last block hold whatever
                # an earlier request left: compare the prompt's positions
                flat_a = fa.transpose(0, 2, 1, 3).reshape(-1, *fa.shape[1:2], fa.shape[3])
                flat_r = fr.transpose(0, 2, 1, 3).reshape(-1, *fr.shape[1:2], fr.shape[3])
                np.testing.assert_allclose(flat_a[: a.lens], flat_r[: a.lens], atol=1e-5, rtol=0)
    # every borrowed block went back
    assert len(ours.free_blocks) == ENGINE["n_blocks"] - 1
    assert ours.pending() == 0


def test_int8_handoff_fields_match_the_reference_s(int8_models):
    jm, params, tm = int8_models
    ours, ref = port_engine(tm), jax_engine(jm, params)
    codes = flips = 0
    for p, b in zip(prompts(), BUDGETS):
        a, r = ours.prefill_detached(p, b), ref.prefill_detached(p, b)
        # the prefill reads its own int8 writes, so a code one step apart
        # moves the first log-prob by more than float32 rounding does
        assert a.first_token == r.first_token and abs(a.first_lp - r.first_lp) <= 1e-3
        for la, lr in zip(a.kv, r.kv):
            assert len(la) == len(lr) == 4
            pk, pv, sk, sv = la
            rk, rv, rsk, rsv = (np.asarray(x) for x in lr)
            assert pk.dtype == np.int8 and sk.dtype == np.float32
            np.testing.assert_allclose(sk, rsk, rtol=1e-3, atol=0)
            np.testing.assert_allclose(sv, rsv, rtol=1e-3, atol=0)
            for x, y in ((pk, rk), (pv, rv)):
                d = np.abs(x.astype(np.int32) - y.astype(np.int32))
                assert d.max() <= 1
                codes += d.size
                flips += int((d > 0).sum())
    assert flips <= codes // 1000, (flips, codes)


def test_port_adopts_the_reference_s_handoff(models):
    jm, params, tm = models
    ref_prefill, ours = jax_engine(jm, params), port_engine(tm)
    rids = adopt_all(ours, [ref_prefill.prefill_detached(p, b)
                            for p, b in zip(prompts(), BUDGETS)])
    out = drain(ours)
    ref = reference_tokens(jm, params)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid].tokens, ref[i].tokens)
        np.testing.assert_allclose(out[rid].log_probs, ref[i].log_probs, atol=1e-4, rtol=0)


def test_reference_adopts_the_port_s_handoff(models):
    jm, params, tm = models
    prefill, ref_decode = port_engine(tm), jax_engine(jm, params)
    rids = adopt_all(ref_decode, [prefill.prefill_detached(p, b)
                                  for p, b in zip(prompts(), BUDGETS)])
    out = drain(ref_decode)
    ref = reference_tokens(jm, params)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid].tokens, ref[i].tokens)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_handoff_roundtrip_equals_one_engine(models, int8_models, kv_int8):
    """Prefill on one port engine, decode on another: the tokens and
    log-probs of one engine serving the request, float32 or int8 pools.
    Each request runs on fresh engines: over int8 pools a freed block
    keeps its scale (scales only grow), so a reused block would read other
    codes of the same values."""
    tm = (int8_models if kv_int8 else models)[2]
    for p, b in zip(prompts(), BUDGETS):
        one = port_engine(tm)
        rid = one.submit(p, b)
        plain = drain(one)[rid]
        dec = port_engine(tm)
        erid = dec.adopt_handoff(port_engine(tm).prefill_detached(p, b))
        out = drain(dec)[erid]
        np.testing.assert_array_equal(out.tokens, plain.tokens)
        np.testing.assert_allclose(out.log_probs, plain.log_probs, atol=1e-5, rtol=0)
        assert len(dec.free_blocks) == ENGINE["n_blocks"] - 1


def test_one_token_budget_finishes_at_prefill(models):
    jm, params, tm = models
    ours, ref = port_engine(tm), jax_engine(jm, params)
    a, r = ours.prefill_detached(prompts()[1], 1), ref.prefill_detached(prompts()[1], 1)
    assert a.finished is not None and a.kv == () and a.budget == 0
    assert a.finished.finished_reason == r.finished.finished_reason == "length"
    np.testing.assert_array_equal(a.finished.tokens, r.finished.tokens)
    with pytest.raises(ValueError, match="already finished"):
        port_engine(tm).adopt_handoff(a)
    eos = int(a.first_token)
    e = ContinuousBatchingEngine(tm, device="cpu", kv_handoff=True,
                                 **dict(ENGINE, eos_id=eos))
    h = e.prefill_detached(prompts()[1], 5)
    assert h.finished.finished_reason == "eos" and e.completions["eos"] == 1


def test_no_room_returns_none_and_leaks_nothing(models):
    _, _, tm = models
    pre = ContinuousBatchingEngine(tm, device="cpu", kv_handoff=True,
                                   **dict(ENGINE, n_blocks=4))
    assert pre.prefill_detached(prompts()[3], 4) is None  # 16 + 1 tokens: 5 blocks
    assert len(pre.free_blocks) == 3 and (pre.table == -1).all()
    dec = ContinuousBatchingEngine(tm, device="cpu", kv_handoff=True,
                                   **dict(ENGINE, n_slots=1))
    h = port_engine(tm).prefill_detached(prompts()[1], 6)
    assert dec.adopt_handoff(h) is not None
    assert dec.adopt_handoff(h) is None  # its one slot is taken
    bad = dataclasses.replace(h, block_size=8)
    with pytest.raises(ValueError, match="block_size"):
        port_engine(tm).adopt_handoff(bad)


def test_bfloat16_handoff_holds_cpu_tensors(models):
    """numpy has no bfloat16: a bfloat16 engine's handoff holds CPU
    tensors, and another bfloat16 engine adopts it to the same tokens."""
    _, _, tm = models
    cfg = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    bm = TransformerLM(cfg, device="cpu")
    bm.load_state_dict({k: v.to(torch.bfloat16) for k, v in tm.state_dict().items()})
    one = port_engine(bm)
    rid = one.submit(prompts()[2], 8)
    plain = drain(one)[rid]
    h = port_engine(bm).prefill_detached(prompts()[2], 8)
    assert all(isinstance(f, torch.Tensor) and f.dtype == torch.bfloat16
               for layer in h.kv for f in layer)
    dec = port_engine(bm)
    erid = dec.adopt_handoff(h)
    np.testing.assert_array_equal(drain(dec)[erid].tokens, plain.tokens)
