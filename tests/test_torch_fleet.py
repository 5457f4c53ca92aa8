"""The port's ``ServingFleet`` against ``rl_tpu``'s engine and fleet, on
the CPU.

Greedy, float32, ``params_from_flax`` weights at the serving test's small
width: each request's tokens through a mixed fleet and through a
disaggregated one (a prefill member handing its KV to decode members)
equal the JAX engine's, log-probs within 1e-4. Every chaos path goes
through the seeded fault sites (``fleet.engine_crash.<idx>``,
``fleet.probe_drop``), and the invariant is the reference's: an admitted
request completes exactly once or is shed with ``retry_after``
(``accounting()["lost"] == 0``). Waits have timeouts and never order on
wall time; every fleet is shut down (its threads joined) in ``finally``.
The fleet registers its per-member sites in the port's ``SITES`` at run
time, as the reference does; the autouse fixture puts ``SITES`` back, so
the static table stays the reference's literal for the other tests of a
worker.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.models import (ContinuousBatchingEngine, FinishedRequest, ServiceSaturated,
                                 ServingFleet, ShedRequest, TransformerConfig, TransformerLM,
                                 params_from_flax)
from rl_tpu_torch.models.fleet import DEAD, HEALTHY
from rl_tpu_torch.obs import MetricsRegistry
from rl_tpu_torch.resilience import SITES, Fault, FaultInjector, Supervisor, injection
from test_torch_resilience import no_process_state  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=2, block_size=4, n_blocks=40, prompt_buckets=(8, 16), greedy=True)
LENGTHS = [3, 8, 12, 16, 5, 9]
BUDGETS = [9, 6, 12, 4, 10, 7]


@pytest.fixture(autouse=True)
def static_sites():
    before = dict(SITES)
    yield
    SITES.clear()
    SITES.update(before)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    # the reference's program registry starts a daemon thread for good at
    # a sampled dispatch: start it here, before the thread check of a test
    from rl_tpu.compile import registry as jax_registry

    jax_registry._ATTR._ensure_thread()
    return jm, params, tm


def prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], LENGTHS[i % 6]).astype(np.int32)
            for i in range(n)]


def reference(jm, params, ps, budgets):
    """The JAX engine's finished requests, in order (synced every step)."""
    eng = JaxEngine(jm, params, **ENGINE)
    rids = [eng.submit(p, b) for p, b in zip(ps, budgets)]
    while eng.step():
        jax.block_until_ready(eng.dev_lens)
    out = {f.rid: f for f in eng.finished}
    return [out[r] for r in rids]


def engines(tm, n, **kw):
    return [ContinuousBatchingEngine(tm, device="cpu", **dict(ENGINE, **kw)) for _ in range(n)]


def fleet_of(engs, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("probe_interval_s", 0.01)
    return ServingFleet(engs, **kw)


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.005)


def assert_matches(got, frids, ref):
    for frid, r in zip(frids, ref):
        f = got[frid]
        assert isinstance(f, FinishedRequest)
        np.testing.assert_array_equal(f.tokens, r.tokens)
        np.testing.assert_allclose(f.log_probs, r.log_probs, atol=1e-4, rtol=0)


@pytest.mark.parametrize("disaggregate", [False, True])
def test_fleet_matches_the_jax_engine(models, disaggregate):
    jm, params, tm = models
    ps, budgets = prompts(12), BUDGETS * 2
    ref = reference(jm, params, ps, budgets)
    if disaggregate:
        fl = fleet_of(engines(tm, 3, kv_handoff=True), disaggregate=True,
                      roles=["prefill", "decode", "decode"])
    else:
        fl = fleet_of(engines(tm, 3))
    fl.start()
    try:
        frids = [fl.submit(p, b, lane="interactive" if i % 3 else "batch")
                 for i, (p, b) in enumerate(zip(ps, budgets))]
        got = fl.wait(frids, timeout=120)
        assert_matches(got, frids, ref)
        acc = fl.accounting()
        assert acc == {"admitted": 12, "completed": 12, "shed_admission": 0,
                       "shed_post_admission": 0, "outstanding": 0, "redispatched": 0,
                       "duplicates_suppressed": 0, "lost": 0}
        stats = fl.request_stats()
        assert all(s["first_token_at"] is not None and s["first_token_at"] >= s["submitted_at"]
                   for s in stats)
        if disaggregate:  # the prefill member decodes nothing
            members = fl.metrics_snapshot()["members"]
            assert [m["role"] for m in members] == ["prefill", "decode", "decode"]
            assert fl._members[0].engine.decode_steps == 0
            assert all(fl._members[i].engine.decode_steps > 0 for i in (1, 2))
    finally:
        fl.shutdown()


def test_crash_of_member_1_completes_every_request_exactly_once(models):
    """``fleet.engine_crash.1`` fires at member 1's third busy iteration
    (its stepper has admitted and decoded by then): its requests fail over
    and every admitted request completes once, with the JAX engine's
    tokens."""
    jm, params, tm = models
    ps, budgets = prompts(6, seed=1), [24] * 6
    ref = reference(jm, params, ps, budgets)
    fl = fleet_of(engines(tm, 2))
    inj = FaultInjector({"fleet.engine_crash.1": Fault("crash", at=(3,))},
                        registry=MetricsRegistry())
    try:
        with injection(inj):
            fl.start()
            frids = [fl.submit(p, b) for p, b in zip(ps, budgets)]
            got = fl.wait(frids, timeout=120)
        assert [(s, k) for s, k, _ in inj.fired] == [("fleet.engine_crash.1", "crash")]
        assert_matches(got, frids, ref)
        acc = fl.accounting()
        assert acc["completed"] == 6 and acc["lost"] == 0 and acc["outstanding"] == 0
        assert acc["redispatched"] >= 1 and acc["duplicates_suppressed"] == 0
        snap = fl.metrics_snapshot()
        assert snap["crashes"] == 1
        assert snap["members"][1]["restarts"] == 1 and snap["members"][1]["quarantines"] == 1
        wait_until(lambda: fl.metrics_snapshot()["readmissions"] == 1, msg="re-admission")
    finally:
        fl.shutdown()


def test_quarantine_readmission_and_duplicate_suppression(models):
    """A dropped probe quarantines a live member mid-decode: its work is
    re-dispatched, one copy of the request is suppressed as a duplicate,
    the member is re-admitted and serves again."""
    _, _, tm = models
    engs = engines(tm, 2)
    fl = fleet_of(engs, quarantine_after=1, readmit_probes=2, readmit_backoff_s=0.01)
    try:
        fl.start()
        ps = prompts(2, seed=2)
        frids = [fl.submit(p, 56) for p in ps]
        wait_until(lambda: engs[0].pending() > 0 and engs[1].pending() > 0, msg="both busy")
        inj = FaultInjector({"fleet.probe_drop": Fault("drop", at=(1,))},
                            registry=MetricsRegistry())
        with injection(inj):
            wait_until(lambda: fl.metrics_snapshot()["quarantines"] == 1, msg="quarantine")
        got = fl.wait(frids, timeout=120)
        assert all(isinstance(r, FinishedRequest) for r in got.values())
        acc = fl.accounting()
        assert acc["completed"] == 2 and acc["lost"] == 0 and acc["redispatched"] >= 1
        wait_until(lambda: fl.accounting()["duplicates_suppressed"] >= 1, msg="duplicate")
        assert fl.accounting()["completed"] == 2
        wait_until(lambda: fl.metrics_snapshot()["readmissions"] == 1, msg="re-admission")
        assert all(m["state"] == HEALTHY for m in fl.metrics_snapshot()["members"])
        frid = fl.submit(ps[0], 4)
        assert isinstance(fl.wait([frid], timeout=60)[frid], FinishedRequest)
    finally:
        fl.shutdown()


def test_all_members_dead_sheds_the_queue(models):
    _, _, tm = models
    engs = engines(tm, 1)
    sup = Supervisor(name="t", max_restarts=1, backoff_base_s=0.001, backoff_max_s=0.002,
                     registry=MetricsRegistry())
    fl = fleet_of(engs, supervisor=sup, max_pending_per_engine=1)
    inj = FaultInjector({"fleet.engine_crash.0": Fault("crash", at=(1, 2))},
                        registry=MetricsRegistry())
    try:
        with injection(inj):  # crash, restart, crash: the budget is gone
            fl.start()
            frids = [fl.submit(p, 30) for p in prompts(3, seed=3)]
            got = fl.wait(frids, timeout=120)
        sheds = [r for r in got.values() if isinstance(r, ShedRequest)]
        assert sheds and all(s.retry_after == fl.retry_after_s for s in sheds)
        acc = fl.accounting()
        assert acc["completed"] + acc["shed_post_admission"] == 3 and acc["lost"] == 0
        assert fl.metrics_snapshot()["members"][0]["state"] == DEAD
        with pytest.raises(ServiceSaturated):
            fl.submit(prompts(1)[0], 4)
    finally:
        fl.shutdown()
        sup.stop()


def test_watermark_and_max_queue_shed_with_retry_after(models):
    _, _, tm = models
    fl = fleet_of(engines(tm, 1), admission_watermark=2.0, retry_after_s=0.125)
    with pytest.raises(ServiceSaturated) as ei:
        fl.submit(np.arange(4), 4)
    assert ei.value.retry_after == 0.125
    assert fl.accounting()["admitted"] == 0 and fl.accounting()["shed_admission"] == 1
    assert fl.metrics_snapshot()["shed"] == {"kv_watermark": 1}
    fl.shutdown()
    fl = fleet_of(engines(tm, 1), max_queue=1)  # not started: the first stays queued
    fl.submit(np.arange(4), 4)
    with pytest.raises(ServiceSaturated) as ei:
        fl.submit(np.arange(4), 4)
    assert ei.value.retry_after == fl.retry_after_s
    assert fl.metrics_snapshot()["shed"] == {"queue_full": 1}
    assert fl.accounting()["lost"] == 0
    with pytest.raises(ValueError, match="lane"):
        fl.submit(np.arange(4), 4, lane="bulk")
    with pytest.raises(ValueError, match="max_seq_len"):
        fl.submit(np.arange(8), 1000)
    with pytest.raises(ValueError, match="bucket"):
        fl.submit(np.arange(40), 4)
    fl.shutdown()


def test_interactive_lane_dispatches_before_batch(models):
    _, _, tm = models
    fl = fleet_of(engines(tm, 1))  # not started: the dispatcher pumped by hand
    b = fl.submit(np.arange(4), 4, lane="batch")
    i = fl.submit(np.arange(4), 4, lane="interactive")
    assert fl._dispatch_once()
    assert fl._tracked[i].state == "dispatched" and fl._tracked[b].state == "queued"
    assert fl._dispatch_once()
    assert fl._tracked[b].state == "dispatched"
    fl.shutdown()


def test_push_params_copies_into_each_member_in_place(models):
    """``push_params`` copies the weights into every routable member's own
    model (the objects stay, so captured graphs stay valid), under traffic:
    later requests see the new weights, and the pushed model is not
    aliased."""
    _, _, tm = models
    engs = engines(tm, 2)
    own = [TransformerLM(tm.cfg, device="cpu") for _ in engs]
    for e, m in zip(engs, own):
        m.load_state_dict(tm.state_dict())
        e.set_model(m)
    new = TransformerLM(tm.cfg, device="cpu")
    with torch.no_grad():
        for p, q in zip(new.parameters(), tm.parameters()):
            p.copy_(q * 1.01)
    solo = ContinuousBatchingEngine(new, device="cpu", **ENGINE)
    ps = prompts(4, seed=4)
    want = [solo.submit(p, 8) for p in ps]
    want = solo.run()
    fl = fleet_of(engs).start()
    try:
        before = [fl.submit(p, 8) for p in ps]
        assert fl.push_params(new) == 2
        fl.wait(before, timeout=60)
        assert [e.model for e in engs] == own
        assert all(torch.equal(a, b) for m in own
                   for a, b in zip(m.parameters(), new.parameters()))
        after = [fl.submit(p, 8) for p in ps]
        got = fl.wait(after, timeout=60)
        for frid, rid in zip(after, sorted(want)):
            np.testing.assert_array_equal(got[frid].tokens, want[rid].tokens)
        with torch.no_grad():
            next(new.parameters()).add_(1.0)  # the members do not alias it
        assert not torch.equal(next(own[0].parameters()), next(new.parameters()))
    finally:
        fl.shutdown()


def test_sites_gauges_and_one_device(models):
    _, _, tm = models
    reg = MetricsRegistry()
    fl = fleet_of(engines(tm, 2), registry=reg)
    assert "fleet.engine_crash.0" in SITES and "fleet.engine_crash.1" in SITES
    fl.submit(np.arange(4), 4, lane="batch")  # not started: queued
    text = reg.render()
    for line in ('rl_tpu_fleet_engine_health{engine="0"} 0',
                 'rl_tpu_fleet_lane_queue_depth{lane="batch"} 1',
                 'rl_tpu_fleet_lane_queue_depth{lane="interactive"} 0',
                 "rl_tpu_fleet_outstanding 1", "rl_tpu_fleet_admitted_total 1"):
        assert line in text, line
    assert "rl_tpu_fleet_free_kv_blocks" in text and "rl_tpu_slo_burn_rate" in text
    fl.shutdown()
    reg.render()  # the collectors are unregistered
    a, b = engines(tm, 2)
    b.device = torch.device("meta")  # a member on another device
    with pytest.raises(ValueError, match="one device"):
        ServingFleet([a, b], registry=MetricsRegistry())
    with pytest.raises(ValueError, match="ShapeBuckets"):
        ServingFleet([a, ContinuousBatchingEngine(tm, device="cpu",
                                                  **dict(ENGINE, prompt_buckets=(16,)))],
                     registry=MetricsRegistry())


def test_quantile_gauges_merge_member_histograms(models):
    _, _, tm = models
    reg = MetricsRegistry()
    fl = fleet_of(engines(tm, 2), registry=reg).start()
    try:
        frids = [fl.submit(p, 4) for p in prompts(6, seed=5)]
        fl.wait(frids, timeout=60)
        text = reg.render()
        for metric in ("rl_tpu_fleet_ttft_seconds", "rl_tpu_fleet_latency_seconds"):
            for q in ("0.5", "0.99"):
                line = next(ln for ln in text.splitlines()
                            if ln.startswith(f'{metric}{{quantile="{q}"}}'))
                assert float(line.split()[-1]) > 0.0
        assert sum(m.ttft_hist.snapshot()["count"] for m in fl._members) == 6
        assert fl.ttft_burn_rate(60.0) >= 0.0
        assert fl.kv_slack() == fl.kv_recount()
    finally:
        fl.shutdown()


def test_dispatch_never_waits_for_a_member_step(models):
    """The dispatcher queues a request on a member whose lock its stepper
    holds (as it does through a whole step): ``engine.submit`` takes only
    the engine's queue lock. And a request queued by another thread
    between a step's admission and its launch is served, not taken for
    one the pool cannot hold; a request the pool really cannot hold
    still raises."""
    import threading

    _, _, tm = models
    fl = fleet_of(engines(tm, 1))  # not started: the dispatcher pumped by hand
    try:
        frid = fl.submit(np.arange(4), 4)
        m = fl._members[0]
        done = []
        with m.lock:
            t = threading.Thread(target=lambda: done.append(fl._dispatch_once()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and done == [True]
            assert fl._tracked[frid].state == "dispatched" and m.engine.pending() == 1
    finally:
        fl.shutdown()

    eng = engines(tm, 1)[0]
    launch, late = eng._launch, []

    def launch_after_a_late_submit():
        if not late:  # as a dispatcher thread would, between _admit and _launch
            late.append(eng.submit(np.arange(6), 5))
        return launch()

    eng._launch = launch_after_a_late_submit
    assert eng.step()  # nothing admitted, nothing live, a request queued
    got = eng.run()
    assert list(got) == late and len(got[late[0]].tokens) == 5

    tiny = ContinuousBatchingEngine(tm, device="cpu", **dict(ENGINE, n_blocks=3))
    tiny.submit(np.arange(16), 4)
    with pytest.raises(RuntimeError, match="block pool too small"):
        tiny.step()


def test_failed_push_raises_and_a_partial_push_stops_a_collect(models):
    """A member whose weight copy fails makes ``push_params`` raise (a
    member that failed it would serve the old policy: its reset reloads
    nothing), and the collector's batch lane refuses a push that reached
    fewer members than are routable."""
    from rl_tpu_torch.collectors.llm import LLMCollector

    _, _, tm = models
    fl = fleet_of(engines(tm, 2))
    try:
        other = TransformerLM(TransformerConfig(**dict(SMALL, d_ff=64), dtype=torch.float32),
                              device="cpu")
        with pytest.raises(ValueError, match="config differs"):
            fl.push_params(other)
        col = LLMCollector(env=None, model=tm, num_prompts=1, max_new_tokens=4, fleet=fl,
                           fleet_timeout_s=30.0)
        fl.push_params = lambda model: 1
        toks = np.zeros((2, 8), np.int64)
        with pytest.raises(RuntimeError, match="reached 1 of 2 routable members"):
            col._fleet_generate(tm, toks, np.ones((2, 8), np.float32), seed=0)
        assert fl.accounting()["admitted"] == 0
    finally:
        fl.shutdown()
