"""The port's ``Autoscaler`` and the fleet's elastic membership against
``rl_tpu``'s, on the CPU.

The control loop is held to the reference's decision by decision: both
packages' ``Autoscaler`` poll the reference tests' ``_FakeFleet`` shape
(``tests/test_autoscale.py``) on the same clock (``poll_once(now=...)``),
and give the same decision trail, counters and raises. The live parts run
on the port's fleet of small float32 engines with ``params_from_flax``
weights: scale-up under traffic (its capture delta equals the new
member's ladder: 0 here, where the CPU runs every program eagerly),
scale-down draining through the exactly-once failover path, the KV
counters against a recount after a join, a leave and a crash, the live
control thread, and the collector riding the fleet's batch lane. Every
wait has a timeout and every fleet and loop is stopped in ``finally``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import Autoscaler as JaxAutoscaler
from rl_tpu.models import AutoscalerConfig as JaxAutoscalerConfig
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from rl_tpu_torch.collectors.llm import LLMCollector
from rl_tpu_torch.models import (Autoscaler, AutoscalerConfig, ContinuousBatchingEngine,
                                 FinishedRequest, ServingFleet, TransformerConfig, TransformerLM,
                                 params_from_flax)
from rl_tpu_torch.models.fleet import HEALTHY, QUARANTINED, RETIRED
from rl_tpu_torch.obs import MetricsRegistry
from rl_tpu_torch.resilience import SITES, Fault, FaultInjector, injection
from test_torch_resilience import no_process_state  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=2, block_size=4, n_blocks=40, prompt_buckets=(8, 16), greedy=True)


@pytest.fixture(autouse=True)
def static_sites():
    before = dict(SITES)
    yield
    SITES.clear()
    SITES.update(before)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, dtype=torch.float32)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return tm


def engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **dict(ENGINE, **kw))


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


def prompt(rng, n=8):
    return rng.integers(0, SMALL["vocab_size"], n).astype(np.int32)


# -- the control loop on the reference tests' fake fleet -----------------------


class FakeFleet:
    """The reference tests' deterministic fleet double
    (``tests/test_autoscale.py``'s ``_FakeFleet``)."""

    def __init__(self, burn=0.0, free=100, total=100, n=2):
        self.burn, self.free, self.total, self.n = burn, free, total, n
        self.adds, self.downs = 0, 0
        self.compile_delta = 0
        self.down_result = True

    def ttft_burn_rate(self, window_s):
        return self.burn

    def kv_slack(self):
        return self.free, self.total

    def n_routable(self):
        return self.n

    def add_member(self, engine, *, warm=True, role="mixed"):
        self.adds += 1
        self.n += 1
        return {"event": "scale_up", "idx": self.n - 1, "role": role, "warm": warm,
                "compile_delta": self.compile_delta, "by_program": {}, "t": 0.0}

    def scale_down(self, idx=None, *, reason="scale_down"):
        if not self.down_result:
            return None
        self.downs += 1
        self.n -= 1
        return {"event": "scale_down", "idx": self.n, "reason": reason,
                "outstanding_redispatched": 0, "salvaged": 0, "t": 0.0}


def _polls(fl, a, steps):
    """Run ``steps`` ((now, fleet changes) pairs): each poll's decision,
    or the error it raised, in the fields both packages record."""
    keys = ("action", "member", "burn", "free_frac", "members_before", "compile_delta", "error")
    trail = []
    for now, change in steps:
        for k, v in change.items():
            setattr(fl, k, v)
        try:
            dec = a.poll_once(now=now)
        except RuntimeError as e:
            trail.append(("raised", str(e).split(":")[0]))
            continue
        trail.append(None if dec is None else tuple(dec.get(k) for k in keys))
    snap = a.snapshot()
    return trail, {k: snap[k] for k in ("polls", "scale_ups", "scale_downs", "failures",
                                        "last_burn", "last_free_frac")}, (fl.adds, fl.downs)


def _bad_factory():
    raise OSError("no capacity")


# name: (fake fleet, config, polls as (now, changes), factory)
SCENARIOS = {
    "scale_up_on_burn": (dict(burn=5.0, free=10, total=100, n=1),
                         dict(scale_up_burn=2.0, max_members=4), [(100.0, {})], None),
    "no_scale_up_at_max_members": (dict(burn=5.0, free=10, total=100, n=4),
                                   dict(scale_up_burn=2.0, max_members=4), [(100.0, {})], None),
    "cooldown_gates_consecutive_actions": (
        dict(burn=5.0, free=10, total=100, n=1), dict(scale_up_burn=2.0, cooldown_s=5.0),
        [(100.0, {}), (102.0, {}), (106.0, {})], None),
    "scale_down_needs_sustained_slack": (
        dict(burn=0.0, free=90, total=100, n=3),
        dict(scale_down_free_frac=0.6, scale_down_sustain_s=10.0, cooldown_s=0.0),
        [(100.0, {}), (105.0, {}), (109.0, {"free": 10}), (112.0, {"free": 90}), (119.0, {}),
         (123.0, {})], None),
    "burn_blocks_scale_down_despite_kv_slack": (
        dict(burn=1.0, free=100, total=100, n=3),
        dict(scale_up_burn=2.0, scale_down_free_frac=0.6, scale_down_sustain_s=1.0,
             scale_down_max_burn=0.25, cooldown_s=0.0),
        [(100.0, {}), (102.0, {}), (104.0, {}), (106.0, {"burn": 0.0}), (108.0, {})], None),
    "scale_down_respects_min_members": (
        dict(burn=0.0, free=100, total=100, n=1),
        dict(min_members=1, scale_down_sustain_s=0.0, cooldown_s=0.0),
        [(100.0, {}), (101.0, {})], None),
    "scale_down_skipped": (
        dict(burn=0.0, free=100, total=100, n=2),
        dict(scale_down_sustain_s=0.0, cooldown_s=0.0),
        [(100.0, {"down_result": False}), (101.0, {})], None),
    "noncompilefree_scale_up_raises": (
        dict(burn=5.0, free=10, total=100, n=1), dict(scale_up_burn=2.0),
        [(100.0, {"compile_delta": 3})], None),
    "factory_failure_counts_and_starts_cooldown": (
        dict(burn=5.0, free=10, total=100, n=1), dict(scale_up_burn=2.0, cooldown_s=5.0),
        [(100.0, {}), (101.0, {})], _bad_factory),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decision_trail_is_the_reference_s(scenario):
    fake, cfg, steps, factory = SCENARIOS[scenario]
    cfg = dict({"cooldown_s": 5.0, "scale_down_sustain_s": 10.0}, **cfg)
    runs = []
    for cls, cfg_cls, reg in ((Autoscaler, AutoscalerConfig, MetricsRegistry()),
                              (JaxAutoscaler, JaxAutoscalerConfig, JaxMetricsRegistry())):
        fl = FakeFleet(**fake)
        a = cls(fl, engine_factory=factory or (lambda: object()), config=cfg_cls(**cfg),
                registry=reg)
        runs.append(_polls(fl, a, steps))
    assert runs[0] == runs[1]


def test_config_from_env_is_the_reference_s(monkeypatch):
    monkeypatch.setenv("RL_TPU_AUTOSCALE_UP_BURN", "7.5")
    monkeypatch.setenv("RL_TPU_AUTOSCALE_MAX", "9")
    monkeypatch.setenv("RL_TPU_AUTOSCALE_SUSTAIN_S", "bogus")
    ours, ref = (AutoscalerConfig.from_env(cooldown_s=1.25),
                 JaxAutoscalerConfig.from_env(cooldown_s=1.25))
    assert vars(ours) == vars(ref)
    assert ours.scale_up_burn == 7.5 and ours.max_members == 9 and ours.cooldown_s == 1.25


# -- elastic membership on the port's fleet ------------------------------------


def test_scale_up_under_traffic_counts_the_new_member_s_ladder(model):
    fl = fleet_of([engine(model), engine(model)])
    fl.aot_warmup()
    fl.start()
    try:
        rng = np.random.default_rng(0)
        frids = [fl.submit(prompt(rng), 12) for _ in range(6)]
        ev = fl.add_member(engine(model))
        assert ev["event"] == "scale_up"
        # the CPU runs every program eagerly: nothing is captured
        assert ev["compile_delta"] == ev["ladder"] == 0, ev["by_program"]
        assert fl.n_routable() == 3 and fl.metrics_snapshot()["scale_ups"] == 1
        frids += [fl.submit(prompt(rng), 6) for _ in range(4)]
        got = fl.wait(frids, timeout=120)
        assert all(isinstance(r, FinishedRequest) for r in got.values())
        assert fl.accounting()["lost"] == 0
        wait_until(lambda: all(m["state"] == HEALTHY for m in fl.metrics_snapshot()["members"]),
                   msg="new member healthy")
        with pytest.raises(ValueError, match="ShapeBuckets"):
            fl.add_member(engine(model, prompt_buckets=(32,)))
        fl.max_members = 3
        with pytest.raises(RuntimeError, match="max_members"):
            fl.add_member(engine(model), warm=False)
    finally:
        fl.shutdown()


def test_scale_down_drains_exactly_once(model):
    engs = [engine(model) for _ in range(3)]
    fl = fleet_of(engs).start()
    try:
        rng = np.random.default_rng(1)
        frids = [fl.submit(prompt(rng), 24) for _ in range(9)]
        wait_until(lambda: any(e.pending() > 0 for e in engs), msg="fleet busy")
        ev = fl.scale_down()
        assert ev is not None and fl.n_routable() == 2
        assert next(m for m in fl.metrics_snapshot()["members"]
                    if m["idx"] == ev["idx"])["state"] == RETIRED
        got = fl.wait(frids, timeout=120)
        assert all(isinstance(r, FinishedRequest) for r in got.values())
        acc = fl.accounting()
        assert acc["completed"] == 9 and acc["lost"] == 0
        assert fl.kv_slack() == fl.kv_recount()
        frid = fl.submit(prompt(rng), 4)
        fl.wait([frid], timeout=60)
        assert len(engs[ev["idx"]].finished) == 0
        assert fl.push_params(model) == 2  # the retired member is skipped
        with pytest.raises(ValueError, match="no routable member"):
            fl.scale_down(idx=99)
        assert fl.scale_down() is not None and fl.scale_down() is None  # never the last
    finally:
        fl.shutdown()


def test_warmup_grace_and_readmission_grace(model):
    fl = fleet_of([engine(model), engine(model)], quarantine_after=2, warmup_grace_s=60.0)
    m = fl._members[0]
    m.warming, m.warm_deadline = True, time.monotonic() + 60.0
    for _ in range(5):
        fl._on_probe(m, False)
    assert m.state == HEALTHY and m.probe_failures == 0
    fl._on_probe(m, True)
    assert m.warming is False
    fl._on_probe(m, False)
    fl._on_probe(m, False)
    assert m.state == QUARANTINED
    ev = fl.add_member(engine(model), warm=False)
    new = next(mm for mm in fl._members if mm.idx == ev["idx"])
    assert new.warming and new.warm_deadline > time.monotonic()
    fl.shutdown()
    fl = fleet_of([engine(model)], quarantine_after=1, readmit_probes=1,
                  readmit_backoff_s=0.0, warmup_grace_s=60.0)
    m = fl._members[0]
    fl._on_probe(m, False)
    assert m.state == QUARANTINED
    fl._on_probe(m, True)
    assert m.state == HEALTHY and m.warming is True
    fl._on_probe(m, False)
    assert m.state == HEALTHY and m.probe_failures == 0
    fl.shutdown()


def test_kv_counters_equal_a_recount_after_join_leave_crash(model):
    fl = fleet_of([engine(model), engine(model)])
    fl.aot_warmup()
    fl.start()
    rng = np.random.default_rng(42)
    try:
        done = [fl.submit(prompt(rng), 16) for _ in range(4)]
        fl.add_member(engine(model))
        done += [fl.submit(prompt(rng), 8) for _ in range(4)]
        fl.wait(done, timeout=120)
        assert fl.kv_slack() == fl.kv_recount()
        batch = [fl.submit(prompt(rng), 16) for _ in range(6)]
        fl.scale_down()
        fl.wait(batch, timeout=120)
        done += batch
        assert fl.kv_slack() == fl.kv_recount()
        batch = [fl.submit(prompt(rng), 24) for _ in range(6)]
        alive = [m.idx for m in fl._members if m.state == HEALTHY]
        inj = FaultInjector({f"fleet.engine_crash.{alive[0]}": Fault("crash", at=(1,))},
                            registry=MetricsRegistry())
        with injection(inj):
            fl.wait(batch, timeout=120)
        done += batch
        wait_until(lambda: fl.accounting()["outstanding"] == 0, msg="quiesce")
        assert fl.kv_slack() == fl.kv_recount()
        acc = fl.accounting()
        assert acc["completed"] == len(done) and acc["lost"] == 0
    finally:
        fl.shutdown()


def test_live_loop_scales_up_under_burn_and_down_under_slack(model):
    fl = fleet_of([engine(model)], slo_ttft_s=1e-4, probe_timeout_s=30.0)
    fl.aot_warmup()
    fl.start()
    a = Autoscaler(fl, engine_factory=lambda: engine(model),
                   config=AutoscalerConfig(scale_up_burn=0.5, burn_window_s=5.0,
                                           scale_down_free_frac=0.5, scale_down_sustain_s=0.3,
                                           cooldown_s=0.2, poll_interval_s=0.02, max_members=2),
                   registry=MetricsRegistry())
    try:
        rng = np.random.default_rng(3)
        a.start()
        deadline = time.monotonic() + 60.0
        while a.snapshot()["scale_ups"] < 1:
            assert time.monotonic() < deadline, "no scale-up"
            fl.wait([fl.submit(prompt(rng), 8) for _ in range(2)], timeout=60)
        wait_until(lambda: fl.n_routable() == 2, msg="scale-up member routable")
        wait_until(lambda: a.snapshot()["scale_downs"] >= 1, msg="scale-down")
        up = next(d for d in a.snapshot()["decisions"] if d["action"] == "scale_up")
        assert up["compile_delta"] == up["ladder"] == 0
        downs = [e for e in fl.scale_events if e["event"] == "scale_down"]
        assert len(downs) == a.snapshot()["scale_downs"]
        frid = fl.submit(prompt(rng), 4)
        assert isinstance(fl.wait([frid], timeout=60)[frid], FinishedRequest)
        assert fl.accounting()["lost"] == 0
    finally:
        a.stop()
        fl.shutdown()


def test_collector_rides_the_batch_lane(model):
    """The collector's rows ride the batch lane after a weight push and
    come back row-exact through ``poll`` (greedy members: each row is a
    single engine's answer), while interactive traffic completes."""
    fl = fleet_of([engine(model), engine(model)]).start()
    try:
        col = LLMCollector(env=None, model=model, num_prompts=2, max_new_tokens=6,
                           fleet=fl, fleet_timeout_s=60.0)
        rng = np.random.default_rng(5)
        inter = [fl.submit(prompt(rng), 8, lane="interactive") for _ in range(3)]
        G, P = 4, 8
        toks = rng.integers(0, SMALL["vocab_size"], (G, P)).astype(np.int64)
        out = col._fleet_generate(model, toks, np.ones((G, P), np.float32), seed=0)
        assert out.response_tokens.shape == (G, 6) and bool(out.response_mask.all())
        ref = engine(model)
        rids = {ref.submit(toks[g], 6): g for g in range(G)}
        for rid, fin in ref.run().items():
            np.testing.assert_array_equal(out.response_tokens[rids[rid]].numpy(), fin.tokens)
        assert sorted(fl.wait(inter, timeout=60)) == sorted(inter)
        assert fl.accounting()["lost"] == 0
        with pytest.raises(NotImplementedError, match="engine_params_sharding=.*ROADMAP A7"):
            LLMCollector(env=None, model=model, engine_params_sharding=object())
    finally:
        fl.shutdown()
