"""The port's SLO engine, flight recorder, liveness primitives and
``CompileDelta`` against ``rl_tpu``'s, on the CPU.

``StreamingHistogram`` and ``SLOEngine`` give the reference's quantiles,
attainments, burn rates and snapshots on the same samples and the same
fake clock, and publish the same gauges. ``FlightRecorder`` writes the
reference's bundle (``programs.json`` from the port's program registry),
rate-limited and capped alike, and the supervisor's give-up and the
watchdog's death dump it as the reference's do. ``CompileDelta`` counts
the program registry's graph captures by program across a block; on the
CPU a program runs eagerly and captures nothing.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from rl_tpu.comm import Interruptor as JaxInterruptor
from rl_tpu.comm import Watchdog as JaxWatchdog
from rl_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from rl_tpu.obs import slo as jax_slo
from rl_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from rl_tpu_torch.comm import Interruptor, Watchdog
from rl_tpu_torch.compile import CompileDelta, ProgramRegistry
from rl_tpu_torch.compile import metrics as port_metrics
from rl_tpu_torch.obs import (FlightRecorder, MetricsRegistry, Objective, SLOEngine,
                              StreamingHistogram, TraceRecorder, get_flight_recorder,
                              merge_histograms, set_flight_recorder)
from rl_tpu_torch.resilience import Supervisor
from test_torch_resilience import no_process_state  # noqa: F401

torch.set_num_threads(1)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def samples(seed=0, n=500):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-3.0, 1.2, n), [0.0, 61.0, 0.001, 1e-9]]).tolist()


def test_histogram_quantiles_and_merge_are_the_reference_s():
    xs = samples()
    ours, ref = StreamingHistogram(), jax_slo.StreamingHistogram()
    for x in xs:
        ours.observe(x)
        ref.observe(x)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.snapshot() == ref.snapshot()
    parts = [StreamingHistogram() for _ in range(3)]
    for i, x in enumerate(xs):
        parts[i % 3].observe(x)
    merged, whole = merge_histograms(parts).snapshot(), ours.snapshot()
    assert merged["counts"] == whole["counts"] and merged["count"] == whole["count"]
    assert merged["sum"] == pytest.approx(whole["sum"], rel=1e-12)  # summed in another order
    assert merge_histograms([]) is None
    merged = merge_histograms(parts)
    with pytest.raises(ValueError):
        StreamingHistogram((1.0, 1.0))
    with pytest.raises(ValueError):
        ours.quantile(1.5)
    with pytest.raises(ValueError):
        merged.merge(StreamingHistogram((1.0, 2.0)))


def test_slo_engine_attainment_and_burn_rates_are_the_reference_s():
    """The same timed samples through both engines, read at several
    times: the same attainments, burn rates, snapshot and gauges."""
    rng = np.random.default_rng(1)
    engines = []
    for eng_cls, reg in ((SLOEngine, MetricsRegistry()), (jax_slo.SLOEngine,
                                                          JaxMetricsRegistry())):
        clock = Clock()
        eng = eng_cls(registry=reg, windows=(10.0, 60.0, 600.0), clock=clock)
        engines.append((eng, reg, clock))
    ttft = [e.objective("ttft", threshold=0.25, target=0.95) for e, _, _ in engines]
    avail = [e.objective("avail", target=0.99) for e, _, _ in engines]
    reads = []
    for step in range(400):
        dt, v, ok = float(rng.exponential(0.7)), float(rng.lognormal(-2, 1)), rng.random() > 0.03
        for (_, _, clock), t, a in zip(engines, ttft, avail):
            clock.t += dt
            assert t.record(v) == (v <= 0.25)
            a.record_event(bool(ok))
        if step % 50 == 49:
            reads.append([(t.attainment(), t.attainment(10.0), t.burn_rate(10.0),
                           t.burn_rate(60.0), a.burn_rate(600.0), e.snapshot())
                          for (e, _, _), t, a in zip(engines, ttft, avail)])
    for ours, ref in reads:
        assert ours == ref
    renders = []
    for e, reg, _ in engines:
        e._collect()
        renders.append(sorted(ln for ln in reg.render().splitlines()
                              if ln.startswith("rl_tpu_slo_")))
    assert renders[0] == renders[1] and renders[0]
    with pytest.raises(ValueError, match="already defined"):
        engines[0][0].objective("ttft", threshold=0.5)
    with pytest.raises(ValueError, match="event-based"):
        avail[0].record(1.0)
    assert isinstance(ttft[0], Objective) and Objective("x", None).burn_rate(60.0) == 0.0


def _bundle(path):
    return sorted(os.listdir(path)), json.load(open(os.path.join(path, "meta.json")))


def test_flight_recorder_writes_the_reference_s_bundle(tmp_path):
    dirs = []
    for cls, reg, sub in ((FlightRecorder, MetricsRegistry(), "port"),
                          (JaxFlightRecorder, JaxMetricsRegistry(), "ref")):
        clock = Clock()
        rec = cls(str(tmp_path / sub), registry=reg, max_dumps=2, min_interval_s=5.0,
                  clock=clock,
                  tracer=TraceRecorder() if cls is FlightRecorder else None)
        rec.add_source("fleet", lambda: {"admitted": 3})
        rec.add_source("broken", lambda: 1 / 0)
        p1 = rec.dump("supervisor_giveup-x", RuntimeError("boom"))
        assert rec.dump("again") is None  # rate-limited
        clock.t += 10.0
        p2 = rec.dump("again")
        clock.t += 10.0
        assert rec.dump("third") is None  # past max_dumps
        assert rec.dumps == [p1, p2]
        dirs.append(p1)
    (files_a, meta_a), (files_b, meta_b) = _bundle(dirs[0]), _bundle(dirs[1])
    assert files_a == files_b == ["meta.json", "metrics.json", "programs.json",
                                  "source-broken.json", "source-fleet.json", "trace.json"]
    keep = ("trigger", "error", "window_s", "seq", "profile_bundle", "failed_artifacts")
    assert {k: meta_a[k] for k in keep} == {k: meta_b[k] for k in keep}
    assert json.load(open(os.path.join(dirs[0], "source-broken.json")))["error"].startswith(
        "ZeroDivisionError")


def test_programs_json_reads_the_port_s_registry(tmp_path):
    from rl_tpu_torch.compile import set_program_registry

    reg = ProgramRegistry()
    prev = set_program_registry(reg)
    try:
        prog = reg.register("demo.add", lambda a, b: a + b)
        prog(torch.ones(2), torch.ones(2))
        path = FlightRecorder(str(tmp_path)).dump("manual")
        programs = json.load(open(os.path.join(path, "programs.json")))
        assert programs["demo.add"]["calls"] == 1 and programs["demo.add"]["compiles"] == 0
    finally:
        set_program_registry(prev)


def test_supervisor_give_up_and_watchdog_death_dump(tmp_path):
    rec = FlightRecorder(str(tmp_path), min_interval_s=0.0)
    prev = set_flight_recorder(rec)
    try:
        assert get_flight_recorder() is rec
        sup = Supervisor(name="t", max_restarts=0, registry=MetricsRegistry(),
                         tracer=TraceRecorder())
        seen = []

        def crash():
            raise RuntimeError("dead")

        child = sup.spawn("worker", crash, on_giveup=seen.append, escalate=False)
        child._thread.join(10)
        sup.stop()
        assert child.gave_up and seen
        assert seen[0].flight_record in rec.dumps
        assert os.path.basename(seen[0].flight_record).startswith("supervisor_giveup-worker")
        deaths = []
        wd = Watchdog(timeout=0.0, on_death=deaths.append)
        wd.register("actor")
        threading.Event().wait(0.01)
        assert wd.check() == ["actor"] and deaths == ["actor"]
        assert wd.dead == ["actor"] and wd.alive == []
        assert any(os.path.basename(d).startswith("watchdog_death-actor") for d in rec.dumps)
        wd.beat("actor")
        assert wd.alive == ["actor"]
    finally:
        set_flight_recorder(prev)


def test_watchdog_and_interruptor_follow_the_reference_s():
    for wd_cls, int_cls in ((Watchdog, Interruptor), (JaxWatchdog, JaxInterruptor)):
        i = int_cls()
        assert not i.collection_stopped()
        i.stop_collection()
        assert i.collection_stopped()
        i.start_collection()
        assert not i.collection_stopped()
        wd = wd_cls(timeout=30.0)
        wd.register("a")
        wd.register("b")
        wd.unregister("b")
        assert wd.check() == [] and wd.alive == ["a"]
        wd.start()
        wd.stop()


def test_compile_delta_counts_captures_by_program():
    """Captures are what the port compiles: ``record_capture`` (called by
    the registry after each one) counts them by program name across a
    block, ``compile_scope`` relabels them; a registered program run on
    CPU tensors captures nothing."""
    reg = ProgramRegistry()
    prog = reg.register("demo.mul", lambda a: a * 2)
    with CompileDelta() as d:
        prog(torch.ones(3))
    assert d.delta == 0 and d.by_program == {} and d.explain() == "no captures"
    with CompileDelta() as d:
        port_metrics.record_capture("serving.decode.k4", 0.5)
        port_metrics.record_capture("serving.decode.k4", 0.25)
        with port_metrics.compile_scope("warmup"):
            port_metrics.record_capture("serving.admit_update", 0.125)
    assert d.delta == 3 and d.seconds == pytest.approx(0.875)
    assert d.by_program == {"serving.decode.k4": 2, "warmup": 1}
    assert "3 capture(s)" in d.explain() and "serving.decode.k4: 2" in d.explain()
    assert port_metrics.compile_counts()["serving.decode.k4"] >= 2
    assert port_metrics.install_compile_listener()
