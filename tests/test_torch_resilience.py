"""The port's resilience layer against ``rl_tpu.resilience`` and
``rl_tpu.trainers.resilience``, on the CPU: the fault injector's sites,
plans and firing sequence (deterministic and seeded), the retry policy's
backoff and the circuit breaker's transitions on fake clocks, the
supervisor's restarts, give-up and escalation, ``tree_where``,
``LastGoodState``'s snapshots and rollbacks on the same bad-step
sequence, and ``PreemptionHandler``'s signal side and trainer hook.

Both packages keep process-wide state here: an installed injector, the
SIGTERM handler, the Python and numpy global generators, threads. The
autouse fixture :func:`no_process_state` (imported by the other
resilience test files) checks after every test that each is as it was,
after bounded joins, and puts it back if not. Every metric goes to a fresh
registry. A real SIGTERM is sent only by the ``slow`` test, as the
reference's ``test_sigterm_checkpoints_and_resumes`` does, and only
between ``install()`` and ``uninstall()``.
"""

import ast
import inspect
import os
import random
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from rl_tpu.obs import TraceRecorder as JaxTraceRecorder
from rl_tpu.resilience import faults as jax_faults
from rl_tpu.resilience import guard as jax_guard
from rl_tpu.resilience import retry as jax_retry
from rl_tpu.resilience import supervisor as jax_supervisor
from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
from rl_tpu_torch.resilience import (SITES, CircuitBreaker, CircuitOpenError, Deadline, Fault,
                                     FaultInjector, InjectedFault, LastGoodState, RetryPolicy,
                                     Supervisor, fault_point, get_injector, injection,
                                     poison_scalar, should_drop, tree_where)
from rl_tpu_torch.resilience import faults as port_faults
from rl_tpu_torch.trainers.resilience import PreemptionHandler

torch.set_num_threads(1)
JOIN_S = 10.0


def _np_state_equal(a, b) -> bool:
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and tuple(a[2:]) == tuple(b[2:])


@pytest.fixture(autouse=True)
def no_process_state():
    """After the test: no injector in either package, the SIGTERM handler,
    the Python and numpy global generators as before, and no thread the
    test started still alive after a bounded wait. A leak fails the test
    after it is put back."""
    sigterm = signal.getsignal(signal.SIGTERM)
    py, npst = random.getstate(), np.random.get_state()
    before = set(threading.enumerate())
    yield
    leaks = []
    for name, mod in (("rl_tpu_torch", port_faults), ("rl_tpu", jax_faults)):
        if mod.get_injector() is not None:
            mod.set_injector(None)
            leaks.append(f"an injector left installed in {name}")
    if signal.getsignal(signal.SIGTERM) is not sigterm:
        signal.signal(signal.SIGTERM, sigterm)
        leaks.append("the SIGTERM handler changed")
    if random.getstate() != py:
        random.setstate(py)
        leaks.append("Python's global generator moved")
    if not _np_state_equal(np.random.get_state(), npst):
        np.random.set_state(npst)
        leaks.append("numpy's global generator moved")
    deadline = time.monotonic() + JOIN_S
    extra = [t for t in threading.enumerate() if t not in before]
    for t in extra:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in extra if t.is_alive()]
    if alive:
        leaks.append(f"threads still alive: {alive}")
    assert not leaks, leaks


def _reference_static_sites() -> dict:
    """The reference's ``SITES`` as its source writes it: its fleet and
    replay-shard modules add per-instance sites at run time, so the live
    dict depends on which tests ran before on the worker."""
    tree = ast.parse(inspect.getsource(jax_faults))
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "SITES":
            return ast.literal_eval(node.value)
    raise AssertionError("rl_tpu.resilience.faults has no SITES literal")


def test_sites_and_kinds_are_the_reference_s():
    assert SITES == _reference_static_sites()
    assert port_faults.KINDS == jax_faults.KINDS
    port_faults.register_site("grpo.update", "another description")  # idempotent
    assert SITES["grpo.update"] == jax_faults.SITES["grpo.update"]


def test_injector_fires_the_reference_s_sequence():
    """The same plan, seed and visits: the same ``fired`` list, poison
    values, drops, preempt calls and crashes, visit by visit; the counter
    of fired faults by site and kind."""
    class Target:
        def __init__(self):
            self.n = 0

        def preempt(self):
            self.n += 1

    targets = (Target(), Target())

    def plan(mod, tgt):
        return {"grpo.update": mod.Fault("nan", at=(2, 5)),
                "offpolicy.update": mod.Fault("nan", prob=0.3),
                "comm.server.reply": [mod.Fault("drop", at=(1,)), mod.Fault("delay", at=(3,))],
                "trainer.preempt": mod.Fault("preempt", at=(4,), target=tgt),
                "collector.actor_loop": mod.Fault("crash", at=(2,))}

    reg = MetricsRegistry()
    port = FaultInjector(plan(port_faults, targets[0]), seed=7, registry=reg,
                         tracer=TraceRecorder())
    ref = jax_faults.FaultInjector(plan(jax_faults, targets[1]), seed=7,
                                   registry=JaxMetricsRegistry(), tracer=JaxTraceRecorder())
    out = ([], [])
    for inj, seen in zip((port, ref), out):
        for _ in range(6):
            seen.append(("p", repr(inj.poison("grpo.update"))))
            seen.append(("q", repr(inj.poison("offpolicy.update"))))
            seen.append(("d", inj.fire("comm.server.reply")))
            seen.append(("t", inj.fire("trainer.preempt")))
            try:
                inj.fire("collector.actor_loop")
                seen.append(("c", None))
            except (InjectedFault, jax_faults.InjectedFault) as e:
                seen.append(("c", str(e)))
    assert out[0] == out[1]
    assert port.fired == ref.fired and port.counts() == ref.counts()
    assert targets[0].n == targets[1].n == 1
    fired = reg.counter("rl_tpu_faults_injected_total", labels=("site", "kind"))
    assert fired.value({"site": "grpo.update", "kind": "nan"}) == 2
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector({"no.such.site": Fault("crash", at=(1,))}, registry=MetricsRegistry())
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("melt", at=(1,))
    with pytest.raises(ValueError, match="needs"):
        Fault("crash")


def test_hooks_are_idle_without_an_injector_and_scoped_with_one():
    assert get_injector() is None
    fault_point("collector.actor_loop")
    assert should_drop("comm.server.reply") is False and poison_scalar("grpo.update") == 0.0
    inj = FaultInjector({"grpo.update": Fault("nan", at=(1,)),
                         "collector.actor_loop": Fault("crash", at=(1,))},
                        registry=MetricsRegistry(), tracer=TraceRecorder())
    with injection(inj):
        assert get_injector() is inj
        assert np.isnan(poison_scalar("grpo.update")) and poison_scalar("grpo.update") == 0.0
        with pytest.raises(InjectedFault):
            fault_point("collector.actor_loop")
    assert get_injector() is None and port_faults.get_injector() is None


def test_retry_policy_matches_the_reference():
    """Backoff delays from the same seed; a call failing twice then
    succeeding retries as often and sleeps as long; a non-idempotent call
    does not retry; a deadline expires on its clock."""
    clock = [0.0]
    runs = []
    for mod, reg in ((jax_retry, JaxMetricsRegistry()), (None, MetricsRegistry())):
        cls = RetryPolicy if mod is None else mod.RetryPolicy
        slept = []
        pol = cls(max_attempts=4, base_delay_s=0.1, max_delay_s=0.3, jitter=0.5, seed=11,
                  clock=lambda: clock[0], sleep=slept.append, registry=reg)
        delays = [pol.backoff_delay(a) for a in range(5)]
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("down")
            return "up"

        got = pol.call(flaky)
        with pytest.raises(ConnectionError):
            pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")), idempotent=False)
        runs.append((delays, got, len(calls), slept))
    assert runs[0] == runs[1]
    assert Deadline(None).remaining() == float("inf")
    clock_d = [5.0]
    dl = Deadline(2.0, clock=lambda: clock_d[0])
    clock_d[0] = 7.5
    assert dl.expired and jax_retry.Deadline(2.0, clock=lambda: 0.0).remaining() == 2.0


def test_circuit_breaker_transitions_match_the_reference():
    clock = [0.0]
    states = []
    for cls, reg, tr, err in ((CircuitBreaker, MetricsRegistry(), TraceRecorder(),
                               CircuitOpenError),
                              (jax_retry.CircuitBreaker, JaxMetricsRegistry(),
                               JaxTraceRecorder(), jax_retry.CircuitOpenError)):
        clock[0] = 0.0
        br = cls("peer", failure_threshold=2, reset_timeout_s=5.0, half_open_probes=1,
                 clock=lambda: clock[0], registry=reg, tracer=tr)
        seq = []
        for event in ("f", "f", "a", "t", "a", "a", "f", "t", "a", "s"):
            if event == "f":
                br.on_failure()
            elif event == "s":
                br.on_success()
            elif event == "t":
                clock[0] += 6.0
            else:
                try:
                    br.allow()
                    seq.append("allowed")
                except err:
                    seq.append("refused")
            seq.append(br.state)
        states.append(seq)
    assert states[0] == states[1]


def _crashing(n_crashes, stop):
    """A stop-aware loop that raises its first ``n_crashes`` entries."""
    entries = [0]

    def run():
        entries[0] += 1
        if entries[0] <= n_crashes:
            raise RuntimeError(f"crash {entries[0]}")
        while not stop.is_set():
            stop.wait(0.01)

    return run, entries


def test_supervisor_restarts_gives_up_and_escalates_as_the_reference():
    """Two crashes within the budget restart the child on its thread; a
    child past its budget is given up, its ``on_giveup`` called and the
    supervisor escalates (siblings signalled, ``on_escalate`` called).
    The counts equal the reference supervisor's on the same loops."""
    results = []
    for cls, reg, tr in ((Supervisor, MetricsRegistry(), TraceRecorder()),
                         (jax_supervisor.Supervisor, JaxMetricsRegistry(), JaxTraceRecorder())):
        escalated, gave_up = [], []
        sup = cls(max_restarts=2, backoff_base_s=0.0, jitter=0.0, registry=reg, tracer=tr,
                  on_escalate=lambda s, c, e: escalated.append(c.name))
        stop_a, stop_b = threading.Event(), threading.Event()
        run_a, entries_a = _crashing(2, stop_a)  # restarted twice, then runs
        run_b, entries_b = _crashing(5, stop_b)  # past the budget
        try:
            a = sup.spawn("a", run_a)
            deadline = time.monotonic() + JOIN_S
            while entries_a[0] < 3 and time.monotonic() < deadline:
                time.sleep(0.005)
            b = sup.spawn("b", run_b, on_giveup=lambda e: gave_up.append(str(e)))
            b._thread.join(timeout=JOIN_S)  # its give-up and the escalation have run
            results.append((a.restarts, b.restarts, b.gave_up, gave_up, escalated,
                            sup.escalated, entries_b[0], sup.restarts()))
        finally:
            stop_a.set()
            stop_b.set()
            sup.stop(timeout=JOIN_S)
        assert not any(c.is_alive() for c in sup.children())
    assert results[0] == results[1]
    assert results[0][:3] == (2, 2, True) and results[0][4] == ["b"]


def test_tree_where_selects_and_stops_nan_as_the_reference():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((3, 2)).astype(np.float32), "b": [np.float32([np.nan, 1.0])]}
    b = {"w": rng.standard_normal((3, 2)).astype(np.float32), "b": [np.float32([2.0, 3.0])]}
    for pred in (True, False):
        ours = tree_where(torch.tensor(pred), *[
            {"w": torch.from_numpy(x["w"]), "b": [torch.from_numpy(x["b"][0])]} for x in (a, b)])
        ref = jax_guard.tree_where(jnp.asarray(pred), a, b)
        np.testing.assert_array_equal(ours["w"].numpy(), np.asarray(ref["w"]))
        np.testing.assert_array_equal(ours["b"][0].numpy(), np.asarray(ref["b"][0]))


def test_last_good_state_rolls_back_as_the_reference():
    """The same stream of (step, bad total, state) into both guards: the
    same rollbacks at the same steps to the same snapshot versions and
    values. The port's snapshot is a clone: updating the live tensors in
    place after it leaves it as it was."""
    ours = LastGoodState(rollback_after=2, snapshot_interval=3, registry=MetricsRegistry(),
                         tracer=TraceRecorder())
    ref = jax_guard.LastGoodState(rollback_after=2, snapshot_interval=3,
                                  registry=JaxMetricsRegistry(), tracer=JaxTraceRecorder())
    params, opt = [torch.zeros(3)], {"count": torch.zeros(())}
    bad = [0, 0, 0, 1, 2, 2, 2, 2, 3, 4, 4]
    for step, total in enumerate(bad):
        with torch.no_grad():  # the trainer's in-place update of this step
            params[0].add_(1.0)
            opt["count"].add_(1.0)
        got = ours.observe(step, float(total), params, opt)
        exp = ref.observe(step, float(total), [jnp.asarray(params[0].numpy())],
                          {"count": jnp.asarray(opt["count"].numpy())})
        assert (got is None) == (exp is None), step
        if got is not None:
            assert got[2] == exp[2]
            np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(exp[0][0]))
            np.testing.assert_array_equal(got[1]["count"].numpy(), np.asarray(exp[1]["count"]))
            assert got[0][0].data_ptr() != params[0].data_ptr()
    assert ours.rollbacks == ref.rollbacks == 2
    assert ours.snapshot_version == ref.snapshot_version


def test_preemption_handler_signal_side_and_hook(tmp_path):
    """``install`` puts the handler on SIGTERM and ``uninstall`` puts the
    previous one back; the signal callback only raises the flag. As a
    ``post_step`` hook it saves the trainer's checkpoint once, runs the
    ``save_checkpoint`` hooks, counts the preemption in its registry and
    stops the trainer."""
    from rl_tpu_torch.checkpoint import Checkpoint
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.trainers import Trainer, make_ppo_trainer

    prev = signal.getsignal(signal.SIGTERM)
    reg = MetricsRegistry()
    handler = PreemptionHandler(registry=reg, tracer=TraceRecorder())
    handler.install()
    try:
        assert signal.getsignal(signal.SIGTERM) == handler._on_signal
        handler._on_signal(signal.SIGTERM, None)  # what the signal would run
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev and handler.preempted
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    program = make_ppo_trainer(env, total_steps=1, frames_per_batch=32, device="cpu").program
    ckpt = Checkpoint(str(tmp_path / "pk"), capture_rng=False)
    trainer = Trainer(program, total_steps=50, checkpoint=ckpt, device="cpu")
    saved = []
    trainer.register_op("save_checkpoint", lambda t: saved.append(t.step_count))
    trainer.register_op("post_step", handler)
    trainer.train(0)
    trainer.register_op("post_step", handler)  # a second call does nothing
    handler(trainer)
    assert trainer.step_count == 1 and ckpt.latest_step() == 1 and saved == [1]
    assert reg.counter("rl_tpu_preemptions_total").value() == 1


@pytest.mark.slow
def test_sigterm_checkpoints_and_resumes(tmp_path):
    """The reference's test with a real SIGTERM: sent after step 2, the
    handler stops the run there with a checkpoint; a fresh trainer with
    ``auto_resume`` runs the remaining steps."""
    from rl_tpu_torch.checkpoint import Checkpoint
    from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
    from rl_tpu_torch.trainers import Trainer, make_ppo_trainer

    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    program = make_ppo_trainer(env, total_steps=1, frames_per_batch=32, device="cpu").program
    ckpt = Checkpoint(str(tmp_path / "pk"), capture_rng=False)
    trainer = Trainer(program, total_steps=50, checkpoint=ckpt, device="cpu")
    handler = PreemptionHandler(registry=MetricsRegistry(), tracer=TraceRecorder()).install()

    def send_sigterm(t, m=None):
        if t.step_count == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.register_op("post_step", send_sigterm)
    trainer.register_op("post_step", handler)
    try:
        trainer.train(0)
    finally:
        handler.uninstall()
    assert trainer.step_count == 2 and handler.preempted and ckpt.latest_step() == 2
    resumed = Trainer(program, total_steps=5, checkpoint=Checkpoint(str(tmp_path / "pk"),
                                                                    capture_rng=False),
                      auto_resume=True, device="cpu")
    resumed.train(0)
    assert resumed.step_count == 5
