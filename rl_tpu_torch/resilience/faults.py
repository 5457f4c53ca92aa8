"""Deterministic, seedable fault injection at named sites (counterpart of
:mod:`rl_tpu.resilience.faults`: pure Python, copied; the counters and
tracer instants go to the port's :mod:`rl_tpu_torch.obs`).

The chaos layer the rest of the resilience subsystem is tested against:
production code calls :func:`fault_point` (or :func:`should_drop` /
:func:`poison_scalar`) at NAMED SITES; with no injector installed those are
a single module-global ``None`` check — zero overhead, off by default.
Installing a :class:`FaultInjector` (usually via the :func:`injection`
context manager) arms a PLAN mapping site names to :class:`Fault` specs.

Determinism: faults fire on explicit 1-based invocation indices (``at``)
counted per site, or — for soak runs — with a probability drawn from a
seeded ``random.Random``. No wall-clock anywhere in the trigger path, so a
seeded chaos test replays the same faults at the same program points every
run (the spirit of deterministic-simulation testing; every fired fault is
also an obs counter + tracer instant, so chaos runs are auditable from
``/metrics`` and the trace alone).

Site registry (the authoritative list — injector plans are validated
against it so a typo'd site fails loudly instead of silently never
firing):

==========================  =================================================
site                        where / supported kinds
==========================  =================================================
``collector.actor_loop``    AsyncHostCollector actor thread, top of each
                            harvest iteration (``crash``, ``delay``)
``grpo.rollout``            RolloutPipeline producer, before each ticket
                            acquire (``crash``, ``delay``)
``serving.stepper``         ServingService stepper loop, outside the engine
                            lock (``crash``, ``delay``)
``comm.server.reply``       TCPCommandServer, after the handler ran and
                            before the reply is written (``drop``, ``delay``)
``grpo.update``             GRPOTrainer update dispatch (``nan`` — poisons
                            the gradient of that step)
``offpolicy.update``        AsyncOffPolicyTrainer K-update dispatch (``nan``
                            — poisons the first update of the dispatch)
``trainer.preempt``         trainer step boundary (``preempt`` — raises the
                            target PreemptionHandler's flag)
``fleet.engine_crash``      ServingFleet member stepper, per BUSY iteration —
                            an idle replica cannot crash mid-decode
                            (``crash``, ``delay``); the fleet also registers
                            a ``fleet.engine_crash.<idx>`` site per member
                            via :func:`register_site` so a plan can kill a
                            SPECIFIC replica deterministically (per-site
                            invocation counters are shared across threads,
                            so the generic site alone cannot)
``fleet.probe_drop``        ServingFleet health monitor, one visit per member
                            per sweep in member order (``drop`` = that probe
                            reads as a failure)
``fleet.dispatch_delay``    ServingFleet dispatcher iteration (``delay``)
``kvmem.evict``             PrefixKVAllocator, before EACH single-block LRU
                            eviction step (``crash``, ``delay``) — a crash
                            abandons the allocation between atomic steps,
                            so refcounts and the free list stay consistent
                            (degrade, never corrupt)
``replay.shard_crash``      replay shard server, per handled request
                            (``crash``, ``delay``); each shard also registers
                            ``replay.shard_crash.<idx>`` via
                            :func:`register_site` so a plan can kill a
                            SPECIFIC shard deterministically — a crash marks
                            the shard dead and closes its endpoint, so the
                            coordinator renormalizes the mixture instead of
                            erroring the learner
``replay.shard_drop``       ShardedReplayBuffer, before each shard call
                            (``drop`` = that shard's link fails for this op;
                            the coordinator degrades around it)
==========================  =================================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Any, Mapping, Sequence

__all__ = [
    "SITES",
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "fault_point",
    "register_site",
    "should_drop",
    "poison_scalar",
    "get_injector",
    "set_injector",
    "injection",
]

SITES: dict[str, str] = {
    "collector.actor_loop": "AsyncHostCollector harvest-loop iteration",
    "grpo.rollout": "RolloutPipeline producer iteration",
    "serving.stepper": "ServingService engine-stepper iteration",
    "comm.server.reply": "TCPCommandServer reply write",
    "grpo.update": "GRPOTrainer update dispatch (NaN poison)",
    "offpolicy.update": "AsyncOffPolicyTrainer K-update dispatch (NaN poison)",
    "trainer.preempt": "trainer step boundary (synthetic preemption)",
    "fleet.engine_crash": "ServingFleet member stepper, per busy iteration",
    "fleet.probe_drop": "ServingFleet health-monitor probe (drop = failure)",
    "fleet.dispatch_delay": "ServingFleet dispatcher iteration",
    "kvmem.evict": "PrefixKVAllocator single-block LRU eviction step",
    "replay.shard_crash": "replay shard server, per handled request "
                          "(crash = the shard dies and refuses connections)",
    "replay.shard_drop": "ShardedReplayBuffer shard call (drop = that "
                         "shard's link fails for this op)",
}

KINDS = ("crash", "delay", "drop", "nan", "preempt")


def register_site(name: str, description: str) -> None:
    """Register a dynamically-named site (e.g. the fleet's per-member
    ``fleet.engine_crash.<idx>``) so strict plan validation accepts it.
    Idempotent — re-registering an existing name keeps the first
    description, so repeated construction of the owning object is safe."""
    SITES.setdefault(name, description)


class InjectedFault(RuntimeError):
    """Raised by a ``crash`` fault — distinguishable from organic failures
    so supervisors/tests can tell injected chaos from real bugs."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault spec at one site.

    ``at`` is a tuple of 1-based per-site invocation indices (deterministic
    trigger); ``prob`` arms a seeded-random trigger instead (soak mode).
    ``seconds`` is the sleep for ``delay``; ``target`` is the object whose
    ``.preempt()`` a ``preempt`` fault calls.
    """

    kind: str
    at: tuple[int, ...] = ()
    prob: float = 0.0
    seconds: float = 0.0
    target: Any = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; want one of {KINDS}")
        if not self.at and not self.prob:
            raise ValueError("Fault needs `at` indices or a `prob` trigger")


class FaultInjector:
    """Seeded chaos: a plan of {site: Fault | [Fault, ...]}.

    The injector only observes sites named in its plan — visiting an
    unplanned site is a dict miss (enabled-but-idle overhead is one
    attribute load + dict lookup per visit, bounded <2% on the hot loops
    by ``bench.py --chaos``). Every fired fault increments
    ``rl_tpu_faults_injected_total{site,kind}`` and emits a
    ``fault_injected`` tracer instant.
    """

    def __init__(
        self,
        plan: Mapping[str, Fault | Sequence[Fault]] | None = None,
        seed: int = 0,
        registry: Any = None,
        tracer: Any = None,
        strict_sites: bool = True,
    ):
        self._plan: dict[str, tuple[Fault, ...]] = {}
        for site, faults in (plan or {}).items():
            if strict_sites and site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known sites: {sorted(SITES)}"
                )
            fs = (faults,) if isinstance(faults, Fault) else tuple(faults)
            self._plan[site] = fs
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._count: dict[str, int] = {}
        self.fired: list[tuple[str, str, int]] = []  # (site, kind, invocation)
        # parallel to `fired`: the TraceContext args active when each fault
        # hit (None outside any traced request) — a separate list so the
        # `fired` tuple shape existing chaos tests assert on never changes
        self.fired_trace: list[dict | None] = []
        self.last_fire_monotonic: float | None = None  # bench-only, not used in triggers
        self._tracer = tracer
        self._counter = None
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        self._counter = registry.counter(
            "rl_tpu_faults_injected_total",
            "faults fired by the chaos injector",
            labels=("site", "kind"),
        )
        if tracer is None:
            from ..obs import get_tracer

            self._tracer = get_tracer()

    # -- trigger core ---------------------------------------------------------

    def _visit(self, site: str) -> tuple[tuple[Fault, ...], int]:
        faults = self._plan.get(site)
        if not faults:
            return (), 0
        from ..obs.trace import ctx_args

        ca = ctx_args()  # the request this fault is about to hit, if any
        with self._lock:
            n = self._count.get(site, 0) + 1
            self._count[site] = n
            hit = tuple(
                f
                for f in faults
                if (f.at and n in f.at) or (f.prob and self._rng.random() < f.prob)
            )
            for f in hit:
                self.fired.append((site, f.kind, n))
                self.fired_trace.append(ca or None)
        for f in hit:
            self.last_fire_monotonic = time.monotonic()
            self._counter.inc(1, {"site": site, "kind": f.kind})
            self._tracer.instant(
                "fault_injected", {"site": site, "kind": f.kind, "n": n, **ca}
            )
        return hit, n

    def fire(self, site: str) -> bool:
        """Run every fault scheduled for this invocation of ``site``.

        ``delay`` sleeps, ``preempt`` raises the target's flag, ``crash``
        raises :class:`InjectedFault`; returns True when a ``drop`` fired
        (callers at reply sites skip the write)."""
        hit, n = self._visit(site)
        if not hit:
            return False
        drop = False
        for f in hit:
            if f.kind == "delay":
                time.sleep(f.seconds)
            elif f.kind == "preempt" and f.target is not None:
                f.target.preempt()
            elif f.kind == "drop":
                drop = True
        for f in hit:
            if f.kind == "crash":
                raise InjectedFault(f"injected crash at {site!r} (invocation {n})")
        return drop

    def poison(self, site: str) -> float:
        """NaN when a ``nan`` fault fires at this invocation, else 0.0 —
        trainers add the scalar to their in-program gradients."""
        hit, _n = self._visit(site)
        return float("nan") if any(f.kind == "nan" for f in hit) else 0.0

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._count)


# -- module-global installation (the zero-overhead-when-off path) -------------

_injector: FaultInjector | None = None


def get_injector() -> FaultInjector | None:
    return _injector


def set_injector(inj: FaultInjector | None) -> FaultInjector | None:
    """Install ``inj`` process-wide; returns the previous injector."""
    global _injector
    prev = _injector
    _injector = inj
    return prev


@contextlib.contextmanager
def injection(inj: FaultInjector):
    """Scope an injector: ``with injection(FaultInjector(plan)): ...``."""
    prev = set_injector(inj)
    try:
        yield inj
    finally:
        set_injector(prev)


def fault_point(site: str) -> None:
    """The per-iteration hook hot loops call. No injector → one None check."""
    inj = _injector
    if inj is not None:
        inj.fire(site)


def should_drop(site: str) -> bool:
    """Reply-site hook: True when the reply should be silently dropped."""
    inj = _injector
    return False if inj is None else inj.fire(site)


def poison_scalar(site: str) -> float:
    """Update-site hook: NaN when this dispatch's gradient is poisoned."""
    inj = _injector
    return 0.0 if inj is None else inj.poison(site)
