"""Erlang-style supervision for the framework's worker threads (counterpart
of :mod:`rl_tpu.resilience.supervisor`: pure Python, copied; its counters,
tracer instants and the flight recorder's dump at a give-up go to the
port's :mod:`rl_tpu_torch.obs`).

The framework's moving host parts — the AsyncHostCollector actor, the
RolloutPipeline producer, the ServingService stepper, the metrics HTTP
thread — used to die silently: an exception landed in ``self._error`` (at
best) and the run wedged or limped on. A :class:`Supervisor` owns those
threads Erlang-style:

- **one-for-one restart**: a crashed child's loop function is re-entered
  on the SAME wrapper thread (the run functions are stop-aware loops, so
  re-entering is a restart) — siblings are untouched;
- **exponential backoff + jitter** between restarts (seeded jitter, so
  chaos tests replay identically);
- **max-restarts budget** inside a sliding window; exhausting it means the
  child is beyond saving;
- **escalation to clean shutdown**: a given-up child escalates — the
  supervisor signals every other child to stop and invokes
  ``on_escalate`` so the owner can drain pipelines / checkpoint / exit,
  instead of half the program quietly missing.

Every restart/giveup/escalation is an obs counter + tracer instant
(``rl_tpu_resilience_restarts_total{child}`` et al.).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable

from ..obs.trace import carry_context, ctx_args
from .faults import InjectedFault  # noqa: F401  (re-exported for callers)

__all__ = ["Child", "Supervisor"]


class Child:
    """One supervised worker. ``run`` is a stop-aware loop: returning means
    a clean exit; raising means a crash (restart candidate)."""

    def __init__(
        self,
        name: str,
        run: Callable[[], Any],
        supervisor: "Supervisor",
        max_restarts: int,
        on_giveup: Callable[[BaseException], Any] | None,
        escalate: bool,
    ):
        self.name = name
        self.run = run
        self.max_restarts = max_restarts
        self.on_giveup = on_giveup
        self.escalate = escalate
        self.restarts = 0
        self.gave_up = False
        self.error: BaseException | None = None
        self._sup = supervisor
        self._stop = threading.Event()
        self._restart_times: list[float] = []
        # carry the spawner's TraceContext onto the worker thread (and its
        # restarts — the wrapper re-enters run() on the same thread), so a
        # supervised loop spawned inside a traced request stays in its tree
        self._thread = threading.Thread(
            target=carry_context(supervisor._child_main), args=(self,),
            name=f"{supervisor.name}/{name}", daemon=True,
        )

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float = 10.0) -> None:
        """Signal the restart loop to stop and join. The owner must also
        raise its OWN stop flag so ``run`` returns — the supervisor cannot
        interrupt a loop it didn't write."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)


class Supervisor:
    """One-for-one supervisor over named worker loops.

    >>> sup = Supervisor(max_restarts=3)
    >>> child = sup.spawn("collector", collector_loop)
    >>> ...
    >>> sup.stop()
    """

    def __init__(
        self,
        name: str = "supervisor",
        max_restarts: int = 3,
        window_s: float = 60.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
        on_escalate: Callable[["Supervisor", Child, BaseException], Any] | None = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Any = None,
        tracer: Any = None,
    ):
        self.name = name
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.on_escalate = on_escalate
        self.escalated = False
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._children: list[Child] = []
        self._stopping = False
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        if tracer is None:
            from ..obs import get_tracer

            tracer = get_tracer()
        self._tracer = tracer
        self._c_restarts = registry.counter(
            "rl_tpu_resilience_restarts_total",
            "supervised children restarted after a crash",
            labels=("child",),
        )
        self._c_giveups = registry.counter(
            "rl_tpu_resilience_giveups_total",
            "supervised children past their restart budget",
            labels=("child",),
        )
        self._c_escalations = registry.counter(
            "rl_tpu_resilience_escalations_total",
            "supervisor escalations to clean shutdown",
        )

    # -- public API -----------------------------------------------------------

    def spawn(
        self,
        name: str,
        run: Callable[[], Any],
        max_restarts: int | None = None,
        on_giveup: Callable[[BaseException], Any] | None = None,
        escalate: bool = True,
    ) -> Child:
        child = Child(
            name, run, self,
            max_restarts if max_restarts is not None else self.max_restarts,
            on_giveup, escalate,
        )
        with self._lock:
            self._children.append(child)
        child._thread.start()
        return child

    def children(self) -> list[Child]:
        with self._lock:
            return list(self._children)

    def restarts(self, name: str | None = None) -> int:
        with self._lock:
            return sum(c.restarts for c in self._children if name is None or c.name == name)

    def stop(self, timeout: float = 10.0) -> None:
        """Signal every child's restart loop and join the wrapper threads."""
        self._stopping = True
        for c in self.children():
            c._stop.set()
        for c in self.children():
            if c._thread.is_alive():
                c._thread.join(timeout=timeout)

    # -- restart machinery -----------------------------------------------------

    def _backoff(self, n_restart: int) -> float:
        d = min(self.backoff_max_s, self.backoff_base_s * (2.0 ** n_restart))
        with self._lock:
            u = self._rng.random()
        return d * (1.0 + self.jitter * u)

    def _child_main(self, child: Child) -> None:
        while not child._stop.is_set() and not self._stopping:
            try:
                child.run()
                return  # clean exit
            except BaseException as e:  # noqa: BLE001 — everything restarts
                if child._stop.is_set() or self._stopping:
                    return
                child.error = e
                now = self._clock()
                child._restart_times = [
                    t for t in child._restart_times if now - t <= self.window_s
                ]
                if len(child._restart_times) >= child.max_restarts:
                    self._giveup(child, e)
                    return
                child._restart_times.append(now)
                n = len(child._restart_times) - 1
                child.restarts += 1
                self._c_restarts.inc(1, {"child": child.name})
                self._tracer.instant(
                    "supervisor_restart",
                    {"child": child.name, "n": child.restarts, "error": repr(e)},
                )
                # interruptible backoff: stop() during the sleep wins
                if child._stop.wait(self._backoff(n)):
                    return

    def _giveup(self, child: Child, exc: BaseException) -> None:
        child.gave_up = True
        self._c_giveups.inc(1, {"child": child.name})
        self._tracer.instant(
            "supervisor_giveup",
            {"child": child.name, "error": repr(exc), **ctx_args()},
        )
        # black-box dump before on_giveup and escalation tear the run down
        from ..obs.flight import get_flight_recorder

        rec = get_flight_recorder()
        if rec is not None:
            path = rec.dump(f"supervisor_giveup-{child.name}", exc)
            if path is not None:
                try:
                    # the dump's location rides on the escalation error,
                    # the one artifact that reliably reaches the logs
                    exc.flight_record = path
                    if hasattr(exc, "add_note"):
                        exc.add_note(f"flight record: {path}")
                except Exception:
                    pass
        if child.on_giveup is not None:
            try:
                child.on_giveup(exc)
            except Exception:  # noqa: BLE001 — giveup hooks must not mask escalation
                pass
        if child.escalate and not self.escalated and not self._stopping:
            self.escalated = True
            self._c_escalations.inc()
            self._tracer.instant(
                "supervisor_escalate",
                {"supervisor": self.name, "child": child.name, **ctx_args()},
            )
            # clean shutdown: every sibling's restart loop is signalled; the
            # owners' own stop flags are raised by on_escalate (the
            # supervisor cannot reach into loops it didn't write)
            for c in self.children():
                if c is not child:
                    c._stop.set()
            if self.on_escalate is not None:
                try:
                    self.on_escalate(self, child, exc)
                except Exception:  # noqa: BLE001
                    pass
