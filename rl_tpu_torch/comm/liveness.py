"""Liveness and preemption primitives for host-side moving parts
(counterpart of :mod:`rl_tpu.comm.liveness`, a copy of it: pure host
Python).

:class:`Interruptor` is the shared flag a trainer raises to preempt
in-flight collection; :class:`Watchdog` is a heartbeat registry (the
serving fleet's health probes read it).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

__all__ = ["Interruptor", "Watchdog"]


class Interruptor:
    """Preemption flag: the trainer raises it, collectors drain and stop.

    Thread/process-safe enough for its job (an Event per side); the
    reference's mp.Value+lock maps onto a plain Event here because host
    collection threads share the process.
    """

    def __init__(self):
        self._stop = threading.Event()

    def start_collection(self) -> None:
        self._stop.clear()

    def stop_collection(self) -> None:
        self._stop.set()

    def collection_stopped(self) -> bool:
        return self._stop.is_set()


class Watchdog:
    """Heartbeat registry with a background reaper.

    Actors ``register``/``beat``; anything silent for ``timeout`` seconds is
    declared dead exactly once (``on_death`` callback + ``dead`` listing).
    The serving fleet's monitor reads it as its members' liveness.
    """

    def __init__(
        self,
        timeout: float = 30.0,
        on_death: Callable[[str], Any] | None = None,
        check_interval: float | None = None,
    ):
        self.timeout = timeout
        self.on_death = on_death
        self.check_interval = check_interval or max(timeout / 4, 0.01)
        self._beats: dict[str, float] = {}
        self._dead: set[str] = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def register(self, name: str) -> None:
        with self._lock:
            self._beats[name] = time.monotonic()
            self._dead.discard(name)

    def beat(self, name: str) -> None:
        with self._lock:
            self._beats[name] = time.monotonic()
            self._dead.discard(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)
            self._dead.discard(name)

    def check(self) -> list[str]:
        """Sweep once; returns newly-dead names (each reported once)."""
        now = time.monotonic()
        newly = []
        with self._lock:
            for name, t in self._beats.items():
                if name not in self._dead and now - t > self.timeout:
                    self._dead.add(name)
                    newly.append(name)
        if newly:
            # liveness incidents show up in traces and /metrics, not just
            # log lines (lazy import: comm stays importable standalone)
            from ..obs import get_registry, get_tracer

            tracer = get_tracer()
            counter = get_registry().counter(
                "rl_tpu_watchdog_deaths_total",
                "actors declared dead by the watchdog",
                labels=("name",),
            )
            for name in newly:
                tracer.instant("watchdog_death", {"name": name})
                counter.inc(1, {"name": name})
            # a declared-dead actor is a postmortem moment: black-box dump
            # (single None check when disarmed; the recorder rate-limits
            # itself, so a mass die-off doesn't flood the disk)
            from ..obs import get_flight_recorder

            rec = get_flight_recorder()
            if rec is not None:
                for name in newly:
                    rec.dump(f"watchdog_death-{name}")
        for name in newly:
            if self.on_death is not None:
                self.on_death(name)
        return newly

    @property
    def dead(self) -> list[str]:
        with self._lock:
            return sorted(self._dead)

    @property
    def alive(self) -> list[str]:
        with self._lock:
            return sorted(set(self._beats) - self._dead)

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - a failing on_death callback
                # must not kill the reaper; liveness sweeps keep running
                import logging

                logging.getLogger("rl_tpu").exception("watchdog sweep failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
