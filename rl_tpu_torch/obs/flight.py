"""Crash flight recorder: a bounded black box dumped on escalation
(counterpart of :mod:`rl_tpu.obs.flight`, a copy of it: pure host Python,
with ``programs.json`` from the port's program registry).

When a run dies (a supervisor's restart budget exhausted, a watchdog
declaring an actor dead) the question is what was happening in the last
thirty seconds. The tracer rings, the ``MetricsRegistry``, the program
registry's stats and the kvmem ``audit()`` hold it, until the rings wrap.
:class:`FlightRecorder` snapshots all of it at the moment of death into a
timestamped directory::

    <dir>/<trigger>-<utcstamp>-<seq>/
        meta.json       trigger, error, wall time, what failed to dump
        trace.json      last ``window_s`` seconds of spans (Perfetto file)
        metrics.json    full MetricsRegistry snapshot
        programs.json   per-program ProgramRegistry stats (calls, captures, ...)
        source-<name>.json   each registered extra source (kvmem audit, ...)

1. **Dumping never raises.** Every artifact writes inside its own
   try/except; failures are listed in ``meta.json``.
2. **Bounded.** ``max_dumps`` caps the dumps of a process and
   ``min_interval_s`` rate-limits them.
3. **Disarmed by default.** The process-global recorder is ``None``
   until :func:`set_flight_recorder`; the hooks in the supervisor's
   give-up and :meth:`Watchdog.check <rl_tpu_torch.comm.Watchdog.check>`
   are one None check when off.

The reference also fires its armed triggered profiler beside a dump;
``obs/profiling`` is not ported yet (ROADMAP A7), so ``meta.json``'s
``profile_bundle`` is always null.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder"]


def _programs_source() -> dict:
    """Default ``programs.json`` source: per-program ProgramRegistry
    stats. Reads the module slot directly instead of
    ``get_program_registry()``: a dump observes a registry, it does not
    create one."""
    from ..compile import registry as _creg

    reg = _creg._default
    return {} if reg is None else reg.stats()


def _json_default(o: Any) -> str:
    return repr(o)


class FlightRecorder:
    """Black-box recorder: ``dump()`` writes one postmortem bundle.

    ``tracer``/``registry`` default to the process globals at dump time
    (not at construction), so arming the recorder early still captures
    whatever a caller later installs via ``set_tracer``/
    ``set_registry``."""

    def __init__(
        self,
        dir: str,
        window_s: float = 30.0,
        tracer: Any = None,
        registry: Any = None,
        max_dumps: int = 8,
        min_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dir = str(dir)
        self.window_s = float(window_s)
        self.max_dumps = int(max_dumps)
        self.min_interval_s = float(min_interval_s)
        self._tracer = tracer
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump_t: float | None = None
        self._sources: dict[str, Callable[[], Any]] = {}
        self.dumps: list[str] = []

    # -- sources ---------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], Any]) -> "FlightRecorder":
        """Register an extra JSON-able snapshot source (e.g. the kvmem
        allocator's ``audit``, a fleet's ``accounting``). Evaluated only
        at dump time; a raising source becomes ``{"error": ...}`` in its
        artifact instead of killing the dump."""
        with self._lock:
            self._sources[name] = fn
        return self

    def attach_kvmem(self, allocator: Any, name: str = "kvmem_audit") -> "FlightRecorder":
        """Convenience: register an allocator's ``audit()`` as a source.
        ``audit`` *asserts* consistency, so a corrupt-at-death pool shows
        up as the AssertionError text in the artifact — exactly the
        postmortem signal wanted."""

        def _audit():
            return allocator.audit()

        return self.add_source(name, _audit)

    # -- dumping ---------------------------------------------------------

    def dump(self, trigger: str, error: BaseException | None = None) -> str | None:
        """Write one postmortem bundle; returns its directory path, or
        None when rate-limited / over the dump cap. Never raises."""
        try:
            return self._dump(trigger, error)
        except Exception:
            return None

    def _dump(self, trigger: str, error: BaseException | None) -> str | None:
        with self._lock:
            now = self._clock()
            if self._seq >= self.max_dumps:
                return None
            if (
                self._last_dump_t is not None
                and now - self._last_dump_t < self.min_interval_s
            ):
                return None
            self._seq += 1
            seq = self._seq
            self._last_dump_t = now
            sources = dict(self._sources)

        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        safe_trigger = "".join(c if c.isalnum() or c in "-_." else "_" for c in trigger)
        path = os.path.join(self.dir, f"{safe_trigger}-{stamp}-{seq:03d}")
        os.makedirs(path, exist_ok=True)

        failed: list[str] = []

        tracer = self._tracer
        if tracer is None:
            from .trace import get_tracer

            tracer = get_tracer()
        registry = self._registry
        if registry is None:
            from .registry import get_registry

            registry = get_registry()

        try:
            since = max(0.0, tracer.now_us() - self.window_s * 1e6)
            tracer.export(os.path.join(path, "trace.json"), since_us=since)
        except Exception as e:
            failed.append(f"trace: {e!r}")
        try:
            self._write_json(os.path.join(path, "metrics.json"), registry.snapshot())
        except Exception as e:
            failed.append(f"metrics: {e!r}")
        try:
            self._write_json(os.path.join(path, "programs.json"), _programs_source())
        except Exception as e:
            failed.append(f"programs: {e!r}")
        for name, fn in sorted(sources.items()):
            try:
                payload = fn()
            except Exception as e:
                payload = {"error": repr(e)}
            try:
                self._write_json(os.path.join(path, f"source-{name}.json"), payload)
            except Exception as e:
                failed.append(f"source-{name}: {e!r}")

        # the reference fires its armed triggered profiler here; that
        # waits for obs/profiling (ROADMAP A7)
        profile_bundle = None

        meta = {
            "trigger": trigger,
            "error": None if error is None else repr(error),
            "wall_time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "window_s": self.window_s,
            "seq": seq,
            "profile_bundle": profile_bundle,
            "failed_artifacts": failed,
        }
        self._write_json(os.path.join(path, "meta.json"), meta)

        with self._lock:
            self.dumps.append(path)
        return path

    @staticmethod
    def _write_json(path: str, payload: Any) -> None:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=_json_default)
            f.write("\n")


# -- process-global installation (disarmed by default) -------------------------

_flight: FlightRecorder | None = None


def get_flight_recorder() -> FlightRecorder | None:
    """The armed process-wide recorder, or None (default: disarmed —
    escalation hooks are a single None check when off)."""
    return _flight


def set_flight_recorder(rec: FlightRecorder | None) -> FlightRecorder | None:
    """Arm ``rec`` process-wide; returns the previous recorder."""
    global _flight
    prev = _flight
    _flight = rec
    return prev
