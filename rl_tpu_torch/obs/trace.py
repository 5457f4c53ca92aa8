"""Cross-thread tracing with Perfetto/Chrome ``trace_event`` export
(counterpart of :mod:`rl_tpu.obs.trace`, a copy of it: the reference file
is pure Python).

Each thread records into its own bounded ring buffer, so the hot paths
(the trainer's loop, the ``AsyncHostCollector`` actor) never contend on a
shared lock per event: the recorder's lock is only taken the first time
a thread records (to register its ring) and at export. Events use the
Chrome trace-event JSON schema (``"X"`` complete spans with ``ts``/``dur``
in microseconds, ``"i"`` instants, ``"C"`` counters, ``"M"`` thread-name
metadata), so an ``export()`` file loads directly in Perfetto or
``chrome://tracing``.

A :class:`TraceContext` (``trace_id``/``span_id``/``parent_id``) lives in
a ``contextvars`` variable and crosses thread boundaries explicitly
(``carry_context``). ``ctx_span`` emits a span stamped with those ids and
activates the span's own context for the block, so nested spans and
instants on any thread link into one parent-chained tree.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Mapping

__all__ = [
    "TraceContext",
    "TraceRecorder",
    "carry_context",
    "ctx_args",
    "current_context",
    "get_tracer",
    "new_trace",
    "set_tracer",
    "use_context",
    "wire_tracer_obs",
]

DEFAULT_CAPACITY = 16384


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One node of a causal request tree.

    ``trace_id`` names the whole request tree, ``span_id`` this node, and
    ``parent_id`` the node it hangs under (None at the root). Immutable:
    crossing a boundary always *derives* (:meth:`child`) rather than
    mutates, so two threads holding the same context can fork safely."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    def child(self) -> "TraceContext":
        """A fresh span id under this one (same trace)."""
        return TraceContext(self.trace_id, _new_id(), self.span_id)

    def to_wire(self) -> dict:
        """JSON-safe dict for the TCP frame's optional ``"trace"`` key."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        return d

    @staticmethod
    def from_wire(d: Mapping[str, Any] | None) -> "TraceContext | None":
        """Inverse of :meth:`to_wire`; tolerant of missing/garbage frames
        (old peers, hand-written clients) — returns None instead of
        raising so the control plane never fails on trace metadata."""
        if not isinstance(d, Mapping):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not isinstance(tid, str) or not isinstance(sid, str):
            return None
        pid = d.get("parent_id")
        return TraceContext(tid, sid, pid if isinstance(pid, str) else None)


_CTX: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "rl_tpu_trace_context", default=None
)


def current_context() -> TraceContext | None:
    """The active :class:`TraceContext` on this thread (None outside any
    traced request)."""
    return _CTX.get()


def new_trace() -> TraceContext:
    """A fresh root context (new trace_id, no parent)."""
    return TraceContext(_new_id(), _new_id(), None)


@contextmanager
def use_context(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Activate ``ctx`` for the block (None deactivates tracing context)."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def ctx_args(ctx: TraceContext | None = None) -> dict:
    """Trace-id args for stamping an ``instant``/``span`` with the active
    (or given) context; {} when none is active, so callers can always
    ``{**ctx_args(), ...}`` without a branch."""
    c = ctx if ctx is not None else _CTX.get()
    if c is None:
        return {}
    out = {"trace_id": c.trace_id, "span_id": c.span_id}
    if c.parent_id is not None:
        out["parent_id"] = c.parent_id
    return out


def carry_context(fn: Callable, ctx: TraceContext | None = None) -> Callable:
    """Wrap a thread target so it runs under the context active *now* (or
    ``ctx``). contextvars don't cross ``threading.Thread`` boundaries by
    themselves; every plain-thread spawn that should stay inside the
    request tree wraps its target with this."""
    captured = ctx if ctx is not None else _CTX.get()

    def _carried(*args, **kwargs):
        token = _CTX.set(captured)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return _carried


class _ThreadRing:
    """Per-thread event ring. Only its owner thread appends, so no lock is
    needed on the hot path; ``deque(maxlen=...)`` gives the ring-buffer
    drop-oldest behaviour for free and its append is atomic under the GIL,
    which makes the exporter's snapshot (``list(ring)``) safe too."""

    __slots__ = ("tid", "name", "events", "dropped")

    def __init__(self, tid: int, name: str, capacity: int):
        self.tid = tid
        self.name = name
        self.events: deque = deque(maxlen=capacity)
        # events lapped out of the ring (append at maxlen evicts the
        # oldest silently) — without this count a wrapped ring exports a
        # truncated trace tree with no signal that events were lost.
        # Owner-thread-only writes; readers tolerate a stale value.
        self.dropped = 0


class TraceRecorder:
    """Span/instant/counter recorder, one ring buffer per thread."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.capacity = int(capacity)
        self._enabled = bool(enabled)
        self._lock = threading.Lock()  # guards _rings registration + export
        # a list, not a dict keyed by thread ident: the OS reuses idents
        # once a thread exits, and a reused key would silently drop the
        # finished thread's events from the export
        self._rings: list[_ThreadRing] = []
        self._next_tid = 1
        self._local = threading.local()
        self._pid = os.getpid()
        # trace timestamps are perf_counter-based (monotonic, ns); remember
        # the origin so ts starts near zero and stays readable.
        self._t0_ns = time.perf_counter_ns()

    # -- enable/disable -------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        self._enabled = bool(enabled)

    # -- recording ------------------------------------------------------
    def _ring(self) -> _ThreadRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            with self._lock:
                # synthetic per-recorder tid (registration order): stable,
                # unique, and never recycled the way OS thread idents are
                ring = _ThreadRing(self._next_tid, t.name, self.capacity)
                self._next_tid += 1
                self._rings.append(ring)
            self._local.ring = ring
        return ring

    def _emit(self, ev: dict) -> None:
        """Append to the calling thread's ring, counting the lap when a
        full ring is about to evict its oldest event."""
        ring = self._ring()
        if len(ring.events) == self.capacity:
            ring.dropped += 1
        ring.events.append(ev)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def now_us(self) -> float:
        """Current trace-clock time (µs since recorder creation) — the
        same clock event ``ts`` fields use; lets consumers (flight
        recorder) window the export without private access."""
        return self._now_us()

    @contextmanager
    def span(self, name: str, args: Mapping[str, Any] | None = None) -> Iterator[None]:
        """Time a block as a complete ("X") event on the calling thread."""
        if not self._enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            ev = {"ph": "X", "name": name, "ts": start, "dur": end - start}
            if args:
                ev["args"] = dict(args)
            self._emit(ev)

    @contextmanager
    def ctx_span(
        self,
        name: str,
        args: Mapping[str, Any] | None = None,
        ctx: TraceContext | None = None,
    ) -> Iterator[TraceContext | None]:
        """A span that is a *node in the causal tree*: derives a child of
        the active (or given) context — or starts a new trace at a root —
        activates it for the block, and stamps the emitted event with
        ``trace_id``/``span_id``/``parent_id`` so the export links it.

        Yields the span's own context (e.g. to store on a request object
        that later threads re-activate). Disabled recorder: no event and
        no context derivation — propagation overhead is zero when off."""
        if not self._enabled:
            yield _CTX.get() if ctx is None else ctx
            return
        parent = ctx if ctx is not None else _CTX.get()
        span_ctx = parent.child() if parent is not None else new_trace()
        token = _CTX.set(span_ctx)
        start = self._now_us()
        try:
            yield span_ctx
        finally:
            end = self._now_us()
            _CTX.reset(token)
            ev = {"ph": "X", "name": name, "ts": start, "dur": end - start}
            a = dict(args) if args else {}
            a.update(ctx_args(span_ctx))
            ev["args"] = a
            self._emit(ev)

    def begin_span(self, name: str, args: Mapping[str, Any] | None = None) -> float:
        """Manual span start for code that can't use a ``with`` block
        (e.g. ``timeit.__enter__``); pair with :meth:`end_span`."""
        return self._now_us()

    def end_span(
        self, name: str, start_us: float, args: Mapping[str, Any] | None = None
    ) -> None:
        if not self._enabled:
            return
        ev = {"ph": "X", "name": name, "ts": start_us, "dur": self._now_us() - start_us}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def instant(self, name: str, args: Mapping[str, Any] | None = None) -> None:
        """Point event (watchdog death, preemption signal, straggler cut)."""
        if not self._enabled:
            return
        ev = {"ph": "i", "name": name, "ts": self._now_us(), "s": "t"}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def counter(self, name: str, values: Mapping[str, float]) -> None:
        """Counter track sample (queue depth over time, tokens/s)."""
        if not self._enabled:
            return
        self._emit(
            {
                "ph": "C",
                "name": name,
                "ts": self._now_us(),
                "args": {k: float(v) for k, v in values.items()},
            }
        )

    # -- export ---------------------------------------------------------
    def export(self, path: str | None = None, since_us: float | None = None) -> dict:
        """Snapshot all rings as a Chrome ``trace_event`` JSON object
        (``{"traceEvents": [...]}``); optionally also write it to ``path``.
        Safe to call while other threads keep recording. ``since_us``
        keeps only events at/after that trace-clock time (a span counts
        if it *ends* inside the window) — the flight recorder's
        last-N-seconds cut."""
        with self._lock:
            rings = list(self._rings)
        events: list[dict] = []
        for ring in rings:
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": self._pid,
                    "tid": ring.tid,
                    # dropped stamps the lap count into the export so a
                    # truncated tree is self-describing (only when nonzero:
                    # exact-equality round-trip consumers see no change)
                    "args": (
                        {"name": ring.name, "dropped": ring.dropped}
                        if ring.dropped
                        else {"name": ring.name}
                    ),
                }
            )
            for ev in list(ring.events):
                if since_us is not None and (
                    ev.get("ts", 0.0) + ev.get("dur", 0.0) < since_us
                ):
                    continue
                out = dict(ev)
                out["pid"] = self._pid
                out["tid"] = ring.tid
                events.append(out)
        # Global timestamp order: a request's events span several rings
        # (threads), and Perfetto renders flow/causality by stream order —
        # per-ring grouping misordered cross-thread events. "M" metadata
        # carries no ts and must lead, so it keys as -1.0; tid breaks ties
        # deterministically for same-ts events.
        events.sort(key=lambda e: (e.get("ts", -1.0), e["tid"]))
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def dropped_events(self) -> dict[str, int]:
        """Events lapped out of each ring, summed per thread name (two
        threads with one name — Supervisor restarts — fold together).
        Zero-drop threads are included so the exporter emits a 0 total."""
        with self._lock:
            rings = list(self._rings)
        out: dict[str, int] = {}
        for ring in rings:
            out[ring.name] = out.get(ring.name, 0) + ring.dropped
        return out

    def clear(self) -> None:
        with self._lock:
            rings = list(self._rings)
        for ring in rings:
            ring.events.clear()
            ring.dropped = 0


_TRACER = TraceRecorder()


def get_tracer() -> TraceRecorder:
    """The process-default recorder (what ``timeit``/``record_function``
    and the liveness/resilience hooks record into)."""
    return _TRACER


def set_tracer(tracer: TraceRecorder) -> TraceRecorder:
    """Swap the process default (tests); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def wire_tracer_obs(registry=None) -> None:
    """Export ``rl_tpu_trace_dropped_events_total{thread}`` through a
    scrape-time collector on ``registry`` (default: the process metrics
    registry). Reads the *current* process tracer at scrape time, so a
    ``set_tracer`` swap after wiring is honored. Idempotent per registry
    object."""
    if registry is None:
        from .registry import get_registry

        registry = get_registry()
    if getattr(registry, "_rl_tpu_trace_drop_wired", False):
        return
    c_drop = registry.counter(
        "rl_tpu_trace_dropped_events_total",
        "trace events lapped out of a full per-thread ring buffer",
        labels=("thread",),
    )

    def _collect():
        for name, n in get_tracer().dropped_events().items():
            c_drop.set_total(float(n), {"thread": name})

    registry.register_collector(_collect)
    registry._rl_tpu_trace_drop_wired = True
