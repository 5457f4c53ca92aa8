"""Control-plane retry/timeout/backoff policy + circuit breaker (counterpart
of :mod:`rl_tpu.resilience.retry`: pure Python, copied; its gauges,
counters and tracer instants go to the port's :mod:`rl_tpu_torch.obs`).

The reference's TCP control plane (``rl_tpu.comm``; ROADMAP A7 in the port) was fire-once: a dropped reply or
a refused connection killed the caller. :class:`RetryPolicy` makes the
transport survivable — exponential backoff with deterministic (seeded)
jitter, idempotent-only retry, per-call :class:`Deadline` accounting — and
:class:`CircuitBreaker` stops a dead peer from absorbing every caller's
timeout budget: after ``failure_threshold`` consecutive failures the
circuit opens (calls fail fast with :class:`CircuitOpenError`), and after
``reset_timeout_s`` a limited number of half-open probes test the peer
before the circuit closes again.

State transitions surface through obs: ``rl_tpu_circuit_state{name}``
gauge (0=closed, 1=half_open, 2=open), a transitions counter, and tracer
instants — the PR-3 wiring extended to the resilience layer.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable

__all__ = ["CircuitBreaker", "CircuitOpenError", "Deadline", "RetryPolicy"]

# retryable transport failures: refused/reset connections, timeouts, and
# anything OSError-shaped (socket errors). Server-side handler errors come
# back as RuntimeError and are NOT retried — the call reached the peer.
DEFAULT_RETRY_ON: tuple[type[BaseException], ...] = (
    ConnectionError,
    TimeoutError,
    OSError,
)


class CircuitOpenError(ConnectionError):
    """Fail-fast signal: the breaker is open, the call never left the host."""


class Deadline:
    """Monotonic budget shared across retries (and across poll loops —
    ``RemoteEngine.wait_all`` charges its sleeps against one of these)."""

    def __init__(self, seconds: float | None, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._expires = None if seconds is None else clock() + seconds

    def remaining(self) -> float:
        if self._expires is None:
            return float("inf")
        return self._expires - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


_STATE_VALUE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Closed → (failures ≥ threshold) → open → (reset timeout) → half-open
    → probe success closes / probe failure re-opens."""

    def __init__(
        self,
        name: str = "default",
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        registry: Any = None,
        tracer: Any = None,
    ):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probes_left = 0
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        if tracer is None:
            from ..obs import get_tracer

            tracer = get_tracer()
        self._tracer = tracer
        self._g_state = registry.gauge(
            "rl_tpu_circuit_state",
            "breaker state (0=closed, 1=half_open, 2=open)",
            labels=("name",),
        )
        self._c_trans = registry.counter(
            "rl_tpu_circuit_transitions_total",
            "breaker state transitions",
            labels=("name", "to"),
        )
        self._g_state.set(0.0, {"name": name})

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # under self._lock
        if self._state == to:
            return
        self._state = to
        self._g_state.set(_STATE_VALUE[to], {"name": self.name})
        self._c_trans.inc(1, {"name": self.name, "to": to})
        self._tracer.instant("circuit_transition", {"name": self.name, "to": to})

    def allow(self) -> None:
        """Gate a call; raises :class:`CircuitOpenError` when open (or when
        the half-open probe quota is spent)."""
        with self._lock:
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._transition("half_open")
                    self._probes_left = self.half_open_probes
                else:
                    raise CircuitOpenError(
                        f"circuit {self.name!r} open "
                        f"({self._failures} consecutive failures)"
                    )
            if self._state == "half_open":
                if self._probes_left <= 0:
                    raise CircuitOpenError(
                        f"circuit {self.name!r} half-open, probe quota spent"
                    )
                self._probes_left -= 1

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._transition("closed")

    def on_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition("open")


class RetryPolicy:
    """Idempotent-call retry with exponential backoff + seeded jitter.

    ``call(fn, *args, idempotent=..., deadline=...)`` retries ``fn`` on
    transport-shaped failures (``retry_on``) up to ``max_attempts`` within
    the deadline. Non-idempotent calls never retry — a dropped REPLY does
    not prove the request was dropped, and re-sending it would double-apply.
    Jitter comes from a seeded ``random.Random`` so backoff schedules are
    reproducible in tests; ``sleep``/``clock`` are injectable the same way.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay_s: float = 0.05,
        max_delay_s: float = 1.0,
        jitter: float = 0.25,
        deadline_s: float | None = None,
        retry_on: tuple[type[BaseException], ...] = DEFAULT_RETRY_ON,
        breaker: CircuitBreaker | None = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        registry: Any = None,
    ):
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.retry_on = retry_on
        self.breaker = breaker
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed)
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        self._c_retries = registry.counter(
            "rl_tpu_retries_total", "control-plane calls retried"
        )

    def backoff_delay(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): capped exponential,
        multiplied by ``1 + jitter*u`` with seeded uniform ``u``."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0**attempt))
        return d * (1.0 + self.jitter * self._rng.random())

    def deadline(self, seconds: float | None = None) -> Deadline:
        return Deadline(
            seconds if seconds is not None else self.deadline_s, clock=self.clock
        )

    def call(
        self,
        fn: Callable,
        *args,
        idempotent: bool = True,
        deadline: Deadline | float | None = None,
        **kwargs,
    ):
        dl = (
            deadline
            if isinstance(deadline, Deadline)
            else self.deadline(deadline)
        )
        attempt = 0
        while True:
            if self.breaker is not None:
                self.breaker.allow()  # CircuitOpenError fails fast, no retry
            try:
                out = fn(*args, **kwargs)
            except self.retry_on:
                if self.breaker is not None:
                    self.breaker.on_failure()
                attempt += 1
                if not idempotent or attempt >= self.max_attempts or dl.expired:
                    raise
                delay = min(self.backoff_delay(attempt - 1), max(dl.remaining(), 0.0))
                self._c_retries.inc()
                self.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.on_success()
            return out
