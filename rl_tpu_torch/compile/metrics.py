"""Capture-event observability: which program captured a graph, and for
how long (counterpart of :mod:`rl_tpu.compile.metrics`).

The reference counts XLA backend compiles through a :mod:`jax.monitoring`
listener. A program of the port is compiled into a CUDA graph, one per
call signature, by :class:`~rl_tpu_torch.compile.ProgramRegistry`; each
capture calls :func:`record_capture` with the program's name, which
feeds:

- the process counters read by :class:`CompileDelta`,
  :func:`compiles_total` and :func:`compile_counts`;
- the process :class:`~rl_tpu_torch.obs.MetricsRegistry`
  (``rl_tpu_compiles_total{program}`` and the ``rl_tpu_compile_seconds``
  histogram) and the tracer (one ``graph_capture:<name>`` span).

``CompileDelta`` is the steady-state assertion: wrap a traffic window in
it and ``delta == 0`` shows that no graph was captured inside it. An
eager program (CPU tensors, or an engine without a registry) captures
nothing, so it counts nothing. ``compile_scope(name)`` attributes the
captures made inside the block (on this thread) to ``name`` instead of
the program's own name.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Iterator

__all__ = [
    "CompileDelta",
    "compile_counts",
    "compile_scope",
    "compile_seconds",
    "compile_seconds_total",
    "compiles_total",
    "install_compile_listener",
    "record_capture",
]

_scope: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "rl_tpu_torch_compile_scope", default=None
)

_lock = threading.Lock()
_total = 0
_seconds_total = 0.0
_counts: dict[str, int] = {}
_seconds: dict[str, float] = {}

# a capture takes milliseconds for a small program and seconds for a
# long decode chunk or a whole train step
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


@contextlib.contextmanager
def compile_scope(name: str) -> Iterator[None]:
    """Attribute the captures made inside the block to ``name``."""
    token = _scope.set(str(name))
    try:
        yield
    finally:
        _scope.reset(token)


def record_capture(program: str, seconds: float) -> None:
    """Count one graph capture of ``program`` that took ``seconds``
    (called by :class:`~rl_tpu_torch.compile.CachedProgram` after each
    capture)."""
    label = _scope.get() or program
    global _total, _seconds_total
    with _lock:
        _total += 1
        _seconds_total += seconds
        _counts[label] = _counts.get(label, 0) + 1
        _seconds[label] = _seconds.get(label, 0.0) + seconds
    # the registry and tracer are resolved per event: callers swap both
    try:
        from ..obs import get_registry, get_tracer

        reg = get_registry()
        reg.counter("rl_tpu_compiles_total", "graph captures by program",
                    labels=("program",)).inc(labels={"program": label})
        reg.histogram("rl_tpu_compile_seconds", "graph capture duration",
                      buckets=_COMPILE_BUCKETS).observe(seconds)
        tracer = get_tracer()
        tracer.end_span(f"graph_capture:{label}", tracer.now_us() - seconds * 1e6,
                        {"seconds": round(seconds, 4)})
    except Exception:
        pass  # observability never breaks a capture


def install_compile_listener() -> bool:
    """The reference's listener hook. The port's registry reports every
    capture itself, so counting is always live: returns True."""
    return True


def compiles_total() -> int:
    """Process-lifetime count of graph captures."""
    with _lock:
        return _total


def compile_seconds_total() -> float:
    with _lock:
        return _seconds_total


def compile_counts() -> dict[str, int]:
    """Snapshot of per-program capture counts."""
    with _lock:
        return dict(_counts)


def compile_seconds() -> dict[str, float]:
    """Snapshot of per-program cumulative capture seconds."""
    with _lock:
        return dict(_seconds)


class CompileDelta:
    """Count graph captures across a block::

        with CompileDelta() as d:
            run_traffic(fleet)
        assert d.delta == 0, d.explain()

    ``by_program`` names the programs that captured inside the block."""

    def __init__(self):
        self.delta = 0
        self.seconds = 0.0
        self.by_program: dict[str, int] = {}
        self._t0 = 0
        self._s0 = 0.0
        self._c0: dict[str, int] = {}
        self.supported = True

    def __enter__(self) -> "CompileDelta":
        with _lock:
            self._t0 = _total
            self._s0 = _seconds_total
            self._c0 = dict(_counts)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            self.delta = _total - self._t0
            self.seconds = _seconds_total - self._s0
            self.by_program = {
                k: v - self._c0.get(k, 0)
                for k, v in _counts.items()
                if v - self._c0.get(k, 0) > 0
            }

    def explain(self) -> str:
        if not self.delta:
            return "no captures"
        progs = ", ".join(f"{k}: {v}" for k, v in sorted(self.by_program.items()))
        return (f"{self.delta} capture(s) ({self.seconds:.2f}s) inside a window "
                f"expected to be steady-state [{progs}]")
