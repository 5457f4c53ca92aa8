"""Process-wide metrics registry with Prometheus text exposition
(counterpart of :mod:`rl_tpu.obs.registry`, a copy of it: the reference
file is pure Python).

The host-side half of the observability subsystem (the device half is
:mod:`rl_tpu_torch.obs.device`): counters, gauges and histograms with
label sets, safe to touch from any thread: the trainer loop, the
``AsyncHostCollector`` actor thread and a scrape share one instance.
Rendering follows the Prometheus text exposition format (version 0.0.4):
``# HELP``/``# TYPE`` headers, ``_bucket{le=...}`` cumulative histogram
series plus ``_sum``/``_count``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
]

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST or any(c not in _VALID_REST for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared label-handling base; one lock per metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Iterable[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.label_names = tuple(labels)
        for ln in self.label_names:
            _check_name(ln)
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def _key(self, labels: Mapping[str, str] | None) -> tuple:
        labels = labels or {}
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} wants labels {self.label_names}, got {tuple(labels)}"
            )
        return tuple(str(labels[ln]) for ln in self.label_names)

    def _label_str(self, key: tuple) -> str:
        if not key:
            return ""
        pairs = ",".join(
            f'{ln}="{_escape(lv)}"' for ln, lv in zip(self.label_names, key)
        )
        return "{" + pairs + "}"

    def _render_header(self) -> list[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {_escape(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        return out


class Counter(_Metric):
    """Monotonically increasing total. ``inc`` for host-side events;
    ``set_total`` for device-drained running totals (the on-device
    accumulators in :class:`~rl_tpu_torch.obs.device.DeviceMetrics`
    already hold the monotone sum, so a drain overwrites rather than
    adds)."""

    kind = "counter"

    def inc(self, value: float = 1.0, labels: Mapping[str, str] | None = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def set_total(self, value: float, labels: Mapping[str, str] | None = None) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = max(float(value), self._series.get(k, 0.0))

    def value(self, labels: Mapping[str, str] | None = None) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def render(self) -> list[str]:
        out = self._render_header()
        with self._lock:
            for k in sorted(self._series):
                out.append(f"{self.name}{self._label_str(k)} {_fmt(self._series[k])}")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"||".join(k) if k else "": v for k, v in self._series.items()}


class Gauge(_Metric):
    """Point-in-time value, settable from any thread. ``set_fn`` attaches a
    zero-arg callable evaluated at render time — the scrape-time collector
    pattern (KV utilization is computed when asked for, not on a timer)."""

    kind = "gauge"

    def set(self, value: float, labels: Mapping[str, str] | None = None) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = float(value)

    def inc(self, value: float = 1.0, labels: Mapping[str, str] | None = None) -> None:
        k = self._key(labels)
        with self._lock:
            cur = self._series.get(k, 0.0)
            self._series[k] = (cur if isinstance(cur, float) else 0.0) + value

    def set_fn(self, fn: Callable[[], float], labels: Mapping[str, str] | None = None) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = fn

    def value(self, labels: Mapping[str, str] | None = None) -> float:
        k = self._key(labels)
        with self._lock:
            v = self._series.get(k, 0.0)
        return float(v() if callable(v) else v)

    def render(self) -> list[str]:
        out = self._render_header()
        with self._lock:
            items = sorted(self._series.items())
        for k, v in items:
            if callable(v):
                try:
                    v = float(v())
                except Exception:  # a dead collector must not kill the scrape
                    v = float("nan")
            out.append(f"{self.name}{self._label_str(k)} {_fmt(v)}")
        return out

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            items = list(self._series.items())
        for k, v in items:
            if callable(v):
                try:
                    v = float(v())
                except Exception:
                    v = float("nan")
            out["||".join(k) if k else ""] = v
        return out


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` buckets
    are cumulative and always end at ``+Inf``)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
        2.5, 5.0, 10.0,
    )

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labels)
        edges = sorted(float(b) for b in buckets)
        if not edges:
            raise ValueError("histogram needs at least one finite bucket edge")
        if math.isinf(edges[-1]):
            edges = edges[:-1]
        self.edges = tuple(edges)

    def _new_series(self):
        return {"counts": [0.0] * (len(self.edges) + 1), "sum": 0.0, "count": 0.0}

    def observe(self, value: float, labels: Mapping[str, str] | None = None) -> None:
        self.observe_many([value], labels)

    def observe_many(self, values, labels: Mapping[str, str] | None = None) -> None:
        """Vectorized ingest — one lock acquisition for a whole batch (the
        collector observes a full batch of staleness values at emit time)."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.edges), arr, side="left")
        binned = np.bincount(idx, minlength=len(self.edges) + 1)
        k = self._key(labels)
        with self._lock:
            s = self._series.setdefault(k, self._new_series())
            for i, c in enumerate(binned):
                s["counts"][i] += float(c)
            s["sum"] += float(arr.sum())
            s["count"] += float(arr.size)

    def set_cumulative(
        self,
        bucket_counts,
        total_sum: float,
        labels: Mapping[str, str] | None = None,
    ) -> None:
        """Overwrite from device-drained per-bucket totals (len(edges)+1
        non-cumulative counts, same layout DeviceMetrics accumulates)."""
        counts = [float(c) for c in bucket_counts]
        if len(counts) != len(self.edges) + 1:
            raise ValueError(
                f"want {len(self.edges) + 1} bucket counts, got {len(counts)}"
            )
        k = self._key(labels)
        with self._lock:
            self._series[k] = {
                "counts": counts,
                "sum": float(total_sum),
                "count": float(sum(counts)),
            }

    def render(self) -> list[str]:
        out = self._render_header()
        with self._lock:
            for k in sorted(self._series):
                s = self._series[k]
                cum = 0.0
                for edge, c in zip(self.edges, s["counts"]):
                    cum += c
                    lk = self._label_str_with(k, "le", _fmt(edge))
                    out.append(f"{self.name}_bucket{lk} {_fmt(cum)}")
                cum += s["counts"][-1]
                lk = self._label_str_with(k, "le", "+Inf")
                out.append(f"{self.name}_bucket{lk} {_fmt(cum)}")
                out.append(f"{self.name}_sum{self._label_str(k)} {_fmt(s['sum'])}")
                out.append(f"{self.name}_count{self._label_str(k)} {_fmt(s['count'])}")
        return out

    def _label_str_with(self, key: tuple, extra_name: str, extra_val: str) -> str:
        pairs = [f'{ln}="{_escape(lv)}"' for ln, lv in zip(self.label_names, key)]
        pairs.append(f'{extra_name}="{extra_val}"')
        return "{" + ",".join(pairs) + "}"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "||".join(k) if k else "": {
                    "edges": list(self.edges),
                    "counts": list(s["counts"]),
                    "sum": s["sum"],
                    "count": s["count"],
                }
                for k, s in self._series.items()
            }


class MetricsRegistry:
    """Get-or-create metric families; render the whole set for a scrape.

    ``counter/gauge/histogram`` are idempotent per name (the collector and
    the trainer can both ask for ``rl_tpu_env_steps_total`` and get the
    same family) but re-registration with a different type or label set is
    an error — silent divergence is how dashboards lie.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []
        self.created_at = time.time()

    def _get_or_create(self, cls, name, help, labels, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
                return m
        if type(m) is not cls or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {type(m).__name__}"
                f"{m.label_names}, requested {cls.__name__}{tuple(labels)}"
            )
        return m

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labels))

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: Iterable[float] = Histogram.DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, tuple(labels), buckets=buckets
        )

    def register_collector(self, fn: Callable[[], None]) -> Callable[[], None]:
        """``fn`` runs before every render — update gauges from live state
        (engine KV pools, queue sizes) at scrape time. Returns ``fn`` so it
        can be used as a decorator; pass the result to
        :meth:`unregister_collector` on shutdown."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for fn in collectors:
            try:
                fn()
            except Exception:  # scrape must survive a dying subsystem
                pass
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly dump."""
        with self._lock:
            collectors = list(self._collectors)
            metrics = dict(self._metrics)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        return {
            name: {"type": m.kind, "series": m.snapshot()}
            for name, m in sorted(metrics.items())
        }

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (what hooks/collectors use unless one
    is passed explicitly)."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests isolate themselves with a fresh
    one); returns the previous registry so callers can restore it."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    return prev
