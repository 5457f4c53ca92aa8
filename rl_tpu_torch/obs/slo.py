"""Declarative SLOs over streaming histograms with multi-window burn rates
(counterpart of :mod:`rl_tpu.obs.slo`, a copy of it: the reference file is
pure host Python).

The serving fleet exports raw signals (queue depth, a TTFT EMA, KV
utilization); the :class:`~rl_tpu_torch.models.autoscale.Autoscaler`
needs calibrated ones: "are we meeting the objective, and how fast are we
spending the error budget". This module is that layer, host only:

- :class:`StreamingHistogram`: fixed-edge counts + sum/count, a lock per
  observe (observations are per request, not per token), mergeable (same
  edges) so per-member histograms roll up, with interpolated
  :meth:`~StreamingHistogram.quantile` reads. The fleet exports its TTFT
  quantiles from these (its EMA only routes).
- :class:`Objective`: one declarative SLO, "``value <= threshold`` for
  ``target`` of events". Every record lands in the all-time histogram
  and in a per-second good/total ring, so attainment is readable over any
  trailing window up to the ring span.
- :class:`SLOEngine`: creates objectives, publishes
  ``rl_tpu_slo_attainment{slo,window}``, ``rl_tpu_slo_burn_rate{slo,window}``
  and value-quantile gauges through a scrape-time collector, and
  snapshots everything.

Burn rate is the SRE ratio ``(1 - attainment) / (1 - target)`` over a
trailing window: 1.0 spends the budget at exactly the sustainable rate.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Sequence

__all__ = [
    "DEFAULT_LATENCY_EDGES",
    "Objective",
    "SLOEngine",
    "StreamingHistogram",
    "merge_histograms",
]

# log-spaced 1ms..60s: wide enough for TTFT and full-completion latency
# on every tier (the obs registry's default buckets stop at 10s).
DEFAULT_LATENCY_EDGES = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 60.0,
)


class StreamingHistogram:
    """Fixed-edge streaming histogram: observe / merge / quantile.

    ``counts`` has ``len(edges) + 1`` slots — the last is the overflow
    bucket (> edges[-1]). Thread-safe; the lock is per-observe, which is
    fine at request granularity (the hot paths never call this per
    token/step)."""

    __slots__ = ("edges", "counts", "sum", "count", "_lock")

    def __init__(self, edges: Sequence[float] = DEFAULT_LATENCY_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError("edges must be non-empty and strictly increasing")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        # bisect by hand: edges are short tuples and this avoids importing
        # numpy into a module that services import at startup
        i = 0
        n = len(self.edges)
        while i < n and v > self.edges[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` into self (same edges required) — per-member or
        per-process histograms roll up into one fleet view."""
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with different edges")
        with other._lock:
            counts, s, c = list(other.counts), other.sum, other.count
        with self._lock:
            for i, v in enumerate(counts):
                self.counts[i] += v
            self.sum += s
            self.count += c

    def quantile(self, q: float) -> float | None:
        """Interpolated quantile (Prometheus ``histogram_quantile``
        semantics: linear within the bucket, the overflow bucket clamps
        to the highest finite edge). None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts, total = list(self.counts), self.count
        if total == 0:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.edges[i - 1]
                if i >= len(self.edges):  # overflow: clamp to last edge
                    return self.edges[-1]
                hi = self.edges[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.edges[-1]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "edges": list(self.edges),
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }


def merge_histograms(hists) -> StreamingHistogram | None:
    """Pool several same-edge :class:`StreamingHistogram`\\ s into a
    fresh one (inputs untouched). Counts add exactly, so a quantile of
    the merged histogram equals the quantile of one histogram fed every
    raw sample — the property the fleet-wide TTFT/latency gauges rely
    on when rolling up per-member histograms. None for no inputs."""
    hists = list(hists)
    if not hists:
        return None
    out = StreamingHistogram(hists[0].edges)
    for h in hists:
        out.merge(h)
    return out


class Objective:
    """One SLO: ``value <= threshold`` for at least ``target`` of events.

    ``record(value)`` classifies and stores; ``record_event(good)`` is
    the availability form (no value — e.g. "request completed vs shed").
    Windowed reads come from a per-second (good, total) ring spanning
    ``ring_s`` seconds; all-time reads from cumulative counters and the
    value histogram."""

    def __init__(
        self,
        name: str,
        threshold: float | None,
        target: float = 0.99,
        description: str = "",
        ring_s: int = 3600,
        edges: Sequence[float] = DEFAULT_LATENCY_EDGES,
        clock=time.monotonic,
    ):
        if not 0.0 < target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {target}")
        self.name = name
        self.threshold = None if threshold is None else float(threshold)
        self.target = float(target)
        self.description = description
        self.hist = StreamingHistogram(edges)
        self._clock = clock
        self._ring_s = int(ring_s)
        # ring slot: [second, good, total]; second stamps validity so a
        # lapped slot is ignored instead of counting stale traffic
        self._ring = [[-1, 0, 0] for _ in range(self._ring_s)]
        self._lock = threading.Lock()
        self.good = 0
        self.total = 0

    def record(self, value: float) -> bool:
        """Classify a measured value against the threshold; returns good."""
        if self.threshold is None:
            raise ValueError(f"objective {self.name!r} is event-based; use record_event")
        self.hist.observe(value)
        good = value <= self.threshold
        self._count(good)
        return good

    def record_event(self, good: bool) -> None:
        """Availability form: count an event as meeting/missing the SLO."""
        self._count(good)

    def _count(self, good: bool) -> None:
        # math.floor, not int(): these run inside fleet hot loops on host floats
        sec = math.floor(self._clock())
        slot = self._ring[sec % self._ring_s]
        with self._lock:
            if slot[0] != sec:
                slot[0], slot[1], slot[2] = sec, 0, 0
            slot[1] += 1 if good else 0
            slot[2] += 1
            self.good += 1 if good else 0
            self.total += 1

    def _window_counts(self, window_s: float) -> tuple[int, int]:
        now = int(self._clock())
        lo = now - int(min(window_s, self._ring_s)) + 1
        g = t = 0
        with self._lock:
            for sec in range(lo, now + 1):
                slot = self._ring[sec % self._ring_s]
                if slot[0] == sec:
                    g += slot[1]
                    t += slot[2]
        return g, t

    def attainment(self, window_s: float | None = None) -> float | None:
        """Fraction of events meeting the SLO (None with no events)."""
        if window_s is None:
            g, t = self.good, self.total
        else:
            g, t = self._window_counts(window_s)
        return None if t == 0 else g / t

    def burn_rate(self, window_s: float) -> float:
        """Error-budget spend rate over the trailing window: 1.0 = exactly
        sustainable, >1 = burning budget. 0.0 with no traffic (an idle
        service isn't burning budget)."""
        att = self.attainment(window_s)
        if att is None:
            return 0.0
        budget = max(1.0 - self.target, 1e-9)
        return (1.0 - att) / budget

    def snapshot(self, windows: Sequence[float] = ()) -> dict:
        out = {
            "threshold": self.threshold,
            "target": self.target,
            "good": self.good,
            "total": self.total,
            "attainment": self.attainment(),
        }
        for w in windows:
            out[f"attainment_{int(w)}s"] = self.attainment(w)
            out[f"burn_rate_{int(w)}s"] = round(self.burn_rate(w), 4)
        if self.hist.count:
            out["p50"] = self.hist.quantile(0.5)
            out["p99"] = self.hist.quantile(0.99)
        return out


class SLOEngine:
    """Named objectives + scrape-time gauge publication.

    ::

        slo = SLOEngine(registry=reg)
        slo.objective("ttft", threshold=0.5, target=0.99)
        ...
        slo.get("ttft").record(ttft_s)

    Gauges rendered per scrape (collector pattern):
    ``rl_tpu_slo_attainment{slo,window}``,
    ``rl_tpu_slo_burn_rate{slo,window}``, and for value-based objectives
    ``rl_tpu_slo_value_seconds{slo,quantile}``, the surface the
    Autoscaler reads."""

    WINDOWS = (60.0, 300.0, 3600.0)

    def __init__(self, registry=None, windows: Sequence[float] | None = None,
                 clock=time.monotonic):
        self.windows = tuple(float(w) for w in (windows or self.WINDOWS))
        if any(w <= 0 or not math.isfinite(w) for w in self.windows):
            raise ValueError(f"windows must be positive finite, got {self.windows}")
        self._clock = clock
        self._objectives: dict[str, Objective] = {}
        self._lock = threading.Lock()
        self._registry = registry
        if registry is not None:
            # families are created NOW, not inside the collector: render()
            # snapshots the metric table before running collectors, so a
            # family born during the scrape would miss its first scrape
            self._g_att = registry.gauge(
                "rl_tpu_slo_attainment",
                "Fraction of events meeting the SLO over a trailing window",
                labels=("slo", "window"),
            )
            self._g_burn = registry.gauge(
                "rl_tpu_slo_burn_rate",
                "Error-budget burn rate over a trailing window (1.0 = sustainable)",
                labels=("slo", "window"),
            )
            self._g_val = registry.gauge(
                "rl_tpu_slo_value_seconds",
                "Observed value quantiles for value-based SLOs",
                labels=("slo", "quantile"),
            )
            registry.register_collector(self._collect)

    def objective(
        self,
        name: str,
        threshold: float | None = None,
        target: float = 0.99,
        description: str = "",
        edges: Sequence[float] = DEFAULT_LATENCY_EDGES,
    ) -> Objective:
        """Create (or fetch, if identical) the named objective."""
        with self._lock:
            obj = self._objectives.get(name)
            if obj is not None:
                if obj.threshold != (None if threshold is None else float(threshold)) \
                        or obj.target != float(target):
                    raise ValueError(
                        f"objective {name!r} already defined with "
                        f"threshold={obj.threshold} target={obj.target}"
                    )
                return obj
            ring = int(max(self.windows))
            obj = Objective(name, threshold, target, description,
                            ring_s=ring, edges=edges, clock=self._clock)
            self._objectives[name] = obj
            return obj

    def get(self, name: str) -> Objective:
        return self._objectives[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._objectives)

    def _collect(self) -> None:
        att, burn, val = self._g_att, self._g_burn, self._g_val
        with self._lock:
            objs = dict(self._objectives)
        for name, obj in objs.items():
            for w in self.windows:
                wl = f"{int(w)}s"
                a = obj.attainment(w)
                if a is not None:
                    att.set(a, labels={"slo": name, "window": wl})
                burn.set(obj.burn_rate(w), labels={"slo": name, "window": wl})
            a = obj.attainment()
            if a is not None:
                att.set(a, labels={"slo": name, "window": "all"})
            if obj.hist.count:
                for q in (0.5, 0.99):
                    v = obj.hist.quantile(q)
                    if v is not None:
                        val.set(v, labels={"slo": name, "quantile": str(q)})

    def snapshot(self) -> dict:
        """Every objective with windowed attainment
        and burn rates."""
        with self._lock:
            objs = dict(self._objectives)
        return {name: obj.snapshot(self.windows) for name, obj in objs.items()}
