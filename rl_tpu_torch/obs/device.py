"""On-device step metrics, drained without blocking the step (counterpart
of :mod:`rl_tpu.obs.device`: counters, gauges and histograms).

The state is a dict of float32 tensors on the device; updates are tensor
ops, so accumulating a metric never waits for the device.
:meth:`DeviceMetrics.drain_async` starts a ``non_blocking`` copy of every
value into pinned host memory and records a CUDA event behind it;
:meth:`DeviceMetrics.drain` waits for that event (a no-op once the copy
has landed) and reads the host values. A trainer drains the previous
step's copy while the next step runs, as the reference does with
``copy_to_host_async``.

Histograms keep running bucket totals and the running sum of the observed
values; bucket ``k`` counts values with ``edges[k-1] < v <= edges[k]``
(``searchsorted`` on the left, as the reference bins).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["DeviceMetrics"]


@dataclasses.dataclass(frozen=True)
class DeviceMetrics:
    """Schema: counter names (running totals), gauge names (last value)
    and histograms ``{name: edges}``. State layout: ``{"counters": {name:
    f32[]}, "gauges": {name: f32[]}, "hist": {name: {"counts":
    f32[len(edges) + 1], "sum": f32[]}}}``."""

    counters: tuple = ()
    gauges: tuple = ()
    histograms: Any = dataclasses.field(default_factory=dict)
    # the edges as device tensors, made once per device at init: a fresh
    # host-to-device copy in every observe would wait for the stream
    _edges: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "counters", tuple(self.counters))
        object.__setattr__(self, "gauges", tuple(self.gauges))
        object.__setattr__(self, "histograms", {
            k: tuple(float(e) for e in v) for k, v in dict(self.histograms).items()})

    def __hash__(self):
        return hash((self.counters, self.gauges, tuple(sorted(self.histograms.items()))))

    def init(self, device) -> dict:
        zero = lambda n=(): torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
        for name, edges in self.histograms.items():
            t = torch.tensor(edges, dtype=torch.float32, device=device)
            self._edges[(name, t.device)] = t  # keyed as the state's tensors report it
        return {"counters": {n: zero() for n in self.counters},
                "gauges": {n: zero() for n in self.gauges},
                "hist": {n: {"counts": zero(len(e) + 1), "sum": zero()}
                         for n, e in self.histograms.items()}}

    def inc(self, state: dict, name: str, value=1.0) -> dict:
        c = dict(state["counters"])
        c[name] = c[name] + value
        return {**state, "counters": c}

    def set_gauge(self, state: dict, name: str, value) -> dict:
        g = dict(state["gauges"])
        g[name] = torch.as_tensor(value, dtype=torch.float32, device=g[name].device).reshape(())
        return {**state, "gauges": g}

    def observe(self, state: dict, name: str, values) -> dict:
        """Bin ``values`` (any shape) into the histogram's running totals."""
        h = state["hist"][name]
        edges = self._edges[(name, h["counts"].device)]
        vals = values.to(torch.float32).reshape(-1)
        idx = torch.searchsorted(edges, vals, right=False)
        # a one-hot sum, not bincount: CUDA bincount reads its bin count
        # back to the host
        buckets = torch.arange(len(edges) + 1, device=idx.device)
        hist = dict(state["hist"])
        hist[name] = {"counts": h["counts"] + (idx[:, None] == buckets).sum(0),
                      "sum": h["sum"] + vals.sum()}
        return {**state, "hist": hist}

    @staticmethod
    def _leaves(state: dict) -> list[tuple[tuple, torch.Tensor]]:
        out = [((kind, n), t) for kind in ("counters", "gauges") for n, t in state[kind].items()]
        for n, h in state["hist"].items():
            out += [(("hist", n, "counts"), h["counts"]), (("hist", n, "sum"), h["sum"])]
        return out

    @staticmethod
    def drain_async(state: dict) -> dict:
        """Start the device-to-host copy of every value; returns the
        pending host snapshot for :meth:`drain`."""
        leaves = DeviceMetrics._leaves(state)
        flat = (torch.cat([t.reshape(-1) for _, t in leaves]) if leaves else torch.zeros(0))
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = flat.clone(), None
        return {"keys": [(k, t.numel(), t.dim()) for k, t in leaves], "host": host,
                "done": done}

    @staticmethod
    def drain(pending: dict) -> dict:
        """Wait for a :meth:`drain_async` copy and return the state's
        layout with Python floats (lists for histogram counts)."""
        if pending["done"] is not None:
            pending["done"].synchronize()
        vals = pending["host"].tolist()
        out: dict = {"counters": {}, "gauges": {}, "hist": {}}
        pos = 0
        for key, numel, dim in pending["keys"]:
            v = vals[pos:pos + numel] if dim else float(vals[pos])
            pos += numel
            if key[0] == "hist":
                out["hist"].setdefault(key[1], {})[key[2]] = v
            else:
                out[key[0]][key[1]] = v
        return out

    def publish(self, snapshot: dict, registry, prefix: str = "rl_tpu_device") -> None:
        """Push a drained snapshot into a host
        :class:`~rl_tpu_torch.obs.registry.MetricsRegistry`: counters and
        histograms are running totals (``set_total``, ``set_cumulative``),
        gauges last values (``set``)."""
        for n in self.counters:
            registry.counter(f"{prefix}_{n}_total", f"device counter {n}").set_total(
                float(snapshot["counters"][n]))
        for n in self.gauges:
            registry.gauge(f"{prefix}_{n}", f"device gauge {n}").set(
                float(snapshot["gauges"][n]))
        for n, edges in self.histograms.items():
            registry.histogram(f"{prefix}_{n}", f"device histogram {n}",
                               buckets=edges).set_cumulative(
                list(snapshot["hist"][n]["counts"]), float(snapshot["hist"][n]["sum"]))

    def to_flat(self, snapshot: dict) -> dict:
        """``{name: float}`` over counters and gauges, ``{name: {"edges",
        "counts", "sum"}}`` for histograms."""
        out = {**snapshot["counters"], **snapshot["gauges"]}
        for n, edges in self.histograms.items():
            h = snapshot["hist"][n]
            out[n] = {"edges": list(edges), "counts": list(h["counts"]), "sum": h["sum"]}
        return out
