"""On-device step metrics, drained without blocking the step (counterpart
of :mod:`rl_tpu.obs.device`, counters and gauges only).

The state is a dict of 0-dim float32 tensors on the device; updates are
tensor ops, so accumulating a metric never waits for the device.
:meth:`DeviceMetrics.drain_async` starts a ``non_blocking`` copy of every
value into pinned host memory and records a CUDA event behind it;
:meth:`DeviceMetrics.drain` waits for that event (a no-op once the copy
has landed) and reads the host values. A trainer drains the previous
step's copy while the next step runs, as the reference does with
``copy_to_host_async``.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceMetrics"]


@dataclasses.dataclass(frozen=True)
class DeviceMetrics:
    """Schema: counter names (running totals) and gauge names (last
    value). State layout: ``{"counters": {name: f32[]}, "gauges": {name:
    f32[]}}``."""

    counters: tuple = ()
    gauges: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "counters", tuple(self.counters))
        object.__setattr__(self, "gauges", tuple(self.gauges))

    def init(self, device) -> dict:
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
        return {"counters": {n: zero() for n in self.counters},
                "gauges": {n: zero() for n in self.gauges}}

    def inc(self, state: dict, name: str, value=1.0) -> dict:
        c = dict(state["counters"])
        c[name] = c[name] + value
        return {**state, "counters": c}

    def set_gauge(self, state: dict, name: str, value) -> dict:
        g = dict(state["gauges"])
        g[name] = torch.as_tensor(value, dtype=torch.float32, device=g[name].device).reshape(())
        return {**state, "gauges": g}

    @staticmethod
    def drain_async(state: dict) -> dict:
        """Start the device-to-host copy of every value; returns the
        pending host snapshot for :meth:`drain`."""
        flat = [(kind, n, t) for kind in ("counters", "gauges") for n, t in state[kind].items()]
        stacked = torch.stack([t for *_, t in flat]) if flat else torch.zeros(0)
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = stacked.clone(), None
        return {"keys": [(kind, n) for kind, n, _ in flat], "host": host, "done": done}

    @staticmethod
    def drain(pending: dict) -> dict:
        """Wait for a :meth:`drain_async` copy and return
        ``{"counters": {name: float}, "gauges": {name: float}}``."""
        if pending["done"] is not None:
            pending["done"].synchronize()
        out = {"counters": {}, "gauges": {}}
        for (kind, n), v in zip(pending["keys"], pending["host"].tolist()):
            out[kind][n] = float(v)
        return out

    def to_flat(self, snapshot: dict) -> dict:
        """``{name: float}`` over counters and gauges."""
        return {**snapshot["counters"], **snapshot["gauges"]}
