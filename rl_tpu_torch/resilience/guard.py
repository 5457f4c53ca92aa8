"""Last-good-state guard: skip bad steps, roll back, emergency-checkpoint
(counterpart of :mod:`rl_tpu.resilience.guard`; ``tree_where``,
``LastGoodState`` and ``EmergencyCheckpointer`` are ported).

Three layers of defense around the update dispatch, cheapest first:

1. **In-program finite check** (the trainers' ``Adam.step(grads, ok)``
   and :func:`tree_where`): ``ok = isfinite(loss) & isfinite(|grads|)``
   gates the parameter, optimizer and priority writes on the device; a
   NaN or Inf step is a no-op on the train state, counted in the on-device
   ``bad_steps`` counter, with no host sync.
2. **Host-side rollback** (:class:`LastGoodState`): an in-memory snapshot
   of parameters and optimizer state, refreshed every
   ``snapshot_interval`` good steps; after ``rollback_after`` consecutive
   bad steps the trainer restores it. The port updates its state in
   place, so a snapshot is a device clone that no later in-place update
   can alias, and a rollback hands out clones again, which the trainer
   copies into its live tensors.
3. **Preemption-triggered emergency checkpoint**
   (:class:`EmergencyCheckpointer`): on a (synthetic or SIGTERM)
   preemption the trainer drains its pipelines, waits for the in-flight
   work and writes a full checkpoint (arrays and JSON meta) so a later
   process resumes exactly.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..data.arraydict import ArrayDict

__all__ = ["EmergencyCheckpointer", "LastGoodState", "tree_where"]


def _map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensor leaves of trees of one structure (dict,
    list, tuple, ArrayDict); other leaves come from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, ArrayDict):
        return ArrayDict._unsafe({k: _map(fn, *(t[k] for t in trees)) for k in first.keys()})
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return first


def tree_where(pred, on_true, on_false):
    """Per-leaf ``torch.where(pred, a, b)``: the in-program skip, selecting
    the updated state when ``pred`` (a 0-dim bool tensor) holds, else the
    old one. ``where`` selects, so NaNs in the rejected branch do not
    propagate."""
    return _map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def _copy(tree):
    return _map(lambda x: x.detach().clone(), tree)


class LastGoodState:
    """Versioned in-memory emergency snapshot with K-consecutive rollback.

    Host-side companion to the in-program finite check: feed it the
    (lagged) drained ``bad_steps`` total each step via :meth:`observe`;
    it snapshots clones of the parameters and optimizer state on good
    steps and returns a restore tuple once ``rollback_after`` consecutive
    steps went bad. Returned trees are fresh clones, so the snapshot stays
    valid for the next rollback whatever the caller does with them.
    """

    def __init__(self, rollback_after: int = 3, snapshot_interval: int = 10,
                 registry: Any = None, tracer: Any = None):
        self.rollback_after = rollback_after
        self.snapshot_interval = snapshot_interval
        self.rollbacks = 0
        self._snap: tuple[Any, Any] | None = None
        self._snap_version = -1
        self._last_bad = 0.0
        self._consecutive = 0
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        if tracer is None:
            from ..obs import get_tracer

            tracer = get_tracer()
        self._tracer = tracer
        self._c_rollbacks = registry.counter(
            "rl_tpu_resilience_rollbacks_total",
            "emergency-snapshot rollbacks after K consecutive bad steps",
        )
        self._c_bad = registry.counter(
            "rl_tpu_resilience_bad_steps_skipped_total",
            "update steps skipped by the in-program finite check",
        )

    @property
    def snapshot_version(self) -> int:
        return self._snap_version

    def observe(self, step: int, bad_total: float, params: Any, opt_state: Any
                ) -> tuple[Any, Any, int] | None:
        """Record one step's (lagged) bad-step total. Returns ``(params,
        opt_state, version)`` clones to restore, or ``None``."""
        bad_total = float(bad_total)
        self._c_bad.set_total(bad_total)
        delta = bad_total - self._last_bad
        self._last_bad = bad_total
        if delta > 0:
            self._consecutive += 1
        else:
            self._consecutive = 0
            if self._snap is None or step - self._snap_version >= self.snapshot_interval:
                self._snap = (_copy(params), _copy(opt_state))
                self._snap_version = step
        if self._consecutive >= self.rollback_after and self._snap is not None:
            self._consecutive = 0
            self.rollbacks += 1
            self._c_rollbacks.inc()
            self._tracer.instant("rollback", {"step": step, "to_version": self._snap_version})
            p, o = self._snap
            return _copy(p), _copy(o), self._snap_version
        return None


class EmergencyCheckpointer:
    """Emergency checkpoints for preemption-exact resume.

    Thin wrapper over :class:`~rl_tpu_torch.checkpoint.Checkpoint` with two
    components: an arrays tree (``ArrayTreeAdapter``: tensors, generators
    and optimizer state trees, restored onto the template's devices) and a
    JSON ``meta`` dict (step counters, host RNG states, histories).
    ``meta.json`` is written last, so a partial save never looks complete.
    """

    def __init__(self, root: str, registry: Any = None, tracer: Any = None):
        self.root = root
        if registry is None:
            from ..obs import get_registry

            registry = get_registry()
        if tracer is None:
            from ..obs import get_tracer

            tracer = get_tracer()
        self._tracer = tracer
        self._c_saves = registry.counter(
            "rl_tpu_resilience_emergency_checkpoints_total",
            "emergency checkpoints written on preemption",
        )

    def _ckpt(self, arrays_ref: dict, meta_ref: dict, template: Callable[[], Any] | None):
        from ..checkpoint import Checkpoint, JSONAdapter

        ckpt = Checkpoint(self.root, capture_rng=False)
        ckpt.register("arrays", lambda: arrays_ref["v"],
                      lambda v: arrays_ref.__setitem__("v", v), template=template)
        ckpt.register("meta", lambda: meta_ref["v"], lambda v: meta_ref.__setitem__("v", v),
                      adapter=JSONAdapter())
        return ckpt

    def save(self, step: int, arrays: Any, meta: dict | None = None) -> str:
        path = self._ckpt({"v": arrays}, {"v": dict(meta or {})}, None).save(int(step))
        self._c_saves.inc()
        self._tracer.instant("emergency_checkpoint", {"step": int(step), "path": path})
        return path

    def latest_step(self) -> int | None:
        from ..checkpoint import Checkpoint

        return Checkpoint(self.root, capture_rng=False).latest_step()

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict, int]:
        """Load ``(arrays, meta, step)``; ``template`` is an arrays tree of
        the same structure, whose tensors name the devices to load onto.
        The loaded tensors are new (none aliases the template); write them
        into live state with :func:`~rl_tpu_torch.checkpoint.restore_into`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no emergency checkpoint under {self.root}")
        arrays_ref: dict = {"v": None}
        meta_ref: dict = {"v": None}
        self._ckpt(arrays_ref, meta_ref, lambda: template).load(int(step))
        return arrays_ref["v"], meta_ref["v"] or {}, int(step)
