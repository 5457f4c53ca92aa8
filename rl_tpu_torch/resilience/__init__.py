"""Resilience subsystem: supervised runtime, chaos injection, self-healing
(counterpart of :mod:`rl_tpu.resilience`; the four pillars are ported).

Four pillars (see ``docs/resilience.md``):

- :mod:`.supervisor` — Erlang-style one-for-one supervision of worker
  threads with backoff, restart budgets, and escalation to clean shutdown;
- :mod:`.faults` — deterministic, seedable fault injection at named sites
  (off by default, one ``None`` check when disabled);
- :mod:`.retry` — control-plane retry/timeout/backoff + circuit breaker;
- :mod:`.guard` — in-program finite-check skip, last-good-state rollback,
  and preemption-triggered emergency checkpoints.

Exports resolve lazily (PEP 562), as in the reference: a module that
needs only the fault hooks does not import ``torch`` through ``guard``.
"""

from __future__ import annotations

_EXPORTS = {
    # faults
    "SITES": "faults",
    "Fault": "faults",
    "FaultInjector": "faults",
    "InjectedFault": "faults",
    "fault_point": "faults",
    "register_site": "faults",
    "should_drop": "faults",
    "poison_scalar": "faults",
    "get_injector": "faults",
    "set_injector": "faults",
    "injection": "faults",
    # retry
    "CircuitBreaker": "retry",
    "CircuitOpenError": "retry",
    "Deadline": "retry",
    "RetryPolicy": "retry",
    # supervisor
    "Child": "supervisor",
    "Supervisor": "supervisor",
    # guard (torch — keep lazy)
    "EmergencyCheckpointer": "guard",
    "LastGoodState": "guard",
    "tree_where": "guard",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
