"""Exploration-type control (counterpart of :mod:`rl_tpu.envs.utils`;
``ExplorationType`` and its context manager are ported).

``set_exploration_type`` selects how a :class:`ProbabilisticActor` emits
actions: a draw from its distribution (``RANDOM``, the default) or the
distribution's mode or mean. The port runs eagerly, so the setting holds
for every call made inside the ``with`` block (the reference's holds for
what is traced inside it).
"""

from __future__ import annotations

import contextlib
import enum

from .._stubs import not_ported

__all__ = ["ExplorationType", "exploration_type", "set_exploration_type"]


class ExplorationType(enum.Enum):
    """How stochastic policies emit actions."""

    RANDOM = "random"
    MODE = "mode"
    MEAN = "mean"
    DETERMINISTIC = "deterministic"


_EXPLORATION = [ExplorationType.RANDOM]


def exploration_type() -> ExplorationType:
    return _EXPLORATION[-1]


@contextlib.contextmanager
def set_exploration_type(t: ExplorationType):
    _EXPLORATION.append(t)
    try:
        yield
    finally:
        _EXPLORATION.pop()


_ROADMAP = "A7: the env conformance harness"
check_env_specs = not_ported("check_env_specs", __name__, _ROADMAP)
check_vmap_autoreset = not_ported("check_vmap_autoreset", __name__, _ROADMAP)
