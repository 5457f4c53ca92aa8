"""Placeholders for names of a ported file that the port does not have yet.

A module of the port keeps its counterpart's public names. Those that no
ported path calls yet are made here: calling one (constructing the class,
or calling the function) raises :class:`NotImplementedError` naming the
ROADMAP item that will bring it. A ported class whose method the port
does not have yet binds :func:`not_ported_call` in its place.
"""

from __future__ import annotations

__all__ = ["not_ported", "not_ported_call"]


def not_ported(name: str, module: str, roadmap: str) -> type:
    """A class named ``name`` whose construction raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{module}.{name} is not ported to rl_tpu_torch yet (ROADMAP {roadmap})"
        )

    return type(name, (), {"__init__": __init__, "__module__": module,
                           "__doc__": f"Not ported yet (ROADMAP {roadmap})."})


def not_ported_call(qualname: str, module: str, roadmap: str):
    """A function (or method) named ``qualname`` whose call raises."""

    def call(*args, **kwargs):
        raise NotImplementedError(
            f"{module}.{qualname} is not ported to rl_tpu_torch yet (ROADMAP {roadmap})"
        )

    call.__name__, call.__qualname__ = qualname.rsplit(".", 1)[-1], qualname
    call.__module__ = module
    call.__doc__ = f"Not ported yet (ROADMAP {roadmap})."
    return call
