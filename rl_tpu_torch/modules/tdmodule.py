"""Key-routed modules over ArrayDicts (counterpart of
:mod:`rl_tpu.modules.tdmodule`; ``TDModule``, ``TDSequential``,
``ProbabilisticActor``, ``ValueOperator``, ``QValueModule`` and
``QValueActor`` are ported).

A :class:`TDModule` binds an ``nn.Module`` to named inputs and outputs:
it reads ``in_keys`` from an ArrayDict and writes ``out_keys`` into the
ArrayDict it returns. Parameters live in the modules (the reference keeps
them in an external pytree). ``init(td, generator)`` builds layers whose
input width is learnt from ``td`` (an :class:`MLP` built at its first
input, as flax's ``Dense`` is), with draws from ``generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .._stubs import not_ported
from ..data.arraydict import ArrayDict
from ..envs.utils import ExplorationType, exploration_type
from .distributions import Distribution

__all__ = ["TDModule", "TDSequential", "ProbabilisticActor", "ValueOperator", "QValueModule",
           "QValueActor"]


def _norm_keys(keys) -> list[tuple[str, ...]]:
    return [k if isinstance(k, tuple) else (k,) for k in keys]


class TDModule(nn.Module):
    """``module`` applied to ``td[in_keys]``, its outputs written to
    ``out_keys``."""

    def __init__(self, module: nn.Module, in_keys: Sequence, out_keys: Sequence):
        super().__init__()
        self.module = module
        self.in_keys = _norm_keys(in_keys)
        self.out_keys = _norm_keys(out_keys)

    def init(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        """Build the module for ``td``'s input widths; returns ``td`` with
        this module's outputs (so a sequence can build the next one)."""
        if hasattr(self.module, "build"):
            width = sum(td[k].shape[-1] for k in self.in_keys)
            self.module.build(width, generator, td[self.in_keys[0]].device)
        return self(td)

    def forward(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        out = self.module(*[td[k] for k in self.in_keys])
        if not isinstance(out, tuple):
            out = (out,)
        if len(out) != len(self.out_keys):
            raise ValueError(f"{type(self.module).__name__} returned {len(out)} outputs for "
                             f"out_keys {self.out_keys}")
        for k, v in zip(self.out_keys, out):
            td = td.set(k, v)
        return td


class TDSequential(TDModule):
    """Chain of TDModules over one ArrayDict namespace."""

    def __init__(self, *modules: TDModule):
        nn.Module.__init__(self)
        self.tdmodules = nn.ModuleList(modules)
        self.in_keys = [k for m in modules for k in m.in_keys]
        self.out_keys = [k for m in modules for k in m.out_keys]

    def init(self, td, generator=None):
        for m in self.tdmodules:
            td = m.init(td, generator)
        return td

    def forward(self, td, generator=None):
        for m in self.tdmodules:
            td = m(td, generator)
        return td


class ProbabilisticActor(TDModule):
    """Network -> distribution -> action under the active
    :class:`ExplorationType`. ``module`` writes the ``dist_keys``; the
    distribution is ``dist_class(**those, **dist_kwargs)``. Writes
    ``out_key`` and, with ``return_log_prob``, ``sample_log_prob``.
    ``noise`` given to :meth:`forward` replaces the sample's draw (a
    Normal's standard-normal ``eps``, a Categorical's Gumbel noise)."""

    def __init__(self, module: TDModule, dist_class: type[Distribution],
                 dist_keys: Sequence = ("loc", "scale"), out_key="action",
                 dist_kwargs: dict | None = None, return_log_prob: bool = True):
        nn.Module.__init__(self)
        self.inner = module
        self.dist_class = dist_class
        self.dist_keys = _norm_keys(dist_keys)
        self.out_key = out_key if isinstance(out_key, tuple) else (out_key,)
        self.dist_kwargs = dist_kwargs or {}
        self.return_log_prob = return_log_prob
        self.in_keys = module.in_keys
        self.out_keys = [self.out_key] + ([("sample_log_prob",)] if return_log_prob else [])

    def init(self, td, generator=None):
        return self.inner.init(td, generator)

    def get_dist(self, td: ArrayDict) -> tuple[Distribution, ArrayDict]:
        td = self.inner(td)
        kwargs = {k[-1]: td[k] for k in self.dist_keys}
        return self.dist_class(**kwargs, **self.dist_kwargs), td

    def forward(self, td, generator=None, noise=None):
        dist, td = self.get_dist(td)
        mode = exploration_type()
        if mode == ExplorationType.RANDOM:
            if generator is None and noise is None:
                raise ValueError("ExplorationType.RANDOM requires a torch.Generator")
            action = dist.sample(generator, (), noise)
        elif mode == ExplorationType.MEAN:
            action = dist.mean
        else:  # MODE / DETERMINISTIC
            action = dist.deterministic_sample
        td = td.set(self.out_key, action)
        if self.return_log_prob:
            td = td.set("sample_log_prob", dist.log_prob(action))
        return td

    def log_prob(self, td: ArrayDict) -> torch.Tensor:
        dist, _ = self.get_dist(td)
        return dist.log_prob(td[self.out_key])


class ValueOperator(TDModule):
    """V(s) head writing ``"state_value"``."""

    def __init__(self, module: nn.Module, in_keys=("observation",),
                 out_keys=("state_value",)):
        super().__init__(module, in_keys, out_keys)


class QValueModule(nn.Module):
    """Greedy head over ``"action_value"``: writes the argmax ``"action"``
    (int32, as the reference's ``jnp.argmax``; one-hot in the values'
    dtype with ``one_hot``) and ``"chosen_action_value"``."""

    def __init__(self, one_hot: bool = False, action_value_key="action_value"):
        super().__init__()
        self.one_hot = one_hot
        self.avk = action_value_key if isinstance(action_value_key, tuple) else (action_value_key,)
        self.in_keys = [self.avk]
        self.out_keys = [("action",), ("chosen_action_value",)]

    def init(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        return self(td)

    def forward(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        q = td[self.avk]
        idx = torch.argmax(q, dim=-1)
        chosen = torch.gather(q, -1, idx[..., None])[..., 0]
        action = (nn.functional.one_hot(idx, q.shape[-1]).to(q.dtype) if self.one_hot
                  else idx.to(torch.int32))
        return td.set("action", action).set("chosen_action_value", chosen)


class QValueActor(TDSequential):
    """Q-net and greedy head: ``module`` (a TDModule, or a network that is
    wrapped to write ``"action_value"`` from ``in_keys``), then
    :class:`QValueModule`."""

    def __init__(self, module: nn.Module, in_keys=("observation",), one_hot: bool = False):
        qnet = module if isinstance(module, TDModule) else TDModule(module, in_keys,
                                                                   ("action_value",))
        super().__init__(qnet, QValueModule(one_hot=one_hot))


ActorValueOperator = not_ported("ActorValueOperator", __name__,
                                "A7: shared-trunk actor-critics")
