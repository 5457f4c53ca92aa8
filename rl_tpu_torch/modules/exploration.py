"""Exploration wrappers (counterpart of :mod:`rl_tpu.modules.exploration`;
``EGreedyModule`` is ported).

The annealing state rides in the ArrayDict under ``("exploration",
name)``, so a collector carries it from step to step as the reference's
scan does. A module post-processes the ``"action"`` an inner policy wrote
under ``ExplorationType.RANDOM`` and passes it through under the other
types. Its draws come from an explicit ``torch.Generator``, or are given
(``draws``): the two packages draw different random streams, so a test
feeds both the same numbers.
"""

from __future__ import annotations

import torch

from .._stubs import not_ported
from ..data.arraydict import ArrayDict
from ..data.specs import Spec
from ..envs.utils import ExplorationType, exploration_type

__all__ = ["EGreedyModule", "AdditiveGaussianModule", "OrnsteinUhlenbeckModule", "RandomPolicy"]


def _anneal(eps_init: float, eps_end: float, steps: int, t: torch.Tensor) -> torch.Tensor:
    """Linear from ``eps_init`` at step 0 to ``eps_end`` at ``steps``, then
    flat (float32)."""
    frac = torch.clamp(t.to(torch.float32) / steps, 0.0, 1.0)
    return eps_init + (eps_end - eps_init) * frac


class EGreedyModule:
    """Epsilon-greedy over discrete actions, epsilon annealed over
    ``annealing_num_steps`` calls.

    State key: ``("exploration", "eg_step")``. ``spec`` draws the random
    actions (categorical or one-hot, whatever the env expects). A row
    explores where its uniform draw is below epsilon (the reference's
    ``jax.random.bernoulli``).
    """

    def __init__(self, spec: Spec, eps_init: float = 1.0, eps_end: float = 0.1,
                 annealing_num_steps: int = 1000):
        self.spec = spec
        self.eps_init = eps_init
        self.eps_end = eps_end
        self.annealing_num_steps = annealing_num_steps

    def init_state(self, device=None) -> ArrayDict:
        return ArrayDict(eg_step=torch.zeros((), dtype=torch.int32, device=device))

    def __call__(self, td: ArrayDict, generator: torch.Generator | None = None,
                 draws: tuple[torch.Tensor, torch.Tensor] | None = None) -> ArrayDict:
        """``draws = (u, random_action)`` replaces the generator's: ``u``
        uniform in [0, 1) over the batch, ``random_action`` the spec's
        draw over the batch."""
        if exploration_type() != ExplorationType.RANDOM:
            return td
        action = td["action"]
        estate = (td["exploration"] if "exploration" in td
                  else self.init_state(action.device))
        t = estate["eg_step"]
        eps = _anneal(self.eps_init, self.eps_end, self.annealing_num_steps, t)
        batch = tuple(action.shape[: action.dim() - len(self.spec.shape)])
        if draws is None:
            if generator is None:
                raise ValueError("EGreedyModule needs a torch.Generator or the draws")
            u = torch.rand(batch, generator=generator, device=action.device)
            rand_action = self.spec.rand(batch, generator)
        else:
            u, rand_action = draws
        explore = u < eps
        d = explore.reshape(explore.shape + (1,) * (action.dim() - explore.dim()))
        action = torch.where(d, rand_action.to(action.dtype), action)
        return td.set("action", action).set("exploration", estate.set("eg_step", t + 1))


AdditiveGaussianModule = not_ported("AdditiveGaussianModule", __name__, "A6: TD3 and DDPG")
OrnsteinUhlenbeckModule = not_ported("OrnsteinUhlenbeckModule", __name__, "A6: TD3 and DDPG")
RandomPolicy = not_ported("RandomPolicy", __name__, "A7: the remaining modules")
