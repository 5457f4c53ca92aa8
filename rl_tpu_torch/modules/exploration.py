"""Exploration wrappers (counterpart of :mod:`rl_tpu.modules.exploration`;
``EGreedyModule``, ``AdditiveGaussianModule`` and
``OrnsteinUhlenbeckModule`` are ported).

The annealing state rides in the ArrayDict under ``("exploration",
name)``, so a collector carries it from step to step as the reference's
scan does. A module post-processes the ``"action"`` an inner policy wrote
under ``ExplorationType.RANDOM`` and passes it through under the other
types. Its draws come from an explicit ``torch.Generator``, or are given
(``draws``): the two packages draw different random streams, so a test
feeds both the same numbers. Nothing is read back to the host, so a
collect through them stays capturable as a CUDA graph.
"""

from __future__ import annotations

import math

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


def _normal_draw(action: torch.Tensor, generator, eps, name: str) -> torch.Tensor:
    if eps is not None:
        return eps
    if generator is None:
        raise ValueError(f"{name} needs a torch.Generator or the draws")
    return torch.randn(action.shape, generator=generator, device=action.device,
                       dtype=action.dtype)


class AdditiveGaussianModule:
    """Additive Gaussian action noise, sigma annealed linearly from
    ``sigma_init`` to ``sigma_end`` over ``annealing_num_steps`` calls;
    the noisy action is projected into the spec.

    State key: ``("exploration", "ag_step")``.
    """

    def __init__(self, spec: Spec, sigma_init: float = 1.0, sigma_end: float = 0.1,
                 annealing_num_steps: int = 1000, mean: float = 0.0):
        self.spec = spec
        self.sigma_init = sigma_init
        self.sigma_end = sigma_end
        self.annealing_num_steps = annealing_num_steps
        self.mean = mean

    def init_state(self, device=None) -> ArrayDict:
        return ArrayDict(ag_step=torch.zeros((), dtype=torch.int32, device=device))

    def __call__(self, td: ArrayDict, generator: torch.Generator | None = None,
                 draws: torch.Tensor | None = None) -> ArrayDict:
        """``draws`` (standard normals of the action's shape) replaces the
        generator's."""
        if exploration_type() != ExplorationType.RANDOM:
            return td
        action = td["action"]
        estate = (td["exploration"] if "exploration" in td
                  else self.init_state(action.device))
        t = estate["ag_step"]
        sigma = _anneal(self.sigma_init, self.sigma_end, self.annealing_num_steps, t)
        eps = _normal_draw(action, generator, draws, "AdditiveGaussianModule")
        action = self.spec.project(action + (self.mean + sigma * eps))
        return td.set("action", action).set("exploration", estate.set("ag_step", t + 1))


class OrnsteinUhlenbeckModule:
    """Ornstein-Uhlenbeck action noise, temporally correlated:
    ``n <- n + theta (mu - n) dt + sigma sqrt(dt) eps``, with sigma
    annealed from ``sigma_init`` to ``sigma_end`` (both default to
    ``sigma``) and ``n`` reset to 0 where the td's ``is_init`` holds; the
    noisy action is projected into the spec.

    State keys: ``("exploration", "ou_noise")``, ``("exploration",
    "ou_step")``.
    """

    def __init__(self, spec: Spec, theta: float = 0.15, mu: float = 0.0, sigma: float = 0.2,
                 dt: float = 1e-2, sigma_init: float | None = None,
                 sigma_end: float | None = None, annealing_num_steps: int = 1000):
        self.spec = spec
        self.theta = theta
        self.mu = mu
        self.sigma = sigma
        self.sigma_init = sigma_init if sigma_init is not None else sigma
        self.sigma_end = sigma_end if sigma_end is not None else sigma
        self.annealing_num_steps = annealing_num_steps
        self.dt = dt

    def init_state(self, action_shape, device=None) -> ArrayDict:
        return ArrayDict(ou_noise=torch.zeros(tuple(action_shape), device=device),
                         ou_step=torch.zeros((), dtype=torch.int32, device=device))

    def __call__(self, td: ArrayDict, generator: torch.Generator | None = None,
                 draws: torch.Tensor | None = None) -> ArrayDict:
        """``draws`` (standard normals of the action's shape) replaces the
        generator's."""
        if exploration_type() != ExplorationType.RANDOM:
            return td
        action = td["action"]
        estate = (td["exploration"] if "exploration" in td
                  else self.init_state(action.shape, action.device))
        noise, t = estate["ou_noise"], estate["ou_step"]
        if "is_init" in td:
            flag = td["is_init"]
            flag = flag.reshape(flag.shape + (1,) * (noise.dim() - flag.dim()))
            noise = torch.where(flag, 0.0, noise)
        sigma = _anneal(self.sigma_init, self.sigma_end, self.annealing_num_steps, t)
        eps = _normal_draw(action, generator, draws, "OrnsteinUhlenbeckModule")
        noise = (noise + self.theta * (self.mu - noise) * self.dt
                 + sigma * math.sqrt(self.dt) * eps)
        estate = ArrayDict(ou_noise=noise, ou_step=t + 1)
        return td.set("action", self.spec.project(action + noise)).set("exploration", estate)


RandomPolicy = not_ported("RandomPolicy", __name__, "A7: the remaining modules")
