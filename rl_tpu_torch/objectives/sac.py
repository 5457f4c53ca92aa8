"""Soft actor-critic (counterpart of :mod:`rl_tpu.objectives.sac`;
``SACLoss`` and ``DiscreteSACLoss`` are ported).

Children after :meth:`SACLoss.init_params`: ``actor``, ``qvalue`` (an
:class:`~rl_tpu_torch.modules.Ensemble` of ``num_qvalue_nets`` critics),
``target_qvalue`` (its copy, no gradients) and ``log_alpha``. The loss is
the reference's, term by term:

- critic: the next action is *sampled* from the actor held out, scored by
  the held-out target critics (min over the ensemble, minus ``alpha *
  log_prob``); ``loss_qvalue = 0.5 * mean(sum_critics(td^2) * weight)``
  with the PER importance weight ``_weight`` when the batch has one;
- actor: the policy action is ``rsample``\\ d, scored by the held-out
  critics; ``loss_actor = mean(alpha * log_prob - min_q)``;
- alpha: ``-log_alpha * mean(log_prob + target_entropy)``, held out.

``td_error`` (a metric) is the mean over critics of ``|Q - target|`` per
sample, what prioritized replay writes back. ``noise=(eps_next, eps_pi)``
replaces the two standard-normal draws (each the loc's shape), so a test
can feed both packages the same noise.

:class:`DiscreteSACLoss` takes the expectation over the whole categorical
instead of sampling, so it draws nothing.
"""

from __future__ import annotations

import copy
import math

import torch

from ..data.arraydict import ArrayDict
from ..modules.networks import apply_ensemble, init_ensemble
from .common import LossModule, bootstrap_discount

__all__ = ["SACLoss", "DiscreteSACLoss"]


class SACLoss(LossModule):
    """Soft actor-critic, v2 form (no value net)."""

    target_keys = ("target_qvalue",)

    def __init__(self, actor, qvalue_module, num_qvalue_nets: int = 2, gamma: float = 0.99,
                 target_entropy: float | str = "auto", alpha_init: float = 1.0,
                 fixed_alpha: bool = False, action_dim: int | None = None):
        super().__init__()
        self.actor = actor
        self.qvalue_module = qvalue_module  # the template the ensemble stacks
        self.num_qvalue_nets = num_qvalue_nets
        self.gamma = gamma
        self.alpha_init = alpha_init
        self.fixed_alpha = fixed_alpha
        self._target_entropy = target_entropy
        self._action_dim = action_dim
        self.qvalue = None
        self.target_qvalue = None
        self.log_alpha = None

    def target_entropy(self, action_dim: int) -> float:
        if self._target_entropy == "auto":
            return -float(action_dim)
        return float(self._target_entropy)

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build (or rebuild) the actor for ``td``, the critics for its
        observation and the actor's mode action, the target copies and
        ``log_alpha = log(alpha_init)``."""
        self.actor.init(td, generator)
        dist, _ = self.actor.get_dist(td)
        action = dist.mode
        self.qvalue = init_ensemble(self.qvalue_module, self.num_qvalue_nets,
                                    td["observation"], action, generator=generator)
        self.target_qvalue = copy.deepcopy(self.qvalue).requires_grad_(False)
        self.log_alpha = torch.nn.Parameter(torch.tensor(
            math.log(self.alpha_init), dtype=torch.float32, device=action.device))
        if self._action_dim is None:
            self._action_dim = action.shape[-1]
        return self

    def _q(self, ensemble, obs, action, held_out=False):
        return apply_ensemble(ensemble, obs, action, held_out=held_out)[..., 0]  # [n, batch]

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        eps_next, eps_pi = noise if noise is not None else (None, None)
        if self.fixed_alpha:
            alpha = torch.full((), math.exp(math.log(self.alpha_init)), dtype=torch.float32,
                               device=self.log_alpha.device)
        else:
            alpha = torch.exp(self.log_alpha.detach())

        # -- critic loss -----------------------------------------------------
        with torch.no_grad():
            next_dist, _ = self.actor.get_dist(batch["next"])
            next_a = next_dist.sample(generator, eps=eps_next)
            next_lp = next_dist.log_prob(next_a)
            next_q = self._q(self.target_qvalue, batch["next", "observation"], next_a)
            next_v = torch.min(next_q, dim=0).values - alpha * next_lp
            not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
            target = (batch["next", "reward"]
                      + bootstrap_discount(batch, self.gamma) * not_term * next_v)
        qs = self._q(self.qvalue, batch["observation"], batch["action"])
        td_error = qs - target[None]
        weight = batch["_weight"] if "_weight" in batch else 1.0
        loss_qvalue = 0.5 * torch.mean(torch.sum(td_error**2, dim=0) * weight)

        # -- actor loss ------------------------------------------------------
        dist, _ = self.actor.get_dist(batch)
        a_pi = dist.rsample(generator, eps=eps_pi)
        lp_pi = dist.log_prob(a_pi)
        q_pi = self._q(self.qvalue, batch["observation"], a_pi, held_out=True)
        loss_actor = torch.mean(alpha * lp_pi - torch.min(q_pi, dim=0).values)

        # -- alpha loss ------------------------------------------------------
        t_ent = self.target_entropy(self._action_dim or a_pi.shape[-1])
        if self.fixed_alpha:
            loss_alpha = torch.zeros((), device=qs.device)
        else:
            loss_alpha = -self.log_alpha * torch.mean((lp_pi + t_ent).detach())

        total = loss_qvalue + loss_actor + loss_alpha
        metrics = ArrayDict(
            loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
            loss_alpha=loss_alpha.detach(), alpha=alpha,
            entropy=(-lp_pi.mean()).detach(), td_error=td_error.detach().abs().mean(dim=0),
        )
        return total, metrics


class DiscreteSACLoss(LossModule):
    """Discrete-action SAC: the critics map an observation to one value an
    action (``qvalue_module`` an MLP with ``num_actions`` outputs), the
    actor is a ``ProbabilisticActor`` over a ``Categorical``, and every
    term is an expectation under the policy's probabilities. The target
    entropy is ``target_entropy_weight * log(num_actions)``."""

    target_keys = ("target_qvalue",)

    def __init__(self, actor, qvalue_module, num_actions: int, num_qvalue_nets: int = 2,
                 gamma: float = 0.99, target_entropy_weight: float = 0.98,
                 alpha_init: float = 1.0):
        super().__init__()
        self.actor = actor
        self.qvalue_module = qvalue_module
        self.num_actions = num_actions
        self.num_qvalue_nets = num_qvalue_nets
        self.gamma = gamma
        # log in float32, as the reference's jnp.log of the int
        log_n = torch.log(torch.tensor(float(num_actions), dtype=torch.float32)).item()
        self.target_entropy = target_entropy_weight * log_n
        self.alpha_init = alpha_init
        self.qvalue = None
        self.target_qvalue = None
        self.log_alpha = None

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build the actor and the critics for ``td``'s observation, the
        target copies and ``log_alpha = log(alpha_init)``."""
        self.actor.init(td, generator)
        obs = td["observation"]
        self.qvalue = init_ensemble(self.qvalue_module, self.num_qvalue_nets, obs,
                                    generator=generator)
        self.target_qvalue = copy.deepcopy(self.qvalue).requires_grad_(False)
        self.log_alpha = torch.nn.Parameter(torch.tensor(
            math.log(self.alpha_init), dtype=torch.float32, device=obs.device))
        return self

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        alpha = torch.exp(self.log_alpha.detach())

        with torch.no_grad():
            next_dist, _ = self.actor.get_dist(batch["next"])
            next_probs = next_dist.probs
            next_logp = torch.log(torch.clamp(next_probs, min=1e-8))
            next_q = apply_ensemble(self.target_qvalue, batch["next", "observation"])
            next_v = torch.sum(next_probs[None] * (next_q - alpha * next_logp[None]), dim=-1)
            next_v = torch.min(next_v, dim=0).values
            not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
            target = (batch["next", "reward"]
                      + bootstrap_discount(batch, self.gamma) * not_term * next_v)

        qs = apply_ensemble(self.qvalue, batch["observation"])  # [n, batch, actions]
        action = batch["action"]
        if action.dim() == qs.dim() - 1:  # one-hot [batch, actions]
            chosen = torch.sum(qs * action[None], dim=-1)
        else:
            idx = action.to(torch.int64)[None, ..., None].expand(qs.shape[:-1] + (1,))
            chosen = torch.gather(qs, -1, idx)[..., 0]
        td_error = chosen - target[None]
        weight = batch["_weight"] if "_weight" in batch else 1.0
        loss_qvalue = 0.5 * torch.mean(torch.sum(td_error**2, dim=0) * weight)

        dist, _ = self.actor.get_dist(batch)
        probs = dist.probs
        logp = torch.log(torch.clamp(probs, min=1e-8))
        q_pi = torch.min(apply_ensemble(self.qvalue, batch["observation"], held_out=True),
                         dim=0).values
        loss_actor = torch.mean(torch.sum(probs * (alpha * logp - q_pi), dim=-1))

        entropy = -torch.sum(probs * logp, dim=-1)
        loss_alpha = -self.log_alpha * torch.mean((self.target_entropy - entropy).detach())

        total = loss_qvalue + loss_actor + loss_alpha
        return total, ArrayDict(
            loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
            loss_alpha=loss_alpha.detach(), alpha=alpha, entropy=entropy.detach().mean(),
            td_error=td_error.detach().abs().mean(dim=0))
