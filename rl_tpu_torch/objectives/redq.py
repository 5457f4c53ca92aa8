"""REDQ, randomized ensembled double Q-learning (counterpart of
:mod:`rl_tpu.objectives.redq`; ``REDQLoss`` is ported).

SAC with a large critic ensemble (``num_qvalue_nets``, 10 by default)
whose TD target takes the min over a random subset of
``sub_sample_len`` members, drawn anew at every call without
replacement. The reference draws it with ``jax.random.choice(...,
replace=False)``; here it is the first ``sub_sample_len`` positions of
an argsort of uniform keys from the generator, which a CUDA graph can
hold (no host read). ``noise=(eps_next, eps_pi, subset)`` replaces all
three draws (``subset`` an int64 index tensor), so a test can feed both
packages the same subset.
"""

from __future__ import annotations

import torch

from ..data.arraydict import ArrayDict
from .common import bootstrap_discount
from .sac import SACLoss

__all__ = ["REDQLoss"]


class REDQLoss(SACLoss):
    def __init__(self, actor, qvalue_module, num_qvalue_nets: int = 10,
                 sub_sample_len: int = 2, **sac_kwargs):
        super().__init__(actor, qvalue_module, num_qvalue_nets=num_qvalue_nets, **sac_kwargs)
        self.sub_sample_len = sub_sample_len

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        if noise is None and generator is None:
            raise ValueError("REDQLoss needs a torch.Generator or the noise")
        eps_next, eps_pi, subset = noise if noise is not None else (None, None, None)
        alpha = torch.exp(self.log_alpha.detach())

        # -- critic loss: the target from a random subset of the ensemble -----
        with torch.no_grad():
            if subset is None:
                keys = torch.rand(self.num_qvalue_nets, generator=generator,
                                  device=alpha.device)
                subset = torch.argsort(keys)[: self.sub_sample_len]
            next_dist, _ = self.actor.get_dist(batch["next"])
            next_a = next_dist.sample(generator, eps=eps_next)
            next_lp = next_dist.log_prob(next_a)
            next_q_all = self._q(self.target_qvalue, batch["next", "observation"], next_a)
            next_v = torch.min(next_q_all[subset], dim=0).values - alpha * next_lp
            not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
            target = (batch["next", "reward"]
                      + bootstrap_discount(batch, self.gamma) * not_term * next_v)
        qs = self._q(self.qvalue, batch["observation"], batch["action"])
        td_error = qs - target[None]
        loss_qvalue = 0.5 * torch.mean(torch.sum(td_error**2, dim=0))

        # -- actor loss: against the mean of the whole ensemble ----------------
        dist, _ = self.actor.get_dist(batch)
        a_pi = dist.rsample(generator, eps=eps_pi)
        lp_pi = dist.log_prob(a_pi)
        q_pi = self._q(self.qvalue, batch["observation"], a_pi, held_out=True)
        loss_actor = torch.mean(alpha * lp_pi - torch.mean(q_pi, dim=0))

        t_ent = self.target_entropy(self._action_dim or a_pi.shape[-1])
        loss_alpha = -self.log_alpha * torch.mean((lp_pi + t_ent).detach())

        total = loss_qvalue + loss_actor + loss_alpha
        return total, ArrayDict(
            loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
            loss_alpha=loss_alpha.detach(), alpha=alpha, entropy=(-lp_pi.mean()).detach(),
            td_error=td_error.detach().abs().mean(dim=0))
