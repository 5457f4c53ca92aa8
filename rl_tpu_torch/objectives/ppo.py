"""PPO family, A2C and REINFORCE (counterpart of :mod:`rl_tpu.objectives.ppo`).

Each loss is an ``nn.Module`` with children ``actor`` (a
:class:`~rl_tpu_torch.modules.ProbabilisticActor`) and ``critic`` (a
:class:`~rl_tpu_torch.modules.ValueOperator`), built by ``init_params(td,
generator)``; ``forward(batch, generator=None, noise=None) -> (loss,
metrics)``. The batch's stored log-probs, advantages and value targets
are data (no gradient flows into them), and the metrics are detached.
Metric names are the reference's: "loss_objective", "loss_critic",
"loss_entropy", "entropy", "kl_approx", "ESS", "clip_fraction", "kl",
"beta".
"""

from __future__ import annotations

import torch

from ..data.arraydict import ArrayDict
from .common import ActorCriticLossMixin, masked_mean

__all__ = ["PPOLoss", "ClipPPOLoss", "KLPENPPOLoss", "A2CLoss", "ReinforceLoss"]


@torch.no_grad()
def _masked_ess(log_weight: torch.Tensor, mask) -> torch.Tensor:
    """Effective sample size over the valid elements, as a fraction of
    their count: ``exp(2 lse(w) - lse(2 w)) / n``."""
    lw = log_weight
    if mask is not None:
        m = torch.broadcast_to(mask.reshape(tuple(mask.shape) + (1,) * (lw.dim() - mask.dim())),
                               lw.shape)
        lw = torch.where(m.to(torch.bool), lw, float("-inf"))
        n = torch.clamp(torch.sum(m.to(torch.float32)), min=1.0)
    else:
        n = lw.numel()
    lw = lw.reshape(-1)
    return torch.exp(2 * torch.logsumexp(lw, 0) - torch.logsumexp(2 * lw, 0)) / n


class PPOLoss(ActorCriticLossMixin):
    """Vanilla PPO (the importance-weighted objective, no clipping)."""

    def __init__(self, actor, critic, entropy_coeff: float = 0.01, critic_coeff: float = 1.0,
                 loss_critic_type: str = "smooth_l1", normalize_advantage: bool = False,
                 clip_value: float | None = None, mask_key: str | None = "mask"):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.entropy_coeff = entropy_coeff
        self.critic_coeff = critic_coeff
        self.loss_critic_type = loss_critic_type
        self.normalize_advantage = normalize_advantage
        self.clip_value = clip_value
        self.mask_key = mask_key
        self.value_estimator = None

    def _log_weight(self, batch):
        dist, _ = self.actor.get_dist(batch)
        log_prob = dist.log_prob(batch["action"])
        return log_prob - batch["sample_log_prob"].detach(), dist, log_prob

    @staticmethod
    def _entropy(dist, log_prob):
        try:
            return dist.entropy()
        except NotImplementedError:  # a single-sample estimate, as the reference falls back
            return -log_prob

    def _advantage(self, batch, mask):
        adv = batch["advantage"]
        if self.normalize_advantage:
            mu = masked_mean(adv, mask)
            sd = torch.sqrt(torch.clamp(masked_mean((adv - mu) ** 2, mask), min=1e-12))
            adv = (adv - mu) / torch.clamp(sd, min=1e-6)
        return adv

    def _critic_error(self, value, target):
        diff = value - target
        if self.loss_critic_type == "l2":
            return diff**2
        # smooth_l1
        return torch.where(torch.abs(diff) < 1.0, 0.5 * diff * diff, torch.abs(diff) - 0.5)

    def loss_critic(self, batch, mask):
        value = self._value(batch)
        target = batch["value_target"].detach()
        err = self._critic_error(value, target)
        if self.clip_value is not None and "state_value" in batch:
            # PPO's value clipping around the behaviour-time value
            old = batch["state_value"].detach()
            clipped = old + torch.clamp(value - old, -self.clip_value, self.clip_value)
            err = torch.maximum(err, self._critic_error(clipped, target))
        return masked_mean(err, mask)

    def _objective(self, log_weight, adv, mask):
        return -masked_mean(torch.exp(log_weight) * adv, mask), {}

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        batch = self._ensure_advantage(batch)
        mask = self._mask(batch)
        adv = self._advantage(batch, mask)
        log_weight, dist, log_prob = self._log_weight(batch)
        loss_obj, extra = self._objective(log_weight, adv, mask)
        entropy = self._entropy(dist, log_prob)
        loss_entropy = -self.entropy_coeff * masked_mean(entropy, mask)
        loss_critic = self.critic_coeff * self.loss_critic(batch, mask)
        total = loss_obj + loss_entropy + loss_critic
        metrics = ArrayDict(
            loss_objective=loss_obj.detach(), loss_critic=loss_critic.detach(),
            loss_entropy=loss_entropy.detach(),
            entropy=masked_mean(entropy.detach(), mask),
            kl_approx=masked_mean(-log_weight.detach(), mask),
            ESS=_masked_ess(log_weight, mask), **extra)
        return total, metrics


class ClipPPOLoss(PPOLoss):
    """PPO with the clipped surrogate objective."""

    def __init__(self, actor, critic, clip_epsilon: float = 0.2, **kwargs):
        super().__init__(actor, critic, **kwargs)
        self.clip_epsilon = clip_epsilon

    def _objective(self, log_weight, adv, mask):
        ratio = torch.exp(log_weight)
        clipped = torch.clamp(ratio, 1.0 - self.clip_epsilon, 1.0 + self.clip_epsilon)
        gain = torch.minimum(ratio * adv, clipped * adv)
        clip_fraction = masked_mean(
            (torch.abs(ratio.detach() - 1.0) > self.clip_epsilon).to(torch.float32), mask)
        return -masked_mean(gain, mask), {"clip_fraction": clip_fraction}


class KLPENPPOLoss(PPOLoss):
    """KL-penalised PPO: an adaptive penalty ``beta`` on KL(pi_old || pi),
    estimated from the stored log-probs. The adapted beta comes back in
    the metrics ("beta"); the caller feeds it back through ``beta``."""

    def __init__(self, actor, critic, dtarg: float = 0.01, beta: float = 1.0,
                 increment: float = 2.0, decrement: float = 0.5, **kwargs):
        super().__init__(actor, critic, **kwargs)
        self.dtarg = dtarg
        self.beta_init = beta
        self.increment = increment
        self.decrement = decrement

    def forward(self, batch, generator=None, noise=None, beta=None):
        batch = self._ensure_advantage(batch)
        dev = batch["advantage"].device
        beta = torch.as_tensor(self.beta_init if beta is None else beta, dtype=torch.float32,
                               device=dev)
        mask = self._mask(batch)
        adv = self._advantage(batch, mask)
        log_weight, dist, log_prob = self._log_weight(batch)
        kl = masked_mean(-log_weight, mask)  # E_old[log old - log new]
        loss_obj = -masked_mean(torch.exp(log_weight) * adv, mask) + beta * kl
        entropy = self._entropy(dist, log_prob)
        loss_entropy = -self.entropy_coeff * masked_mean(entropy, mask)
        loss_critic = self.critic_coeff * self.loss_critic(batch, mask)
        total = loss_obj + loss_entropy + loss_critic
        kl_d = kl.detach()
        new_beta = torch.where(kl_d > 1.5 * self.dtarg, beta * self.increment,
                               torch.where(kl_d < self.dtarg / 1.5, beta * self.decrement, beta))
        metrics = ArrayDict(
            loss_objective=loss_obj.detach(), loss_critic=loss_critic.detach(),
            loss_entropy=loss_entropy.detach(),
            entropy=masked_mean(entropy.detach(), mask), kl=kl_d, beta=new_beta.detach())
        return total, metrics


class A2CLoss(ActorCriticLossMixin):
    """Advantage actor-critic: the policy gradient weighted by the
    advantage, no importance ratio."""

    def __init__(self, actor, critic, entropy_coeff: float = 0.01, critic_coeff: float = 0.5,
                 mask_key: str | None = "mask"):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.entropy_coeff = entropy_coeff
        self.critic_coeff = critic_coeff
        self.mask_key = mask_key
        self.value_estimator = None

    def forward(self, batch, generator=None, noise=None):
        batch = self._ensure_advantage(batch)
        mask = self._mask(batch)
        dist, _ = self.actor.get_dist(batch)
        log_prob = dist.log_prob(batch["action"])
        adv = batch["advantage"].detach()
        loss_obj = -masked_mean(log_prob * adv, mask)
        entropy = PPOLoss._entropy(dist, log_prob)
        loss_entropy = -self.entropy_coeff * masked_mean(entropy, mask)
        value = self._value(batch)
        target = batch["value_target"].detach()
        loss_critic = self.critic_coeff * masked_mean((value - target) ** 2, mask)
        total = loss_obj + loss_entropy + loss_critic
        return total, ArrayDict(
            loss_objective=loss_obj.detach(), loss_critic=loss_critic.detach(),
            loss_entropy=loss_entropy.detach(), entropy=masked_mean(entropy.detach(), mask))


class ReinforceLoss(ActorCriticLossMixin):
    """REINFORCE with a value baseline."""

    def __init__(self, actor, critic, critic_coeff: float = 1.0, mask_key=None):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.critic_coeff = critic_coeff
        self.mask_key = mask_key
        self.value_estimator = None

    def forward(self, batch, generator=None, noise=None):
        batch = self._ensure_advantage(batch)
        mask = self._mask(batch)
        log_prob = self.actor.log_prob(batch)
        adv = batch["advantage"].detach()
        loss_obj = -masked_mean(log_prob * adv, mask)
        value = self._value(batch)
        target = batch["value_target"].detach()
        loss_critic = self.critic_coeff * masked_mean((value - target) ** 2, mask)
        return loss_obj + loss_critic, ArrayDict(loss_objective=loss_obj.detach(),
                                                 loss_critic=loss_critic.detach())
