"""DDPG, TD3 and TD3+BC (counterpart of :mod:`rl_tpu.objectives.ddpg`;
``DDPGLoss``, ``TD3Loss`` and ``TD3BCLoss`` are ported).

The actor is a deterministic :class:`~rl_tpu_torch.modules.TDModule`
writing ``"action"`` (a :class:`~rl_tpu_torch.modules.TanhPolicy`); the
critics are an :class:`~rl_tpu_torch.modules.Ensemble` built from a
``(obs, action) -> [.., 1]`` template (one critic for DDPG, twins for
TD3). Children after ``init_params``: ``actor``, ``qvalue``,
``target_actor`` and ``target_qvalue`` (copies, no gradients).

TD3's target-policy smoothing noise is ``clip(policy_noise * eps,
-noise_clip, noise_clip)`` with ``eps`` standard normal of the action's
shape, drawn from the generator or given as ``noise=(eps,)`` so that a
test can feed both packages the same draw; a call with neither raises,
as the reference's call without a key does. The actor-update delay is
``OffPolicyConfig(policy_delay=2)``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..data.arraydict import ArrayDict
from ..modules.networks import apply_ensemble, init_ensemble
from .common import LossModule, bootstrap_discount

__all__ = ["DDPGLoss", "TD3BCLoss", "TD3Loss"]


def _as_bound(v):
    """A scalar bound as a float (no tensor to copy inside a graph), else
    a float32 tensor moved to the action's device where it is used."""
    return float(v) if np.ndim(v) == 0 else torch.as_tensor(np.asarray(v, np.float32))


class _DeterministicActorCritic(LossModule):
    """The actor, ``num_qvalue_nets`` critics and their target copies."""

    target_keys = ("target_actor", "target_qvalue")
    num_qvalue_nets = 1

    def __init__(self, actor, qvalue_module, gamma: float = 0.99):
        super().__init__()
        self.actor = actor  # TDModule: obs -> "action"
        self.qvalue_module = qvalue_module
        self.gamma = gamma
        self.qvalue = None
        self.target_actor = None
        self.target_qvalue = None

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build the actor for ``td``, the critics for its observation and
        the actor's action, and the target copies."""
        action = self.actor.init(td, generator)["action"]
        self.qvalue = init_ensemble(self.qvalue_module, self.num_qvalue_nets,
                                    td["observation"], action, generator=generator)
        self.target_actor = copy.deepcopy(self.actor).requires_grad_(False)
        self.target_qvalue = copy.deepcopy(self.qvalue).requires_grad_(False)
        return self

    def _q(self, ensemble, obs, action, held_out=False):
        return apply_ensemble(ensemble, obs, action, held_out=held_out)[..., 0]  # [n, batch]

    def _target(self, batch: ArrayDict, next_v: torch.Tensor) -> torch.Tensor:
        not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
        return batch["next", "reward"] + bootstrap_discount(batch, self.gamma) * not_term * next_v


class DDPGLoss(_DeterministicActorCritic):
    """Deterministic policy gradient with a target actor and critic."""

    def __init__(self, actor, qvalue_module, gamma: float = 0.99, loss_function: str = "l2"):
        super().__init__(actor, qvalue_module, gamma)
        self.loss_function = loss_function

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        with torch.no_grad():
            next_a = self.target_actor(batch["next"])["action"]
            next_q = self._q(self.target_qvalue, batch["next", "observation"], next_a)[0]
            target = self._target(batch, next_q)
        q = self._q(self.qvalue, batch["observation"], batch["action"])[0]
        td_error = q - target
        if self.loss_function == "smooth_l1":
            a = td_error.abs()
            loss_value = torch.mean(torch.where(a < 1.0, 0.5 * td_error**2, a - 0.5))
        else:
            loss_value = torch.mean(td_error**2)

        a_pi = self.actor(batch)["action"]
        q_pi = self._q(self.qvalue, batch["observation"], a_pi, held_out=True)[0]
        loss_actor = -torch.mean(q_pi)
        total = loss_value + loss_actor
        return total, ArrayDict(loss_value=loss_value.detach(), loss_actor=loss_actor.detach(),
                                td_error=td_error.detach().abs(), pred_value=q.detach().mean())


class TD3Loss(_DeterministicActorCritic):
    """Twin critics, clipped target-policy smoothing noise, the min of the
    two targets; the actor is scored by the first critic."""

    def __init__(self, actor, qvalue_module, action_low, action_high, num_qvalue_nets: int = 2,
                 gamma: float = 0.99, policy_noise: float = 0.2, noise_clip: float = 0.5):
        super().__init__(actor, qvalue_module, gamma)
        self.num_qvalue_nets = num_qvalue_nets
        self.policy_noise = policy_noise
        self.noise_clip = noise_clip
        self.action_low = _as_bound(action_low)
        self.action_high = _as_bound(action_high)

    def _bound(self, v, like: torch.Tensor):
        return v if isinstance(v, float) else v.to(like.device)

    def _critic_loss(self, batch: ArrayDict, generator, noise):
        """The twin-critic TD loss, and the policy's action and first
        critic's Q that the actor terms reuse."""
        if noise is None and generator is None:
            raise ValueError(f"{type(self).__name__} needs a torch.Generator or the noise "
                             "(target policy smoothing)")
        with torch.no_grad():
            next_a = self.target_actor(batch["next"])["action"]
            eps = noise[0] if noise is not None else torch.randn(
                next_a.shape, generator=generator, device=next_a.device, dtype=next_a.dtype)
            smooth = torch.clamp(self.policy_noise * eps, -self.noise_clip, self.noise_clip)
            next_a = torch.clamp(next_a + smooth, self._bound(self.action_low, next_a),
                                 self._bound(self.action_high, next_a))
            next_q = self._q(self.target_qvalue, batch["next", "observation"], next_a)
            target = self._target(batch, torch.min(next_q, dim=0).values)
        qs = self._q(self.qvalue, batch["observation"], batch["action"])
        td_error = qs - target[None]
        loss_qvalue = torch.mean(torch.sum(td_error**2, dim=0))
        a_pi = self.actor(batch)["action"]
        q_pi = self._q(self.qvalue, batch["observation"], a_pi, held_out=True)[0]
        return loss_qvalue, td_error, a_pi, q_pi

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        loss_qvalue, td_error, _, q_pi = self._critic_loss(batch, generator, noise)
        loss_actor = -torch.mean(q_pi)
        total = loss_qvalue + loss_actor
        return total, ArrayDict(loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
                                td_error=td_error.detach().abs().mean(dim=0))


class TD3BCLoss(TD3Loss):
    """TD3+BC (offline): TD3's critic objective; the actor's becomes
    ``-lambda Q(s, pi(s)) + (pi(s) - a)^2`` with ``lambda = alpha /
    mean(|Q(s, pi(s))|)``, held out."""

    def __init__(self, *args, alpha: float = 2.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = alpha

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        loss_qvalue, td_error, a_pi, q_pi = self._critic_loss(batch, generator, noise)
        lam = self.alpha / (q_pi.abs().mean() + 1e-8).detach()
        bc = torch.mean(torch.sum((a_pi - batch["action"]) ** 2, dim=-1))
        loss_actor = -lam * torch.mean(q_pi) + bc
        total = loss_qvalue + loss_actor
        return total, ArrayDict(loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
                                bc_loss=bc.detach(), lmbda=lam,
                                td_error=td_error.detach().abs().mean(dim=0))
