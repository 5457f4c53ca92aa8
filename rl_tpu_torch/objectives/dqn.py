"""DQN losses (counterpart of :mod:`rl_tpu.objectives.dqn`; ``DQNLoss`` is
ported).

The batch holds flat transitions ``{observation, action, "next":
{observation, reward, done, terminated}}``, as a replay buffer of
collector output does, with ``"steps_to_next_obs"`` after
:class:`~rl_tpu_torch.data.postprocs.MultiStep` and ``"_weight"`` from a
prioritized sampler. ``"td_error"`` goes out as a metric for the PER
write-back.
"""

from __future__ import annotations

import copy

import torch

from .._stubs import not_ported
from ..data.arraydict import ArrayDict
from .common import LossModule, bootstrap_discount, masked_mean

__all__ = ["DQNLoss", "DistributionalDQNLoss"]


def _gather_action_values(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``q`` at ``action``: an index (any integer dtype) or a one-hot
    encoding."""
    if action.dim() == q.dim():  # one-hot
        return torch.sum(q * action, dim=-1)
    return torch.gather(q, -1, action[..., None].to(torch.int64))[..., 0]


class DQNLoss(LossModule):
    """TD(0) Q-learning against a target network, double DQN by default.

    ``qnet`` is a TDModule writing ``"action_value"``; it becomes the
    child ``qvalue`` and a copy of it the target ``target_qvalue`` (moved
    by :class:`~rl_tpu_torch.objectives.common.SoftUpdate` or
    :class:`~rl_tpu_torch.objectives.common.HardUpdate`). ``loss_function``
    is ``"l2"`` or ``"smooth_l1"`` (Huber at 1).
    """

    target_keys = ("target_qvalue",)

    def __init__(self, qnet, gamma: float = 0.99, double_dqn: bool = True,
                 loss_function: str = "l2"):
        super().__init__()
        if loss_function not in ("l2", "smooth_l1"):
            raise ValueError(f"loss_function must be l2 or smooth_l1, got {loss_function!r}")
        self.qvalue = qnet
        self.target_qvalue = None
        self.gamma = gamma
        self.double_dqn = double_dqn
        self.loss_function = loss_function

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build the q-net for ``td``'s widths, then its target copy."""
        self.qvalue.init(td, generator)
        self.target_qvalue = copy.deepcopy(self.qvalue).requires_grad_(False)
        return self

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        q = self.qvalue(batch)["action_value"]
        chosen = _gather_action_values(q, batch["action"])
        with torch.no_grad():  # the reference's held-out params and stop_gradient
            next_q_target = self.target_qvalue(batch["next"])["action_value"]
            online = self.qvalue(batch["next"])["action_value"] if self.double_dqn else None
            next_a = torch.argmax(online if self.double_dqn else next_q_target, dim=-1)
            next_v = torch.gather(next_q_target, -1, next_a[..., None])[..., 0]
            not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
            target = (batch["next", "reward"]
                      + bootstrap_discount(batch, self.gamma) * not_term * next_v)
        td_error = chosen - target
        if self.loss_function == "smooth_l1":
            loss = torch.where(td_error.abs() < 1.0, 0.5 * td_error**2, td_error.abs() - 0.5)
        else:
            loss = td_error**2
        weight = batch["_weight"] if "_weight" in batch else None
        total = masked_mean(loss * (weight if weight is not None else 1.0), None)
        metrics = ArrayDict(loss_qvalue=total.detach(), td_error=td_error.detach().abs(),
                            q_mean=chosen.detach().mean())
        return total, metrics


DistributionalDQNLoss = not_ported("DistributionalDQNLoss", __name__,
                                   "A7: the remaining losses (C51)")
