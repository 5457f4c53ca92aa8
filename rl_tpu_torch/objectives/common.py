"""Loss-module base and target-network updates (counterpart of
:mod:`rl_tpu.objectives.common`; ``LossModule``, ``SoftUpdate``,
``hold_out`` and ``bootstrap_discount`` are ported).

A loss is an ``nn.Module`` that owns its sub-modules' parameters. Its
children named in ``target_keys`` (for example ``"target_qvalue"``) are
target copies: excluded from :meth:`LossModule.trainable_parameters`,
never given gradients, and moved toward their sources (the child of the
same name without ``target_``) by :class:`SoftUpdate`.
"""

from __future__ import annotations

import torch
from torch import nn

from .._stubs import not_ported
from ..data.arraydict import ArrayDict

__all__ = ["LossModule", "SoftUpdate", "bootstrap_discount", "hold_out"]


def bootstrap_discount(batch: ArrayDict, gamma: float):
    """``gamma ** steps_to_next_obs`` when the batch carries n-step-folded
    transitions, else ``gamma``."""
    if "steps_to_next_obs" in batch:
        return torch.pow(gamma, batch["steps_to_next_obs"].to(torch.float32))
    return gamma


def hold_out(tensors):
    """Cut tensors from the graph (the reference's ``stop_gradient`` of a
    param tree)."""
    return [t.detach() for t in tensors]


class LossModule(nn.Module):
    """Base: subclasses build their children in ``init_params(td,
    generator)`` and compute ``forward(batch, generator=None, noise=None)
    -> (loss, metrics ArrayDict)``."""

    target_keys: tuple[str, ...] = ()

    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        raise NotImplementedError

    def trainable_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """``(name, parameter)`` of everything but the targets, in
        ``named_parameters`` order."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".")[0] not in self.target_keys]

    def target_pairs(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``(source, target)`` parameter pairs of every target child."""
        pairs = []
        for tk in self.target_keys:
            src = getattr(self, tk.removeprefix("target_"))
            pairs += list(zip(src.parameters(), getattr(self, tk).parameters()))
        return pairs

    def grad(self, batch: ArrayDict, generator=None, noise=None):
        """``(loss, gradients of trainable_parameters() in order,
        metrics)``: one forward, one backward."""
        params = [p for _, p in self.trainable_parameters()]
        loss, metrics = self(batch, generator=generator, noise=noise)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads), metrics


class SoftUpdate:
    """Polyak averaging: ``target <- tau * source + (1 - tau) * target``,
    written as ``optax.incremental_update`` writes it (``lerp`` rounds
    differently). With ``ok`` (a 0-dim bool tensor) the targets move only
    where it holds, without reading it on the host."""

    def __init__(self, loss: LossModule, tau: float = 0.005, eps: float | None = None):
        if eps is not None:
            tau = 1.0 - eps
        self.loss = loss
        self.tau = tau

    @torch.no_grad()
    def __call__(self, ok: torch.Tensor | None = None) -> None:
        for src, tgt in self.loss.target_pairs():
            new = self.tau * src + (1.0 - self.tau) * tgt
            tgt.copy_(new if ok is None else torch.where(ok, new, tgt))


HardUpdate = not_ported("HardUpdate", __name__, "A6: hard target copies come with DQN")
masked_mean = not_ported("masked_mean", __name__, "A7: masked losses come with PPO")
ActorCriticLossMixin = not_ported("ActorCriticLossMixin", __name__,
                                  "A7: actor-critic losses come with PPO")
