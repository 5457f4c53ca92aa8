"""Loss-module base and target-network updates (counterpart of
:mod:`rl_tpu.objectives.common`; ``LossModule``, ``SoftUpdate``,
``HardUpdate``, ``hold_out``, ``bootstrap_discount``, ``masked_mean`` and
``ActorCriticLossMixin`` are ported).

A loss is an ``nn.Module`` that owns its sub-modules' parameters. Its
children named in ``target_keys`` (for example ``"target_qvalue"``) are
target copies: excluded from :meth:`LossModule.trainable_parameters`,
never given gradients, and moved toward their sources (the child of the
same name without ``target_``) by :class:`SoftUpdate` or copied by
:class:`HardUpdate`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.arraydict import ArrayDict

__all__ = ["ActorCriticLossMixin", "HardUpdate", "LossModule", "SoftUpdate",
           "bootstrap_discount", "hold_out", "masked_mean"]


def bootstrap_discount(batch: ArrayDict, gamma: float):
    """``gamma ** steps_to_next_obs`` when the batch carries n-step-folded
    transitions, else ``gamma``."""
    if "steps_to_next_obs" in batch:
        return torch.pow(gamma, batch["steps_to_next_obs"].to(torch.float32))
    return gamma


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over the valid elements (``mask`` broadcast from the batch dims
    over ``x``'s trailing dims; bool or float 0/1)."""
    if mask is None:
        return torch.mean(x)
    m = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))
    m = torch.broadcast_to(m, x.shape).to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


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

    def commit_state(self, metrics: ArrayDict, ok: torch.Tensor | None = None) -> ArrayDict:
        """Write the running state that :meth:`forward` computed and
        returned in ``metrics`` (CrossQ's batch-norm statistics) into the
        loss's buffers where ``ok`` (a 0-dim bool tensor) holds; returns
        the metrics without it. A loss with no such state returns them
        unchanged."""
        return metrics

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


class HardUpdate:
    """Periodic hard copy of the sources into the targets: at an update
    ``step`` that is a multiple of ``value_network_update_interval``.
    ``step`` may be an int or a device tensor; the copy is a ``where``,
    so a device step is never read on the host. With ``ok`` (a 0-dim bool
    tensor) the copy happens only where it also holds."""

    def __init__(self, loss: LossModule, value_network_update_interval: int = 1000):
        self.loss = loss
        self.period = value_network_update_interval

    @torch.no_grad()
    def __call__(self, step, ok: torch.Tensor | None = None) -> None:
        do = step % self.period == 0
        for src, tgt in self.loss.target_pairs():
            take = torch.as_tensor(do, device=tgt.device)
            if ok is not None:
                take = take & ok
            tgt.copy_(torch.where(take, src, tgt))


class ActorCriticLossMixin(LossModule):
    """Shared machinery of the actor-critic losses: children ``actor`` and
    ``critic``, a default GAE estimator, the advantage filled in when the
    batch lacks one, the critic's value, and the mask.

    The mask is ``batch[mask_key]`` (default ``"mask"``, what ``rollout``
    writes with ``break_when_any_done``) and-ed with
    ``"collected_mask"`` where the batch has it (a host collector's
    padded tail)."""

    mask_key: str | None = "mask"

    def make_value_estimator(self, gamma: float = 0.99, lmbda: float = 0.95, **kw):
        from .value import GAE

        self.value_estimator = GAE(lambda td: self.critic(td), gamma=gamma, lmbda=lmbda, **kw)
        return self

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build the actor, then the critic, for ``td``'s widths."""
        self.actor.init(td, generator)
        self.critic.init(td, generator)
        return self

    def _mask(self, batch: ArrayDict):
        mask = batch[self.mask_key] if self.mask_key and self.mask_key in batch else None
        if "collected_mask" in batch:
            cm = batch["collected_mask"]
            # logical_and: a float 0/1 mask is valid too
            mask = cm if mask is None else torch.logical_and(mask, cm)
        return mask

    def _ensure_advantage(self, batch: ArrayDict) -> ArrayDict:
        """``batch`` with "advantage" (and the value target), computed by
        the value estimator when absent."""
        if "advantage" not in batch:
            if getattr(self, "value_estimator", None) is None:
                self.make_value_estimator()
            batch = self.value_estimator(batch)
        return batch

    def _value(self, batch: ArrayDict) -> torch.Tensor:
        from .value import _squeeze_value

        return _squeeze_value(self.critic(batch)["state_value"])


