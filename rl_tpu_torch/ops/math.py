"""Clamped tanh/atanh with the reference's gradients (counterpart of
:mod:`rl_tpu.ops.math`).

``safetanh(x) = clamp(tanh(x), -(1-eps), 1-eps)`` and ``safeatanh(y) =
atanh(clamp(y, -(1-eps), 1-eps))``. Autograd through a plain ``clamp``
would give a zero gradient wherever the clamp binds, so a saturated
action would stop teaching the actor. Like the reference's
``custom_jvp`` pair, the gradients here are those of the unclamped
function at the clamped value: ``(1 - yc^2)`` for tanh and
``1 / (1 - yc^2)`` for atanh.
"""

from __future__ import annotations

import torch

__all__ = ["safetanh", "safeatanh"]


class _SafeTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        lim = 1.0 - eps
        yc = torch.clamp(torch.tanh(x), -lim, lim)
        ctx.save_for_backward(yc)
        return yc

    @staticmethod
    def backward(ctx, g):
        (yc,) = ctx.saved_tensors
        return (1.0 - yc * yc) * g, None


class _SafeAtanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, eps):
        lim = 1.0 - eps
        yc = torch.clamp(y, -lim, lim)
        ctx.save_for_backward(yc)
        return torch.atanh(yc)

    @staticmethod
    def backward(ctx, g):
        (yc,) = ctx.saved_tensors
        return g / (1.0 - yc * yc), None


def safetanh(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _SafeTanh.apply(x, eps)


def safeatanh(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _SafeAtanh.apply(y, eps)
