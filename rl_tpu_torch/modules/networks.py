"""Network builders (counterpart of :mod:`rl_tpu.modules.networks`; ``MLP``,
``ConcatMLP``, ``NormalParamExtractor`` and the critic ensemble are
ported).

Like flax's ``Dense``, a layer learns its input width from the first
input it is built for: :meth:`MLP.build` (called by ``TDModule.init``)
makes the ``nn.Linear`` layers once the width is known, with flax's
initialisation: lecun-normal kernels (a normal truncated at two standard
deviations, scaled to variance 1/fan_in) and zero biases. The same
distribution as the reference, not the same bits.

:func:`init_ensemble` stacks ``n`` independently initialised copies of an
MLP's layers on a leading axis, and :func:`apply_ensemble` applies all of
them in one batched product per layer (``torch.baddbmm``), the
counterpart of the reference's ``jax.vmap`` over stacked params.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._stubs import not_ported

__all__ = ["MLP", "ConcatMLP", "NormalParamExtractor", "Ensemble", "init_ensemble",
           "apply_ensemble", "lecun_normal_"]

# flax's truncated-normal variance correction: the std of a standard normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def _activation(name_or_fn):
    return name_or_fn if callable(name_or_fn) else _ACTIVATIONS[name_or_fn]


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """flax's ``lecun_normal``: truncated normal in [-2, 2] standard
    deviations, scaled to variance ``1 / fan_in``."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _linear(fan_in: int, fan_out: int, generator, device) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out, device=device)
    lecun_normal_(layer.weight, fan_in, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """``num_cells`` hidden widths with ``activation`` (default tanh),
    then a linear layer to ``out_features`` (activated too if
    ``activate_last_layer``). Built at the first :meth:`build`."""

    def __init__(self, out_features: int, num_cells: Sequence[int] = (64, 64),
                 activation: Any = "tanh", activate_last_layer: bool = False,
                 layer_norm: bool = False):
        super().__init__()
        if layer_norm:
            raise NotImplementedError("MLP(layer_norm=True) is not ported yet (ROADMAP A7)")
        self.out_features = out_features
        self.num_cells = tuple(num_cells)
        self.activation = activation
        self.activate_last_layer = activate_last_layer
        self.layers = nn.ModuleList()

    @property
    def widths(self) -> tuple[int, ...]:
        return self.num_cells + (self.out_features,)

    def build(self, in_features: int, generator: torch.Generator | None = None, device=None):
        """Make (or re-make) the layers for inputs of width ``in_features``."""
        dims = (in_features,) + self.widths
        self.layers = nn.ModuleList(
            _linear(a, b, generator, device) for a, b in zip(dims[:-1], dims[1:]))
        return self

    def forward(self, x):
        if not len(self.layers):
            raise RuntimeError("MLP is not built: call build(in_features) (TDModule.init does)")
        act = _activation(self.activation)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.activate_last_layer:
                x = act(x)
        return x


class ConcatMLP(nn.Module):
    """An MLP over the concatenation of its inputs (default relu): the
    Q(s, a) critic body."""

    def __init__(self, out_features: int, num_cells: Sequence[int] = (256, 256),
                 activation: Any = "relu"):
        super().__init__()
        self.mlp = MLP(out_features, num_cells, activation)

    def build(self, in_features: int, generator=None, device=None):
        self.mlp.build(in_features, generator, device)
        return self

    def forward(self, *xs):
        return self.mlp(torch.cat(xs, dim=-1))


class NormalParamExtractor(nn.Module):
    """Split the last axis into (loc, scale) with ``scale =
    softplus(raw + 0.54132485) + scale_lb`` (softplus(0.5413) ~ 1).
    Softplus is written as the reference's ``logaddexp(x, 0)``."""

    def __init__(self, scale_lb: float = 1e-4):
        super().__init__()
        self.scale_lb = scale_lb

    def forward(self, x):
        loc, raw = torch.chunk(x, 2, dim=-1)
        z = raw + 0.54132485
        softplus = torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-z.abs()))
        return loc, softplus + self.scale_lb


class Ensemble(nn.Module):
    """``n`` copies of an MLP's layers, stacked: ``weights[i]`` is
    ``[n, out, in]`` and ``biases[i]`` ``[n, out]``. Inputs are
    concatenated on the last axis (as :class:`ConcatMLP` does)."""

    def __init__(self, mlp: MLP, n: int, in_features: int, generator=None, device=None):
        super().__init__()
        self.n = n
        self.from_concat = False
        self.activation = mlp.activation
        self.activate_last_layer = mlp.activate_last_layer
        dims = (in_features,) + mlp.widths
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty((n, b, a), device=device)
            for k in range(n):
                lecun_normal_(w[k], a, generator)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros((n, b), device=device)))

    def forward(self, *inputs, held_out: bool = False):
        """``[n, *batch, out]``; ``held_out`` stops gradients into the
        weights (the reference's ``hold_out`` of the params) while they
        still flow into the inputs."""
        x = torch.cat(inputs, dim=-1)
        batch = x.shape[:-1]
        # materialised: a stride-0 batch sends the CPU's bmm down a slow path
        x = x.reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1).contiguous()
        act = _activation(self.activation)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            if held_out:
                w, b = w.detach(), b.detach()
            x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
            if i < last or self.activate_last_layer:
                x = act(x)
        return x.reshape((self.n,) + batch + (x.shape[-1],))


def _inner_mlp(module) -> MLP:
    if isinstance(module, ConcatMLP):
        return module.mlp
    if isinstance(module, MLP):
        return module
    raise TypeError(f"init_ensemble stacks MLP or ConcatMLP layers, got {type(module).__name__}")


def init_ensemble(module, n: int, *example_inputs, generator=None) -> Ensemble:
    """``n`` independently initialised copies of ``module`` (an MLP or a
    ConcatMLP) for inputs shaped like ``example_inputs``, stacked."""
    in_features = sum(x.shape[-1] for x in example_inputs)
    ens = Ensemble(_inner_mlp(module), n, in_features, generator, example_inputs[0].device)
    ens.from_concat = isinstance(module, ConcatMLP)  # the flax layout nests an MLP_0
    return ens


def apply_ensemble(ensemble: Ensemble, *inputs, held_out: bool = False):
    """Every stacked copy on the same inputs: output's leading axis is n."""
    return ensemble(*inputs, held_out=held_out)


_ROADMAP = "A7: the remaining modules"
ConvNet = not_ported("ConvNet", __name__, _ROADMAP)
DuelingMLP = not_ported("DuelingMLP", __name__, _ROADMAP)
NoisyDense = not_ported("NoisyDense", __name__, _ROADMAP)
GSDEModule = not_ported("GSDEModule", __name__, _ROADMAP)
ConsistentDropout = not_ported("ConsistentDropout", __name__, _ROADMAP)
TanhPolicy = not_ported("TanhPolicy", __name__, _ROADMAP)
