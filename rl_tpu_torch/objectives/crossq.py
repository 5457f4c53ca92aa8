"""CrossQ: SAC with batch-normalised critics and no target networks
(counterpart of :mod:`rl_tpu.objectives.crossq`; ``BatchNormMLP`` and
``CrossQLoss`` are ported).

The CrossQ trick: Q(s, a) and Q(s', a') come from one forward over the
joint batch ``[current; next]``, so both halves are normalised with the
same batch statistics and no target network is needed.

:class:`BatchNormMLP` is written with plain ops on explicit buffers,
because ``nn.BatchNorm1d`` differs from the reference's flax layer in
every detail that matters here. It follows flax 0.12's ``BatchNorm``: the
running statistics move as ``ra = momentum * ra + (1 - momentum) *
batch`` with ``momentum`` 0.99; the batch variance is the biased
``max(E[x^2] - E[x]^2, 0)`` (``use_fast_variance``), in the running
statistic too; eps is 1e-5; and ``y = (x - mean) * (rsqrt(var + eps) *
scale) + bias``.

The running statistics are state, not parameters. :meth:`CrossQLoss.forward`
leaves them alone and returns the updated ones in
``metrics["batch_stats"]`` (the reference's layout: ``{"BatchNorm_i":
{"mean", "var"}}``, each ``[n, width]``); :meth:`CrossQLoss.commit_state`
writes them into the critic's buffers where a step was finite, which
``OffPolicyProgram`` does after every update. (The reference's program
drops them, so its running statistics never move.)
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from ..data.arraydict import ArrayDict
from ..modules.networks import _activation, lecun_normal_
from .common import LossModule, bootstrap_discount

__all__ = ["BatchNormMLP", "CrossQLoss"]


class BatchNormMLP(nn.Module):
    """``n`` stacked copies of the CrossQ critic body: BatchNorm on the
    concatenated input, then for each hidden width a linear layer,
    BatchNorm and the activation, then the output layer. Built by
    :meth:`build`: ``weights[j]`` ``[n, out, in]`` and ``biases[j]``
    (lecun-normal kernels, zero biases, as flax's ``Dense``);
    ``bn_scales[i]``, ``bn_biases[i]`` ``[n, width]`` (ones, zeros); the
    buffers ``mean_i`` and ``var_i`` (zeros, ones)."""

    def __init__(self, out_features: int = 1, num_cells: Sequence[int] = (256, 256),
                 activation: Any = "relu", momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.out_features = out_features
        self.num_cells = tuple(num_cells)
        self.activation = activation
        self.momentum = momentum
        self.eps = eps
        self.n = 0
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.bn_scales = nn.ParameterList()
        self.bn_biases = nn.ParameterList()

    @torch.no_grad()
    def build(self, in_features: int, n: int = 1, generator=None, device=None):
        """Make (or re-make) ``n`` members for inputs of width ``in_features``."""
        self.n = n
        dims = (in_features,) + self.num_cells + (self.out_features,)
        self.weights, self.biases = nn.ParameterList(), nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty((n, b, a), device=device)
            for k in range(n):
                lecun_normal_(w[k], a, generator)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros((n, b), device=device)))
        widths = dims[:-1]
        self.bn_scales = nn.ParameterList(nn.Parameter(torch.ones((n, w), device=device))
                                          for w in widths)
        self.bn_biases = nn.ParameterList(nn.Parameter(torch.zeros((n, w), device=device))
                                          for w in widths)
        for i, w in enumerate(widths):
            self.register_buffer(f"mean_{i}", torch.zeros((n, w), device=device))
            self.register_buffer(f"var_{i}", torch.ones((n, w), device=device))
        return self

    def running_stats(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``(mean_i, var_i)`` buffers, one pair for each BatchNorm."""
        return [(getattr(self, f"mean_{i}"), getattr(self, f"var_{i}"))
                for i in range(len(self.bn_scales))]

    def _norm(self, i: int, x, train: bool, held_out: bool):
        scale, bias = self.bn_scales[i], self.bn_biases[i]
        if held_out:
            scale, bias = scale.detach(), bias.detach()
        ra_mean, ra_var = getattr(self, f"mean_{i}"), getattr(self, f"var_{i}")
        if train:
            mean = x.mean(dim=1)
            var = torch.clamp_min((x * x).mean(dim=1) - mean * mean, 0.0)
            m = self.momentum
            stats = ((m * ra_mean + (1.0 - m) * mean).detach(),
                     (m * ra_var + (1.0 - m) * var).detach())
        else:
            mean, var, stats = ra_mean, ra_var, None
        mul = torch.rsqrt(var + self.eps) * scale
        return (x - mean[:, None]) * mul[:, None] + bias[:, None], stats

    def forward(self, *xs, train: bool = True, held_out: bool = False):
        """``(q [n, batch, out_features], stats)``. ``train`` normalises with
        the batch's statistics and returns the updated running ones
        (``[(mean, var)]`` for each BatchNorm); otherwise the running ones
        are used and ``stats`` is None. ``held_out`` stops gradients into
        the parameters (they still flow into the inputs)."""
        if not self.n:
            raise RuntimeError("BatchNormMLP is not built: call build(in_features, n)")
        x = torch.cat(xs, dim=-1)
        batch = x.shape[:-1]
        x = x.reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1).contiguous()
        act = _activation(self.activation)
        new_stats = []
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            if i < len(self.bn_scales):
                x, st = self._norm(i, x, train, held_out)
                new_stats.append(st)
                if i > 0:
                    x = act(x)
            if held_out:
                w, b = w.detach(), b.detach()
            x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
        return x.reshape((self.n,) + batch + (x.shape[-1],)), (new_stats if train else None)


class CrossQLoss(LossModule):
    """SAC-style objective over joint-BatchNorm critics, no target networks.

    Children after ``init_params``: ``actor``, ``qvalue`` (a
    :class:`BatchNormMLP` of ``num_qvalue_nets`` members) and
    ``log_alpha``. The critics are trained in train mode on the joint
    batch; the actor is scored against them in eval mode (the running
    statistics, no gradient into the critics). ``noise=(eps_next,
    eps_pi)`` replaces the two standard-normal draws, as ``SACLoss``'s.
    """

    target_keys = ()

    def __init__(self, actor, num_qvalue_nets: int = 2, num_cells: Sequence[int] = (256, 256),
                 gamma: float = 0.99, target_entropy: float | str = "auto",
                 alpha_init: float = 1.0):
        super().__init__()
        self.actor = actor
        self.qvalue = BatchNormMLP(out_features=1, num_cells=num_cells)
        self.num_qvalue_nets = num_qvalue_nets
        self.gamma = gamma
        self._target_entropy = target_entropy
        self.alpha_init = alpha_init
        self._action_dim = None
        self.log_alpha = None

    def target_entropy(self, action_dim: int | None = None) -> float:
        if self._target_entropy == "auto":
            dim = action_dim if action_dim is not None else self._action_dim
            if dim is None:
                raise ValueError("target_entropy='auto' needs the action dim; call "
                                 "init_params or pass action_dim")
            return -float(dim)
        return float(self._target_entropy)

    @torch.no_grad()
    def init_params(self, td: ArrayDict, generator: torch.Generator | None = None):
        """Build the actor for ``td``, the critics for its observation and
        the actor's mode action, and ``log_alpha = log(alpha_init)``."""
        self.actor.init(td, generator)
        dist, _ = self.actor.get_dist(td)
        action = dist.mode
        self._action_dim = action.shape[-1]
        self.qvalue.build(td["observation"].shape[-1] + action.shape[-1],
                          self.num_qvalue_nets, generator, action.device)
        self.log_alpha = nn.Parameter(torch.tensor(
            math.log(self.alpha_init), dtype=torch.float32, device=action.device))
        return self

    def forward(self, batch: ArrayDict, generator=None, noise=None):
        if noise is None and generator is None:
            raise ValueError("CrossQLoss needs a torch.Generator or the noise")
        eps_next, eps_pi = noise if noise is not None else (None, None)
        alpha = torch.exp(self.log_alpha.detach())

        with torch.no_grad():
            next_dist, _ = self.actor.get_dist(batch["next"])
            next_a = next_dist.sample(generator, eps=eps_next)
            next_lp = next_dist.log_prob(next_a)
        obs = batch["observation"]
        q, stats = self.qvalue(torch.cat([obs, batch["next", "observation"]], dim=0),
                               torch.cat([batch["action"], next_a], dim=0), train=True)
        q_cur, q_next = q[:, : obs.shape[0], 0], q[:, obs.shape[0]:, 0]
        with torch.no_grad():
            next_v = torch.min(q_next, dim=0).values - alpha * next_lp
            not_term = 1.0 - batch["next", "terminated"].to(torch.float32)
            target = (batch["next", "reward"]
                      + bootstrap_discount(batch, self.gamma) * not_term * next_v)
        td_error = q_cur - target[None]
        loss_qvalue = 0.5 * torch.mean(torch.sum(td_error**2, dim=0))

        dist, _ = self.actor.get_dist(batch)
        a_pi = dist.rsample(generator, eps=eps_pi)
        lp_pi = dist.log_prob(a_pi)
        q_pi, _ = self.qvalue(obs, a_pi, train=False, held_out=True)
        loss_actor = torch.mean(alpha * lp_pi - torch.min(q_pi[..., 0], dim=0).values)

        t_ent = self.target_entropy(batch["action"].shape[-1])
        loss_alpha = -self.log_alpha * torch.mean((lp_pi + t_ent).detach())
        total = loss_qvalue + loss_actor + loss_alpha
        batch_stats = ArrayDict({f"BatchNorm_{i}": ArrayDict(mean=m, var=v)
                                 for i, (m, v) in enumerate(stats)})
        return total, ArrayDict(loss_qvalue=loss_qvalue.detach(), loss_actor=loss_actor.detach(),
                                loss_alpha=loss_alpha.detach(), alpha=alpha,
                                batch_stats=batch_stats)

    @torch.no_grad()
    def commit_state(self, metrics: ArrayDict, ok: torch.Tensor | None = None) -> ArrayDict:
        """Write ``metrics["batch_stats"]`` into the critic's running
        statistics where ``ok`` holds (everywhere without it), in place;
        returns the metrics without them."""
        for i, (mean, var) in enumerate(self.qvalue.running_stats()):
            for buf, key in ((mean, "mean"), (var, "var")):
                new = metrics["batch_stats", f"BatchNorm_{i}", key]
                buf.copy_(new if ok is None else torch.where(ok, new, buf))
        return metrics.exclude("batch_stats")
