"""Replay samplers (counterpart of :mod:`rl_tpu.data.replay.samplers`;
``Sampler``, ``RandomSampler`` and ``PrioritizedSampler`` are ported).

``PrioritizedSampler`` keeps the reference's flat two-level sum-tree on
the device: ``priorities`` holds ``(|p| + eps)^alpha`` for every slot
(padded to a multiple of the fanout ``F``) and ``esum`` the sum of each
block of ``F`` leaves. Sampling is stratified inverse-CDF descent (a
block ``cumsum`` and ``searchsorted``, then one ``[B, F]`` row gather);
priority write-back is a delta update of both levels through kernel B7
(:func:`rl_tpu_torch.kernels.sumtree.sumtree_update`), in place. Nothing
is read back to the host.

``sample`` takes ``u``, the batch's uniform draws in [0, 1), in place of
drawing them from its generator, so a test can feed both packages the
same draws.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..._stubs import not_ported
from ...kernels.sumtree import sumtree_update
from ..arraydict import ArrayDict

__all__ = ["Sampler", "RandomSampler", "PrioritizedSampler"]


class Sampler:
    """``init(capacity, device)`` builds the state; ``sample`` returns
    ``(indices, info, new_state)``; hooks for writes and priorities."""

    def init(self, capacity: int, device=None) -> ArrayDict:
        return ArrayDict()

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        raise NotImplementedError

    def on_write(self, sstate, idx, items):
        return sstate

    def update_priority(self, sstate, idx, priority, ok=None):
        return sstate


class RandomSampler(Sampler):
    """Uniform with replacement over the filled slots."""

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=size.device)
        n = torch.clamp_min(size, 1)
        idx = torch.minimum((u * n).to(torch.int64), n - 1)  # floor(u * n), no host read of n
        return idx, ArrayDict(), sstate


class PrioritizedSampler(Sampler):
    """Proportional PER: ``P(i) ~ p_i^alpha``, importance weights ``(N
    P(i))^-beta`` normalised by the batch's largest."""

    def __init__(self, alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-8,
                 beta_annealing_steps: int | None = None, fanout: int = 16):
        if beta_annealing_steps is not None:
            raise NotImplementedError(
                "PrioritizedSampler(beta_annealing_steps=...) is not ported yet "
                "(ROADMAP A6: beta annealing)")
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        self.fanout = fanout

    def _layout(self, capacity: int) -> tuple[int, int]:
        """(num_blocks, padded_len); pad slots keep zero mass forever."""
        n_blocks = max(1, -(-capacity // self.fanout))
        return n_blocks, n_blocks * self.fanout

    def init(self, capacity: int, device=None) -> ArrayDict:
        n_blocks, padded = self._layout(capacity)
        return ArrayDict(
            priorities=torch.zeros(padded, dtype=torch.float32, device=device),
            esum=torch.zeros(n_blocks, dtype=torch.float32, device=device),
            max_priority=torch.ones((), dtype=torch.float32, device=device),
            step=torch.zeros((), dtype=torch.int64, device=device),
        )

    def _pa(self, priority):
        return torch.pow(priority.to(torch.float32).abs().reshape(-1) + self.eps, self.alpha)

    def _delta_update(self, sstate, idx, pa_new, *, indices_sorted, ok=None):
        """Set the leaves at ``idx`` to ``pa_new`` by delta adds on both
        levels (kernel B7, in place). Duplicate indices collapse to the
        last writer: with sorted indices a neighbour compare marks it,
        otherwise a scatter-max of positions. ``ok`` zeroes every delta
        where it is false (``x + 0.0 == x`` for the non-negative leaves)."""
        idx = idx.reshape(-1)
        b = idx.shape[0]
        leaves = sstate["priorities"]
        if b > 1:
            if indices_sorted:
                last = torch.cat([idx[:-1] != idx[1:],
                                  torch.ones(1, dtype=torch.bool, device=idx.device)])
            else:
                pos = torch.arange(1, b + 1, device=idx.device)
                win = torch.zeros(leaves.shape[0], dtype=pos.dtype, device=idx.device)
                win.scatter_reduce_(0, idx, pos, "amax")
                last = win[idx] == pos
            delta = torch.where(last, pa_new - leaves[idx], 0.0)
        else:
            delta = pa_new - leaves[idx]
        if ok is not None:
            delta = torch.where(ok, delta, 0.0)
        sumtree_update(leaves, sstate["esum"], idx, delta, fanout=self.fanout)
        return sstate

    def sample(self, sstate, generator, batch_size, size, capacity, u=None):
        F = self.fanout
        n_blocks, _ = self._layout(capacity)
        esum = sstate["esum"]
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=esum.device)
        # prefix sums accumulated in float64 and rounded to float32: what
        # torch's CPU cumsum does, so the card (whose float32 scan rounds
        # along another tree) picks the same blocks as the CPU
        block_csum = torch.cumsum(esum.double(), 0).float()
        total = block_csum[-1]
        # stratified: one draw per equal slice of the mass; the indices come
        # out ascending, which the sorted dedup of the write-back relies on
        u = (torch.arange(batch_size, device=esum.device) + u) / batch_size * total
        block = torch.clamp(torch.searchsorted(block_csum, u, right=True), 0, n_blocks - 1)
        prev = block_csum[torch.clamp_min(block - 1, 0)]
        r = u - torch.where(block > 0, prev, 0.0)
        rows = sstate["priorities"].view(n_blocks, F)[block]  # [B, F]
        csum = torch.cumsum(rows.double(), -1).float()
        # keep the residual inside the block: the running esum and the row's
        # fresh cumsum may disagree in the last ulps, and a residual past the
        # row's total would step into zero-mass trailing leaves
        r = torch.minimum(r, csum[:, -1] * (1.0 - 1e-6))
        col = torch.clamp((csum <= r[:, None]).sum(-1), 0, F - 1)
        idx = torch.clamp(block * F + col, 0, capacity - 1)

        n = torch.clamp_min(size.to(torch.float32), 1.0)
        total_c = torch.clamp_min(total, 1e-12)
        p_alpha = torch.gather(rows, 1, col[:, None])[:, 0]
        weights = torch.pow(n * torch.clamp_min(p_alpha / total_c, 1e-12), -self.beta)
        weights = weights / torch.clamp_min(weights.max(), 1e-12)
        info = ArrayDict(_weight=weights, index=idx)
        return idx, info, sstate.set("step", sstate["step"] + 1)

    def on_write(self, sstate, idx, items):
        """New items get the max priority; then every block sum is rebuilt
        from its leaves (which also clears the delta path's drift)."""
        pa = torch.pow(sstate["max_priority"], self.alpha)
        leaves = sstate["priorities"]
        leaves[idx.reshape(-1)] = pa
        sstate["esum"].copy_(leaves.view(-1, self.fanout).sum(-1))
        return sstate

    def update_priority(self, sstate, idx, priority, *, indices_sorted=False, ok=None):
        """Write back ``priority`` for ``idx``. With ``ok`` (a 0-dim bool
        tensor) a false ``ok`` leaves the tree and ``max_priority``
        untouched, decided on the device: the in-place counterpart of the
        reference's ``tree_where(ok, new, old)`` over the sampler state."""
        priority = priority.to(torch.float32).abs().reshape(-1)
        sstate = self._delta_update(sstate, idx, self._pa(priority),
                                    indices_sorted=indices_sorted, ok=ok)
        max_p = torch.maximum(sstate["max_priority"], priority.max() + self.eps)
        if ok is not None:
            max_p = torch.where(ok, max_p, sstate["max_priority"])
        return sstate.set("max_priority", max_p)

    def sample_and_update(self, sstate, generator, batch_size, size, capacity,
                          priority_fn: Callable, u=None):
        """One PER cycle: sample, ``priority_fn(idx, info) -> [B]``, write
        back (the stratified indices are ascending: the sorted dedup)."""
        idx, info, sstate = self.sample(sstate, generator, batch_size, size, capacity, u=u)
        sstate = self.update_priority(sstate, idx, priority_fn(idx, info), indices_sorted=True)
        return idx, info, sstate

    def jit_sample_and_update(self, *args, **kwargs):
        raise NotImplementedError(
            "PrioritizedSampler.jit_sample_and_update (the program registry) is not ported "
            "yet (ROADMAP A7: compile/)")


_ROADMAP = "A6/A7: the other samplers"
SamplerWithoutReplacement = not_ported("SamplerWithoutReplacement", __name__, _ROADMAP)
StalenessAwareSampler = not_ported("StalenessAwareSampler", __name__, _ROADMAP)
SliceSampler = not_ported("SliceSampler", __name__, _ROADMAP)
SliceSamplerWithoutReplacement = not_ported("SliceSamplerWithoutReplacement", __name__, _ROADMAP)
PrioritizedSliceSampler = not_ported("PrioritizedSliceSampler", __name__, _ROADMAP)
